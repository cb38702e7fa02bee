"""Batched integer serving engine over a paged or contiguous KV cache
(the port of ``repro.serving.engine.ServingEngine`` for dense decoders,
full-causal or sliding-window, mixtures of experts and state-space
models).

A continuous-batching scheduler: requests are admitted into fixed batch
*lanes*, prompts prefill into the KV cache, every step decodes one token
for every lane whose prompt is in, and finished lanes retire.

  * **Cache layouts** (``cache_mode``): ``"paged"`` (default), a
    physical page pool addressed through a per-lane page table, whose
    pages belong to sessions; ``"contiguous"``, one slab of ``L``
    positions per lane.  A sliding window bounds ``L`` to
    ``min(cache_len, window)`` and writes position ``pos`` at the
    rolling slot ``pos % window``, in both layouts.
  * **Chunked prefill** (default on paged, full-causal archs): prompts
    advance ``prefill_chunk`` tokens at a time through one batched
    ``inttransformer.int_prefill_chunk_step`` (K4 on the ``cuda``
    backend), writing K/V straight into physical pages through the page
    table; ``prefill_budget`` caps prompt tokens per engine step so
    decoding lanes keep emitting a token every step.
  * **Token-streaming prefill** (``prefill_chunk=0``, and always for a
    sliding window or the contiguous layout): prompt tokens one at a time
    through the decode step.
  * **Decode**: one ``inttransformer.int_decode_step`` per engine step
    (K3 with the o-projection folded in when ``fold_wo``).
  * **Prefix sharing** (``prefix_cache``, chunkable paged engines): a
    prompt whose prefix was prefilled before maps the same physical
    pages (allocator refcounts); the first write into a shared page
    copies it (copy-on-write).
  * ``evict`` frees a session's lane and pages; ``preempt`` (paged only)
    frees the lane but keeps the pages, and the session resumes
    bit-exactly.
  * **int4 KV pages** (``kv_dtype="int4"``, paged only): pools of two
    head-dim nibbles a byte with a shift per page (``ops.packed``); an
    auto-sized pool has twice the pages in the same bytes, and K3 / K4
    expand the pages inside the kernel.
  * **Speculative decoding** (``spec_k``, full-causal archs): each step
    drafts up to ``spec_k`` tokens a live lane (``serving.speculate``,
    prompt lookup over the lane's own context) and verifies all ``spec_k
    + 1`` positions in one ``inttransformer.int_verify_step`` (K3 at Sq =
    spec_k + 1, the stepped mask).  Greedy acceptance commits the longest
    draft prefix matching the argmax stream plus one bonus token;
    rejected drafts roll back by ``PagedKVCache.truncate``.  Streams equal
    ``spec_k = 0``'s.  Greedy requests only.
  * **Dispatch / commit**: ``step()`` is ``commit_step(dispatch_step())``.
    ``dispatch_step`` schedules and queues the step on the device without
    waiting for it: its host inputs (tokens, positions, the page table)
    are snapshots, copied without blocking from fresh pinned host memory
    into device buffers allocated once at construction (fixed addresses).
    ``commit_step`` is where the host waits, on the logits.  Between the
    two, ``evict`` / ``preempt`` / another dispatch raise
    :class:`StepInFlight`.

  * **Mixtures of experts** (qwen2-moe-a2.7b, qwen3-moe-235b-a22b):
    token-streaming prefill only, as in the reference (capacity routing
    drops tokens per group, so a chunk would route otherwise), hence no
    prefix sharing; every decode and verify step routes each row alone
    (``group_size=1``), and the experts run as one grouped K1 launch a
    linear.
  * **Tensor parallelism** (``tp``): with a ``torch.distributed`` group
    of exactly ``tp`` ranks (the default group, or ``group=``) and every
    backend advertising ``tp_serving``, each rank (one process, SPMD)
    builds the engine from the same full parameters and keeps its shard
    (``distributed.tp_serving``): ``Hkv/tp`` KV heads of every page and
    the matching ``H/tp`` query heads; ``wo``'s int32 partials are summed
    over the group before its one requant, so ``fold_wo`` is forced off.
    Embedding, norms, FFN / MoE, logits, the scheduler, the allocator,
    the page table and the prefix index are replicated, and every rank
    makes the same decisions (a rank must drive the same calls in the
    same order as the others: a rank that skips a step stalls the
    group).  Otherwise a ``tp > 1`` engine serves through the exact
    single-device lowering (``describe()["tp"]["mode"] == "gathered"``).
    Either way the streams equal ``tp = 1``'s.  SSM and cross attention
    archs are refused (``ValueError``), as are packed attention weights
    when sharding.
  * **State-space models** (mamba2-130m, jamba-v0.1-52b): each Mamba
    sublayer keeps its int32 SSD state and int8 conv tail a lane, in
    either cache mode.  Token-streaming prefill only, hence no prefix
    sharing, no speculation and no ``preempt`` (the state is
    lane-indexed).  Every decode step advances every lane's state,
    an idle lane's by token 0, as the reference's does; a recycled lane's
    state is zeroed at admission, which queues behind any step already
    on the device.

Token streams are bit-identical to the JAX engine's for the same
weights and schedule.  Refused on purpose (``ValueError``,
:func:`refuse_cross_attention`): the cross attention archs
(seamless-m4t-large-v2, llama-3.2-vision-90b), which the reference's
engine cannot serve; they run through ``int_prefill(return_cache=True)``
and ``int_decode_step``.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import contracts
from repro_torch.device import resolve_device
from repro_torch.distributed import tp_serving
from repro_torch.models import intlayers as il
from repro_torch.models import inttransformer as it
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import layer_group_spec
from repro_torch.ops import OP_NAMES, QuantLinearParams, resolve_ops
from repro_torch.quant import plans as qplans
from repro_torch.serving import speculate
from repro_torch.serving.kvcache import (NULL_PAGE, CacheLayout,
                                         PagePoolExhausted, PagedKVCache,
                                         PrefixIndex, Session)


def refuse_cross_attention(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for an arch with cross attention sublayers (an
    encoder-decoder, a VLM).  The reference's ``ServingEngine`` builds its
    caches without a memory and its first step fails with ``KeyError:
    'ck8'`` (ROADMAP §3), so it has no streams to hold this engine's
    against; the port refuses at construction instead."""
    _, _, kinds = layer_group_spec(cfg)
    if any(mix == "cross" or has_cross for mix, _, has_cross in kinds):
        raise ValueError(
            f"arch {cfg.name!r} has cross attention sublayers: the "
            "reference's ServingEngine builds its caches without the "
            "memory and fails at its first step (KeyError: 'ck8'; ROADMAP "
            "§3), so this engine refuses it; run it through "
            "inttransformer.int_prefill(return_cache=True) and "
            "int_decode_step (launch.steps)")


class StepInFlight(RuntimeError):
    """A lifecycle operation (``evict`` / ``preempt`` / another
    ``dispatch_step``) was attempted between :meth:`ServingEngine.
    dispatch_step` and :meth:`ServingEngine.commit_step`, or a step that
    is not the one in flight was committed.  The scheduler state the
    pending step will be committed against must not move underneath it:
    commit it first."""


class EngineStalled(RuntimeError):
    """``run_until_done`` exhausted its step budget with sessions still
    queued or on lanes.  Carries ``max_steps``, ``queue_depth`` and the
    per-lane ``slots`` dicts (uid / state / pos / prefill_pos)."""

    def __init__(self, max_steps: int, slots, queue_depth: int):
        self.max_steps = max_steps
        self.slots = slots
        self.queue_depth = queue_depth
        lanes = ", ".join(
            "lane %d: uid=%s %s pos=%s prefill_pos=%s" % (
                i, s["uid"], s["state"], s["pos"], s["prefill_pos"])
            for i, s in enumerate(slots) if s is not None) or "all idle"
        super().__init__(
            f"engine stalled: {max_steps} steps exhausted with "
            f"{queue_depth} queued session(s) and unfinished lanes "
            f"({lanes}); raise max_steps, relieve pool pressure, or "
            "evict a session")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class PendingStep:
    """An engine step that :meth:`ServingEngine.dispatch_step` queued on
    the device and :meth:`ServingEngine.commit_step` has not yet
    committed: ``logits`` is a device tensor ((B, V), or (B, S, V) for a
    verify step) that may still be computing.  ``kind`` is ``"idle"``
    (no lane was decoding), ``"decode"`` or ``"verify"``."""

    occupied: int
    kind: str
    live: List[int] = dataclasses.field(default_factory=list)
    sessions: List[Optional[Session]] = dataclasses.field(
        default_factory=list)
    logits: object = None
    n_new: Optional[np.ndarray] = None
    drafts: Optional[Dict[int, List[int]]] = None


def _weak_call(method):
    """A callable that runs the bound ``method`` while its object lives,
    without keeping the object alive (a no-op once it is gone)."""
    ref = weakref.WeakMethod(method)

    def call():
        fn = ref()
        if fn is not None:
            fn()
    return call


def _to_device(tree, dev):
    if isinstance(tree, QuantLinearParams):
        return tree.map(lambda t: t.to(dev))
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


class ServingEngine:
    def __init__(self, qparams, plans: qplans.LayerPlans, cfg: ArchConfig,
                 batch_size: int = 8, cache_len: int = 512, ops=None,
                 seed: int = 0, cache_mode: str = "paged",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_dtype: str = "int8", fold_wo: bool = True,
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = True, tp: int = 1, spec_k: int = 0,
                 spec_mode: str = "ngram", device="cuda", group=None):
        tp_serving.validate_tp(cfg, tp)
        if cache_mode not in ("paged", "contiguous"):
            raise ValueError("cache_mode must be 'paged' or 'contiguous',"
                             f" got {cache_mode!r}")
        if kv_dtype != "int8" and cache_mode != "paged":
            raise ValueError("kv_dtype='int4' needs cache_mode='paged' "
                             "(the packed tier stores per-page requant "
                             "shifts next to the page pools)")
        if not cfg.is_causal:
            raise ValueError(
                f"arch {cfg.name!r} is an encoder: it has no autoregressive "
                "serving; run it through launch.steps.make_prefill_step")
        refuse_cross_attention(cfg)
        _, _, kinds = layer_group_spec(cfg)
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1 token/step, "
                             f"got {prefill_budget}")
        speculate.validate_spec(cfg, spec_k, spec_mode)
        self.spec_k = spec_k
        self.spec_mode = spec_mode if spec_k else "off"
        self.proposer = speculate.get_proposer(spec_mode) if spec_k \
            else None
        self._spec_drafted = 0
        self._spec_accepted = 0
        self.device = resolve_device(device)
        self.cfg = cfg
        self.plans = plans
        self.batch = batch_size
        self.cache_len = cache_len
        self.fold_wo = fold_wo
        self.ops = resolve_ops(ops, cfg)
        self.tp = tp
        self.tp_group = self._negotiate_tp(group)
        self.tp_sharded = self.tp_group is not None
        # the steps' view of the arch: this rank's heads when sharded
        self.local_cfg = tp_serving.local_cfg(cfg, tp) if self.tp_sharded \
            else cfg
        if self.tp_sharded:
            # a folded epilogue would requant each rank's partial wo
            # product before the sum: the requant must round once
            self.fold_wo = False
            qparams = tp_serving.shard_qparams(
                qparams, dist.get_rank(self.tp_group), tp)
        self.qparams = _to_device(qparams, self.device)
        self.rng = np.random.default_rng(seed)
        # logical per-session cache length: the window bounds it
        self.L = min(cache_len, cfg.window) if cfg.window > 0 else cache_len
        self._has_ssm = any(mix == "ssm" for mix, _, _ in kinds)
        self.paged = cache_mode == "paged"
        if self.paged:
            self.layout = CacheLayout.fit(batch_size, self.L, page_size,
                                          num_pages, kv_dtype=kv_dtype)
            self.kv = PagedKVCache(self.layout)
            self.caches = it.init_decode_cache(self.local_cfg, self.layout,
                                               self.device)
        else:
            self.layout = None
            self.kv = None
            self.caches = it.init_decode_cache(
                self.local_cfg, device=self.device, batch=batch_size,
                cache_len=cache_len)
        self._chunkable = self.paged and it.chunked_prefill_supported(cfg)
        self.prefill_chunk = self._resolve_prefill_chunk(prefill_chunk)
        self._use_chunked = self.prefill_chunk > 0
        self.prefill_budget = prefill_budget
        # a chunk may start anywhere below the prompt end and run C past
        # it, so the RoPE table spans every position a chunk can touch
        # (the reference clamps its gather instead; positions past the
        # cache only ever write the null page or dead tail slots)
        logical = self.layout.logical_len if self.paged else self.L
        self.rope_tab = il.build_rope_table(
            max(cache_len, logical) + self.prefill_chunk + 1,
            cfg.hd, cfg.rope_theta, device=self.device) \
            if cfg.pos == "rope" else None
        if self._chunkable and prefix_cache:
            self.prefix: Optional[PrefixIndex] = PrefixIndex(
                self.kv.allocator, self.layout.page_size)
            # a weak reference: the allocator must not keep the engine
            # (and its device pools) alive until the cyclic collector runs
            self.kv.allocator.reclaim = _weak_call(self._reclaim_prefix)
        else:
            self.prefix = None
        self._cow_copies = 0
        self._check_launches()
        self.pos = np.zeros(batch_size, np.int32)
        self.slots: List[Optional[Session]] = [None] * batch_size
        self.queue: List[Session] = []
        self._finished: List[Request] = []
        self._uid = 0
        self._inflight: Optional[PendingStep] = None
        self._bufs = self._device_buffers()

    def _negotiate_tp(self, group):
        """The process group the engine shards over, or None (tp = 1, or
        the gathered mode): sharded when tp > 1, every backend advertises
        ``tp_serving`` and the group (``group``, else the default group)
        has exactly ``tp`` ranks.  A ``group`` passed with another size
        raises."""
        if self.tp == 1 or not tp_serving.backends_support_tp(self.ops):
            return None
        size = tp_serving.tp_group_size(group)
        if group is not None and size != self.tp:
            raise ValueError(f"tp={self.tp} but the process group passed "
                             f"has {size} ranks")
        if size != self.tp:
            return None
        return dist.group.WORLD if group is None else group

    def _check_launches(self):
        """The attention launches' contracts, checked at construction where
        a kernel will take them (a backend that consumes the KV layout
        natively, on the card): K3 at the verify step's Sq = spec_k + 1
        and, when sharded, at Sq = 1, and K4 for a sharded chunked
        prefill, each through :func:`~repro_torch.analysis.contracts.
        check_tp_launch` at the rank's heads (``tp`` 1 unless sharded) and
        ``require_launch``, which raises ``KernelContractError`` (a
        ``ValueError``: head dim, query rows, shared memory, head counts).
        The counterpart of the reference's ``_check_tp_launches``."""
        if self.device.type != "cuda":
            return
        cfg = self.cfg
        tp = self.tp if self.tp_sharded else 1
        heads = dict(h=cfg.n_heads, hkv=cfg.n_kv_heads, d=cfg.hd)
        int4 = self.paged and self.layout.kv_dtype == "int4"
        pool = dict(max_pages=self.layout.max_pages,
                    page_size=self.layout.page_size, kv_pack=int4,
                    num_pages=self.layout.num_pages) if self.paged else {}
        if getattr(self.ops.backend_for("int_decode_attention"),
                   "paged_decode", False):
            sqs = {1} if self.tp_sharded else set()
            if self.spec_k:
                sqs.add(self.spec_k + 1)
            for sq in sorted(sqs):
                contracts.require_launch(contracts.check_tp_launch(
                    "int_decode_attention", tp=tp, b=self.batch, sq=sq,
                    **heads, **(pool or dict(L=self.L))))
        if self.tp_sharded and self._use_chunked and getattr(
                self.ops.backend_for("int_paged_prefill"), "paged_prefill",
                False):
            contracts.require_launch(contracts.check_tp_launch(
                "int_paged_prefill", tp=tp, b=self.batch,
                c=self.prefill_chunk, **heads, **pool,
                k_addr=self.caches[0]["k8"].data_ptr()))

    def _device_buffers(self) -> Dict[str, torch.Tensor]:
        """The device tensors every step's host inputs are copied into,
        allocated once (their addresses never change): tokens and
        positions of the decode step, the page table, the prefill chunk's
        tokens, base positions and page-table view, and the verify step's
        (B, S) tokens, ``n_new`` and the flat indices of its real rows."""
        b = self.batch

        def i32(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)
        bufs = {"toks": i32(b), "pos": i32(b)}
        if self.paged:
            bufs["pages"] = i32(b, self.layout.max_pages)
        if self._use_chunked:
            bufs.update(chunk_toks=i32(b, self.prefill_chunk),
                        chunk_base=i32(b),
                        chunk_pages=i32(b, self.layout.max_pages))
        if self.spec_k:
            s = self.spec_k + 1
            bufs.update(verify_toks=i32(b, s), n_new=i32(b),
                        rows=torch.zeros(b * s, dtype=torch.int64,
                                         device=self.device))
        return bufs

    def _resolve_prefill_chunk(self, prefill_chunk: Optional[int]) -> int:
        """Validate/auto-size the prefill chunk: 0 streams, None picks
        ~32 page-compatible tokens where the engine can chunk (paged, a
        full-causal arch) and streams otherwise."""
        if prefill_chunk is None:
            if not self._chunkable:
                return 0
            ps = self.layout.page_size
            return min(ps * max(1, 32 // ps), self.layout.logical_len)
        if prefill_chunk == 0:
            return 0
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        if not self.paged:
            raise ValueError("prefill_chunk needs cache_mode='paged' "
                             "(chunked prefill writes K/V through the "
                             "page table)")
        if not self._chunkable:
            raise ValueError(
                "chunked prefill is unsupported for arch "
                f"{self.cfg.name!r}: it needs window == 0 and dense FFN "
                "sublayers (a sliding window, an MoE's capacity "
                "routing and a Mamba state keep token-streaming prefill); "
                "pass prefill_chunk=0")
        ps = self.layout.page_size
        if prefill_chunk % ps and ps % prefill_chunk:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must divide or be a "
                f"multiple of page_size={ps} so chunk writes tile "
                "physical pages")
        return min(prefill_chunk, self.layout.logical_len)

    # ------------------------------------------------------ device steps --

    def _stage(self, name: str, a: np.ndarray) -> torch.Tensor:
        """Copy host array ``a`` into the fixed device buffer ``name`` (its
        leading rows, for the variable-length ``rows``) and return that
        view.  On the card the copy never waits: ``a`` goes into a fresh
        pinned block (a snapshot, so the engine may mutate ``pos`` and the
        page table at once), which PyTorch's host allocator does not hand
        out again before the queued copy has read it."""
        buf = self._bufs[name]
        dst = buf[:a.shape[0]] if a.shape != tuple(buf.shape) else buf
        src = torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.int64 if buf.dtype == torch.int64 else np.int32))
        if dst.is_cuda:
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)
        return dst

    def _paged_args(self, name: str = "pages", view=None) -> dict:
        if not self.paged:
            return {}
        table = self.kv.page_table.snapshot() if view is None else view
        return dict(pages=self._stage(name, table),
                    page_size=self.layout.page_size)

    def _run_decode(self, toks):
        kw = self._paged_args()
        if self.paged:
            kw["max_len"] = self.L
        return it.int_decode_step(
            self.qparams, self.caches, self._stage("toks", toks),
            self._stage("pos", self.pos), self.plans, self.local_cfg,
            self.rope_tab, ops=self.ops, fold_wo=self.fold_wo,
            pos_span=(int(self.pos.min()), int(self.pos.max())),
            tp_group=self.tp_group, **kw)

    def _run_verify(self, toks, n_new):
        """One verify step over the lanes' right-aligned ``toks`` (B, S);
        every index it needs (the RoPE span, the real rows the contiguous
        layout writes) is built here on the host from ``n_new``."""
        s = self.spec_k + 1
        rpos = np.maximum(self.pos[:, None] + n_new[:, None] - s
                          + np.arange(s), 0)
        kw = self._paged_args()
        if self.paged:
            kw["max_len"] = self.L
        else:
            kw["write_rows"] = self._stage("rows", il.real_rows(n_new, s))
        return it.int_verify_step(
            self.qparams, self.caches, self._stage("verify_toks", toks),
            self._stage("pos", self.pos), self._stage("n_new", n_new),
            self.plans, self.local_cfg, self.rope_tab, ops=self.ops,
            fold_wo=self.fold_wo,
            pos_span=(int(rpos.min()), int(rpos.max())),
            tp_group=self.tp_group, **kw)

    # ------------------------------------------------------ scheduling ---

    def submit(self, req: Request) -> Session:
        """Queue a request; returns the Session that owns its cache pages.
        Impossible requests (prompt longer than the cache, prompt +
        max_new_tokens overrunning it) raise ``RequestInfeasible`` here;
        a ``temperature > 0`` request on a speculative engine raises
        ``SpeculationUnsupported``."""
        if self.spec_k and req.temperature > 0:
            raise speculate.SpeculationUnsupported(
                f"spec_k={self.spec_k} serves greedy requests only: "
                "acceptance keeps the longest draft prefix matching the "
                f"argmax stream, so a temperature={req.temperature} "
                "sampled stream would silently diverge from the "
                "non-speculative engine; sample with spec_k=0")
        contracts.require_request(len(req.prompt), req.max_new_tokens,
                                  self.cache_len, window=self.cfg.window)
        sess = Session(uid=self._uid, request=req)
        self._uid += 1
        self.queue.append(sess)
        return sess

    def _admit(self):
        for slot in range(self.batch):
            if self.slots[slot] is None and self.queue:
                sess = self.queue[0]
                if sess.state == "preempted":
                    self.queue.pop(0)
                    self._rebind(sess, slot)
                    continue
                if not self._try_bind_new(sess, slot):
                    break           # pool pressure: retry next step

    @staticmethod
    def _n_pre(sess: Session) -> int:
        return len(sess.request.prompt) - 1

    def _try_bind_new(self, sess: Session, slot: int) -> bool:
        """Longest-prefix lookup, all-or-nothing page reservation for the
        rest of the prompt, lane binding.  False under transient pool
        pressure; :class:`PagePoolExhausted` when the prompt never fits."""
        n_pre = self._n_pre(sess)
        shared: List[int] = []
        if self.prefix is not None and n_pre > 0:
            hit = self.prefix.lookup(sess.request.prompt, n_pre)
            if hit is not None:
                shared = list(hit.pages)    # retained for this session
                sess.prefill_pos = hit.count
        if self.paged:
            try:
                reserved = self._reserve_prefill(sess, n_pre, shared)
            except PagePoolExhausted:
                for page in shared:
                    self.kv.allocator.release(page)
                sess.prefill_pos = 0
                raise
            if not reserved:
                for page in shared:
                    self.kv.allocator.release(page)
                sess.prefill_pos = 0
                return False
        self.queue.pop(0)
        self.slots[slot] = sess
        self.pos[slot] = sess.prefill_pos
        sess.pos = sess.prefill_pos
        if self.paged:
            self.kv.bind(sess, slot)
        else:
            sess.slot = slot
        sess.state = "prefilling"
        self._reset_slot_cache(slot)
        if sess.prefill_pos >= n_pre:
            self._finish_prefill(slot, sess)
        return True

    def _reserve_prefill(self, sess: Session, n_pre: int,
                         shared: List[int]) -> bool:
        span = min(n_pre, self.L)
        blocks = -(-span // self.layout.page_size) if span > 0 else 0
        need = blocks - len(shared)
        if blocks > self.layout.num_pages - 1:
            raise PagePoolExhausted(
                f"prompt needs {blocks} pages, pool only has "
                f"{self.layout.num_pages - 1}")
        acquired: List[int] = []
        try:
            while len(acquired) < need:
                acquired.append(self.kv.allocator.alloc())
        except PagePoolExhausted:
            for page in acquired:
                self.kv.allocator.release(page)
            return False
        sess.pages = shared + acquired
        return True

    def _rebind(self, sess: Session, slot: int):
        """Resume a preempted session on a free lane (pages untouched)."""
        self.slots[slot] = sess
        self.pos[slot] = sess.pos
        self.kv.bind(sess, slot)
        if sess.last_token is None:
            sess.state = "prefilling"   # preempted mid-prefill

    def _finish_prefill(self, slot: int, sess: Session):
        n_pre = self._n_pre(sess)
        sess.prefill_pos = n_pre
        sess.state = "active"
        self.pos[slot] = n_pre
        sess.pos = n_pre
        sess.last_token = sess.request.prompt[-1]
        if self.prefix is not None and n_pre > 0:
            self.prefix.register(sess.request.prompt, n_pre, sess.pages)

    # --------------------------------------------------------- prefill ---

    def _advance_prefill(self):
        """Advance prefilling lanes, at most ``prefill_budget`` prompt
        tokens per engine step (chunk granularity, one chunk minimum)."""
        budget = math.inf if self.prefill_budget is None \
            else self.prefill_budget
        while budget > 0:
            lanes = [i for i, s in enumerate(self.slots)
                     if s is not None and s.state == "prefilling"]
            if not lanes:
                return
            if self._use_chunked:
                budget -= self._prefill_chunk_round(lanes, budget)
            else:
                budget -= self._prefill_stream_round(lanes, budget)

    def _prefill_stream_round(self, lanes: List[int], budget) -> int:
        spent = 0
        for i in lanes:
            sess = self.slots[i]
            prompt = sess.request.prompt
            n_pre = self._n_pre(sess)
            while sess.prefill_pos < n_pre and spent < budget:
                self._step_one(i, prompt[sess.prefill_pos])
                sess.prefill_pos += 1
                spent += 1
            if sess.prefill_pos >= n_pre:
                self._finish_prefill(i, sess)
        return max(spent, 1)

    def _prefill_chunk_round(self, lanes: List[int], budget) -> int:
        """One batched chunk round through a single prefill step; lanes
        join while the budget allows (one lane minimum).  Returns the real
        prompt tokens advanced."""
        C = self.prefill_chunk
        ps = self.layout.page_size
        logical = self.layout.logical_len
        toks = np.zeros((self.batch, C), np.int32)
        base = np.zeros(self.batch, np.int32)
        spent = 0
        included: List[int] = []
        for i in lanes:
            if included and spent >= budget:
                break
            sess = self.slots[i]
            prompt = sess.request.prompt
            b0 = sess.prefill_pos
            base[i] = b0
            real = min(C, self._n_pre(sess) - b0)
            toks[i, :real] = prompt[b0:b0 + real]
            spent += real
            included.append(i)
            # copy-on-write any shared page this chunk will write into
            blk_hi = (min(b0 + C, logical) - 1) // ps
            for blk in range(b0 // ps, min(blk_hi + 1, len(sess.pages))):
                if self.kv.allocator.refcount[sess.pages[blk]] > 1:
                    self._cow(sess, blk)
        # the prefill view of the page table: lanes outside this round
        # write their discarded chunk rows into the null page
        view = self.kv.page_table.snapshot()
        for slot in range(self.batch):
            if slot not in included:
                view[slot] = NULL_PAGE
        it.int_prefill_chunk_step(
            self.qparams, self.caches, self._stage("chunk_toks", toks),
            self._stage("chunk_base", base), self.plans, self.local_cfg,
            self.rope_tab, ops=self.ops, fold_wo=self.fold_wo,
            pos_span=(int(base.min()), int(base.max()) + C - 1),
            tp_group=self.tp_group, **self._paged_args("chunk_pages", view))
        for i in included:
            sess = self.slots[i]
            n_pre = self._n_pre(sess)
            sess.prefill_pos = min(sess.prefill_pos + C, n_pre)
            self.pos[i] = sess.prefill_pos
            sess.pos = sess.prefill_pos
            if sess.prefill_pos >= n_pre:
                self._finish_prefill(i, sess)
        return max(spent, 1)

    def _reset_slot_cache(self, slot: int):
        """Zero a recycled lane's lane-indexed cache state, as the
        reference does: its Mamba state (``h``, ``conv``) in either mode,
        its contiguous K/V slab.  Paged pools are not lane-indexed and are
        never zeroed: ``valid_len`` masking makes stale page contents
        unobservable.  The zeroing is queued on the card's stream: it
        runs after every step already dispatched (whose commit came
        first: admission happens in :meth:`dispatch_step` alone) and
        before the lane's first prompt token."""
        for c in self.caches:
            keys = ("h", "conv") if "h" in c \
                else () if self.paged else ("k8", "v8")
            for key in keys:
                c[key][:, slot].zero_()

    # --------------------------------------------------- paged bookkeeping

    def _reclaim_prefix(self):
        """Allocator pressure hook: evict prefix entries LRU-first."""
        while self.kv.allocator.free_pages == 0 and self.prefix is not None \
                and self.prefix.evict_lru():
            pass

    def _cow(self, sess: Session, blk: int):
        """Copy-on-write: a private copy of a shared page (and, int4, of its
        shifts) before a write lands on it."""
        old = sess.pages[blk]
        try:
            new = self.kv.allocator.alloc()
        except PagePoolExhausted:
            if self.kv.allocator.refcount[old] == 1:
                return
            raise
        for c in self.caches:
            for key in ("k8", "v8", "k_shift", "v_shift"):
                if key in c:
                    c[key][:, new] = c[key][:, old]
        self.kv.allocator.release(old)
        sess.pages[blk] = new
        if sess.slot is not None:
            self.kv.page_table.table[sess.slot, blk] = new
        self._cow_copies += 1

    def _ensure_write_pages(self, n_new=None):
        """Before a decode step, make the page under every occupied
        lane's write slot (``pos``, or ``pos % window``) resident and
        exclusively owned; ``n_new`` (B,) widens each lane's span to
        ``[pos, pos + n_new)`` for the verify step, so a draft never
        writes a page the prefix index or a sibling still reads.
        Nothing to do for the contiguous layout."""
        if not self.paged:
            return
        for slot, sess in enumerate(self.slots):
            if sess is None:
                continue
            p = int(self.pos[slot])
            span = 1 if n_new is None else int(n_new[slot])
            for q in range(p, p + span):
                wslot = q % self.cfg.window if self.cfg.window > 0 else q
                wslot = min(wslot, self.L - 1)
                self.kv.ensure(sess, wslot)
                blk = wslot // self.layout.page_size
                if self.kv.allocator.refcount[sess.pages[blk]] > 1:
                    self._cow(sess, blk)

    def _require_committed(self, op: str):
        if self._inflight is not None:
            raise StepInFlight(
                f"{op} while a dispatched step is uncommitted: call "
                "commit_step(pending) first — the pending step will be "
                "committed against the sessions it captured")

    def evict(self, sess: Session):
        """Cancel a session: free its lane and release its pages."""
        self._require_committed("evict")
        if sess in self.queue:
            self.queue.remove(sess)
        if sess.slot is not None:
            self.pos[sess.slot] = 0
            self.slots[sess.slot] = None
        self._release(sess)

    def _release(self, sess: Session):
        if self.paged:
            self.kv.release(sess)
        else:
            sess.slot = None
            sess.state = "done"

    def preempt(self, sess: Session):
        """Take a live session off its lane but keep its pages; it goes
        back to the queue head and resumes bit-exactly.  Paged mode only:
        the contiguous layout ties K/V to the lane; and not for an arch
        with Mamba sublayers, whose state is tied to the lane."""
        self._require_committed("preempt")
        if not self.paged:
            raise ValueError("preempt needs cache_mode='paged' (the "
                             "contiguous layout ties K/V to the lane)")
        if self._has_ssm:
            raise ValueError("preempt is unsupported for SSM/hybrid "
                             "archs: Mamba state is lane-indexed")
        if sess.state not in ("active", "prefilling") or sess.slot is None:
            raise ValueError("cannot preempt session in state "
                             f"{sess.state!r}")
        slot = sess.slot
        sess.pos = int(self.pos[slot])
        self.kv.unbind(sess)
        self.slots[slot] = None
        self.pos[slot] = 0
        self.queue.insert(0, sess)

    def _retire(self, slot: int):
        sess = self.slots[slot]
        sess.request.done = True
        self.slots[slot] = None
        self.pos[slot] = 0
        self._release(sess)
        self._finished.append(sess.request)

    # ---------------------------------------------------------- decode ---

    def _step_one(self, slot: int, token: int):
        toks = np.zeros(self.batch, np.int32)
        toks[slot] = token
        self._ensure_write_pages()
        self._run_decode(toks)
        self.pos[slot] += 1
        self.slots[slot].pos = int(self.pos[slot])

    def _at_cache_end(self, slot: int) -> bool:
        """The lane's next token would need a K/V slot past the cache."""
        return self.pos[slot] >= self.cache_len

    def step(self) -> int:
        """One engine step: admit, advance prefill (budgeted), one batched
        decode (or, with ``spec_k``, one verify committing up to ``spec_k
        + 1`` tokens a lane) for lanes whose prompt is in, retire finished
        lanes.  Returns the number of occupied lanes.  Exactly
        ``commit_step(dispatch_step())``."""
        return self.commit_step(self.dispatch_step())

    def dispatch_step(self) -> PendingStep:
        """The scheduling and dispatch half of :meth:`step`: admit, advance
        prefill, draft (``spec_k``) and queue the decode or verify step on
        the device without waiting for it.  Returns the
        :class:`PendingStep` to pass to :meth:`commit_step`; until then
        ``evict`` / ``preempt`` / another dispatch raise
        :class:`StepInFlight`."""
        self._require_committed("dispatch_step")
        self._admit()
        self._advance_prefill()
        occupied = sum(s is not None for s in self.slots)
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.state == "active"]
        if not live:
            return PendingStep(occupied, "idle")
        sessions = list(self.slots)
        if self.spec_k:
            toks, n_new, drafts = self._build_spec_batch(live)
            self._ensure_write_pages(n_new)
            logits, _ = self._run_verify(toks, n_new)
            pending = PendingStep(occupied, "verify", live, sessions,
                                  logits, n_new, drafts)
        else:
            toks = np.zeros(self.batch, np.int32)
            for i in live:
                toks[i] = self.slots[i].last_token
            self._ensure_write_pages()
            logits, _ = self._run_decode(toks)
            pending = PendingStep(occupied, "decode", live, sessions,
                                  logits)
        self._inflight = pending
        return pending

    def commit_step(self, pending: PendingStep) -> int:
        """The sampling and bookkeeping half of :meth:`step`: read the
        logits back (the one place the host waits on the device), sample
        or accept, advance positions, retire finished lanes.  Returns the
        occupied-lane count."""
        if pending.kind == "idle":
            return pending.occupied
        if self._inflight is not pending:
            raise StepInFlight(
                "commit_step got a PendingStep that is not the one in "
                "flight: each dispatch_step() result is committed exactly "
                "once, in order")
        self._inflight = None
        if pending.kind == "verify":
            self._commit_spec(pending)
        else:
            self._commit_decode(pending)
        return pending.occupied

    def _commit_decode(self, pending: PendingStep):
        logits = pending.logits.cpu().numpy()
        for i in pending.live:
            sess = self.slots[i]
            req = sess.request
            self.pos[i] += 1
            sess.pos = int(self.pos[i])
            nxt = self._sample(req, logits[i][:self.cfg.vocab])
            req.out_tokens.append(nxt)
            sess.last_token = nxt
            if len(req.out_tokens) >= req.max_new_tokens \
                    or self._at_cache_end(i):
                self._retire(i)

    def _build_spec_batch(self, live: List[int]):
        """The draft half of a verify step: each live lane drafts ``k_b =
        min(spec_k, remaining - 1, L - pos - 1)`` tokens (never past its
        budget or the cache), and ``[last_token, *draft]`` goes
        right-aligned into the lane's row of the (B, spec_k + 1) tokens;
        other lanes ride along as the plain step's discarded token-0 row
        (``n_new = 1``)."""
        s = self.spec_k + 1
        toks = np.zeros((self.batch, s), np.int32)
        n_new = np.ones(self.batch, np.int32)
        drafts: Dict[int, List[int]] = {}
        for i in live:
            sess = self.slots[i]
            req = sess.request
            remaining = req.max_new_tokens - len(req.out_tokens)
            room = self.L - int(self.pos[i]) - 1
            k_b = max(0, min(self.spec_k, remaining - 1, room))
            draft = self.proposer.propose(
                req.prompt + req.out_tokens, k_b) if k_b else []
            drafts[i] = draft
            n = 1 + len(draft)
            n_new[i] = n
            toks[i, s - n:] = [sess.last_token] + draft
        return toks, n_new, drafts

    def _commit_spec(self, pending: PendingStep):
        """The acceptance half: commit the longest draft prefix matching
        the argmax rows plus the bonus token (equal to ``a + 1`` plain
        steps), then truncate the page list to the committed positions,
        releasing the pages only rejected drafts touched."""
        s = self.spec_k + 1
        logits = pending.logits.cpu().numpy()
        for i in pending.live:
            sess = self.slots[i]
            req = sess.request
            draft = pending.drafts[i]
            n = int(pending.n_new[i])
            preds = np.argmax(logits[i, s - n:, :self.cfg.vocab], axis=-1)
            a = 0
            while a < len(draft) and int(preds[a]) == draft[a]:
                a += 1
            commit = [int(t) for t in preds[:a + 1]]
            self._spec_drafted += len(draft)
            self._spec_accepted += a
            req.out_tokens.extend(commit)
            sess.last_token = commit[-1]
            self.pos[i] += len(commit)
            sess.pos = int(self.pos[i])
            if self.paged and len(commit) < n:
                self.kv.truncate(sess, int(self.pos[i]))
            if len(req.out_tokens) >= req.max_new_tokens \
                    or self._at_cache_end(i):
                self._retire(i)

    def _sample(self, req: Request, row: np.ndarray) -> int:
        """Greedy argmax for ``temperature <= 0``; otherwise a float64
        softmax sample of the dequantized logits from the engine's seeded
        generator (the reference's rule, so equal logits and schedules
        give equal streams)."""
        if req.temperature <= 0:
            return int(np.argmax(row))
        z = row.astype(np.float64)
        p = np.exp((z - z.max()) / req.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    # ------------------------------------------------------ introspection --

    def describe(self) -> dict:
        """Structured engine signature: backends, prefill mode, cache
        geometry and live page-pool / prefix-cache stats."""
        if self.paged:
            cache = dict(mode="paged", kv_pack=self.layout.kv_dtype,
                         **self.kv.stats())
            cache["live_tokens"] = int(sum(
                s.live_tokens for s in self.slots if s is not None)
                + sum(s.live_tokens for s in self.queue))
            cache["shared_pages"] = int(
                (self.kv.allocator.refcount[1:] > 1).sum())
            cache["cow_copies"] = self._cow_copies
            cache["prefix"] = self.prefix.stats() \
                if self.prefix is not None else None
        else:
            cache = {"mode": "contiguous", "kv_pack": "int8"}
        # the pools' bytes: packed int4 pools hold half of int8's a token;
        # a sharded rank holds 1/tp of every page
        local_kv = int(sum(
            c[key].numel() * c[key].element_size()
            for c in self.caches for key in ("k8", "v8") if key in c))
        cache["kv_bytes"] = local_kv * (self.tp if self.tp_sharded else 1)
        tp = {
            "tp": self.tp,
            # "sharded": heads over the process group; "gathered": tp > 1
            # without such a group (or a backend without tp_serving), the
            # exact single-device lowering; "off": tp == 1
            "mode": ("sharded" if self.tp_sharded
                     else "gathered" if self.tp > 1 else "off"),
            "mesh": None if not self.tp_sharded else {
                "axis": tp_serving.TP_AXIS,
                "shape": [self.tp],
                "ranks": dist.get_process_group_ranks(self.tp_group),
                "backend": str(dist.get_backend(self.tp_group)),
            },
            "per_device_kv_bytes": local_kv,
        }
        drafted, accepted = self._spec_drafted, self._spec_accepted
        return {
            "ops": self.ops.name,
            "backends": {op: self.ops.backend_for(op).name
                         for op in OP_NAMES},
            "device": str(self.device),
            "spec": {
                "k": self.spec_k,
                "mode": self.spec_mode,
                "drafted": drafted,
                "accepted": accepted,
                "accept_rate": round(accepted / drafted, 4) if drafted
                else None,
                "wasted": drafted - accepted,
            },
            "prefill": {
                "mode": "chunked" if self._use_chunked else "streaming",
                "chunk": self.prefill_chunk,
                "budget": self.prefill_budget,
            },
            "fold_wo": self.fold_wo,
            "tp": tp,
            "batch": self.batch,
            "cache_len": self.cache_len,
            "cache": cache,
        }

    def describe_str(self) -> str:
        d = self.describe()
        c = d["cache"]
        pf = d["prefill"]
        prefill = f"chunked:{pf['chunk']}" if pf["mode"] == "chunked" \
            else "streaming"
        if c.get("prefix") is not None:
            prefill += f"+prefix[{c['prefix']['entries']}]"
        if c["mode"] == "paged":
            pack = "" if c["kv_pack"] == "int8" else f", {c['kv_pack']}"
            cache = (f"paged[{c['page_size']}tok x {c['num_pages']}pg"
                     f"{pack}, "
                     f"{c['pages_used']}/{c['num_pages'] - 1} used]")
        else:
            cache = "contiguous"
        tp = "" if d["tp"]["tp"] == 1 \
            else f" tp={d['tp']['tp']}:{d['tp']['mode']}"
        sp = d["spec"]
        spec = "" if not sp["k"] else (
            f" spec={sp['mode']}:k{sp['k']}"
            + (f"@{sp['accept_rate']:.2f}"
               if sp["accept_rate"] is not None else ""))
        return (f"ops={d['ops']} device={d['device']} prefill={prefill} "
                f"fold_wo={str(d['fold_wo']).lower()}{tp}{spec} "
                f"cache={cache} batch={d['batch']} "
                f"cache_len={d['cache_len']}")

    def run_until_done(self, max_steps: int = 10000) -> List[Request]:
        """Step until queue and lanes drain; returns the requests that
        retired since the last call.  Raises :class:`EngineStalled` if
        ``max_steps`` elapse first."""
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
        else:
            if self.queue or any(s is not None for s in self.slots):
                slots = [
                    None if s is None else {
                        "uid": s.request.uid, "state": s.state,
                        "pos": int(self.pos[i]),
                        "prefill_pos": s.prefill_pos}
                    for i, s in enumerate(self.slots)]
                raise EngineStalled(max_steps, slots, len(self.queue))
        finished, self._finished = self._finished, []
        return finished
