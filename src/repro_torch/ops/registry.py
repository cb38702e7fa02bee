"""The backend protocol, the registry, the OpSet dispatch handle and
backend resolution (twin of ``repro.ops.registry``).

Every integer op is implemented by a *backend*: an object with the six
methods of :class:`Backend` (``REQUIRED_OPS``), a ``name`` and a
``fused_attention`` flag.  Backends register under a name
(:func:`register_backend`, which refuses a non-backend and, unless
``overwrite``, a name already taken); models receive one resolved
:class:`OpSet` and every op dispatches through it, to one default
backend or, per op, to an override.  Five backends are built in:

  * ``"cuda"`` (the default) — the counterpart of the JAX package's
    ``pallas_fused``: the hand-written kernels K1–K7, with K5 the exact
    full-sequence attention at any length;
  * ``"cuda_ref"`` — the counterpart of ``ref``: the same kernels in
    every op, but, like ``ref``, it declares ``fused_attention = False``,
    so the model layer takes the reference's chunked two-pass attention
    (``core.attention.i_attention_chunked``) above its full-matrix
    threshold and K5 below it (where K5's integers are the oracle's);
  * ``"cuda_online"`` / ``"cuda_online_tuned"`` — the counterparts of
    ``pallas`` / ``pallas_tuned``: K8, the one-pass online attention, at
    the reference's logical blocks (``ops.backends.cuda_online``);
  * ``"torch_ref"`` — the plain oracles, the integers of ``ref``.

Resolution order for ``resolve_ops(spec, cfg)``, as in the reference:

  1. an explicit ``spec`` argument (OpSet / backend / name);
  2. the innermost active :func:`use_backend` context;
  3. the ``REPRO_BACKEND`` environment variable;
  4. ``cfg.kernel_backend`` when an ArchConfig is supplied;
  5. ``"cuda"``.

Every name passes through one twin table, :data:`TWINS`, so the JAX
package's backend names select their counterparts here: ``ref`` gives
``cuda_ref``, ``pallas_fused`` ``cuda``, ``pallas`` ``cuda_online``.  The
reference's ``ref`` and ``pallas_fused`` give different integers above
``S * Skv = 4096^2 / 4`` (the chunked path rescales its sums, K5 does
not), so their twins are two backends; ``cuda_ref`` and ``torch_ref``
give the integers of ``ref`` everywhere.  ``ArchConfig.kernel_backend``
defaults to ``"ref"``, which therefore runs the kernels and never the
plain versions on the card: ``torch_ref`` runs only when named.  One
``REPRO_BACKEND`` selects the twin paths in both packages.

``fused_attention`` says whether a backend's ``int_attention`` is one
streaming kernel (the model layer then calls it at any length) or stands
for the full-matrix oracle (which the layer calls only up to the
reference's chunking threshold, streaming the chunked path above it).
Optional capabilities are negotiated exactly as in the reference: a
backend advertising ``paged_decode`` / ``decode_wo_fold`` /
``paged_prefill`` / ``prefill_wo_fold`` / ``packed_kv`` /
``packed_matmul`` gets the page table, the folded o-projection, packed
int4 pools (``kv_shifts``) and packed int4 / MSR-4 weights verbatim; for
the rest this layer lowers them exactly (gather pages, decode-then-matmul,
scatter + stepped-mask paged decode, dequantize the pools with
``ops.packed.unpack_kv_pool``, reconstruct the weights with
``ops.packed.unpack_weights``), so every backend returns identical
integers.  A packed wo never folds into an attention launch: it takes the
unfolded composition through ``int8_matmul_packed``, as in the
reference.  A prefill chunk bound for packed pools is quantized
and packed here (``ops.packed.pack_kv``) for every backend, so the pool
bytes never depend on the backend.  ``tp_serving`` is negotiated by the
serving engine (``distributed.tp_serving.backends_support_tp``): a
``tp > 1`` engine shards its heads over a process group only when every
backend of the OpSet advertises it (``cuda``, ``cuda_ref``,
``torch_ref``; not ``cuda_online``, as the reference's ``pallas`` does
not), and takes the exact single-device (gathered) lowering otherwise.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Dict, Optional, Protocol, Union, \
    runtime_checkable

import torch

from repro_torch.ops.packed import pack_kv, unpack_kv_pool, unpack_weights
from repro_torch.ops.paged import gather_pages, scatter_chunk
from repro_torch.ops.spec import QuantLinearParams

ENV_VAR = "REPRO_BACKEND"
DEFAULT_BACKEND = "cuda"

#: the JAX package's backend names -> their counterparts in the port
TWINS = {"ref": "cuda_ref", "pallas_fused": "cuda", "pallas": "cuda_online",
         "pallas_tuned": "cuda_online_tuned"}

# the six methods every backend must implement
REQUIRED_OPS = ("int8_matmul", "int_softmax", "int_gelu", "int_layernorm",
                "int_attention", "int_decode_attention")
# ... plus the ops that are capabilities: a backend advertising the flag
# implements them, everyone else is served by an exact lowering in OpSet
# (dispatch and overrides route on OP_NAMES, the protocol demands
# REQUIRED_OPS)
OP_NAMES = REQUIRED_OPS + ("int_paged_prefill", "int8_matmul_packed")


@runtime_checkable
class Backend(Protocol):
    """The six integer ops every backend implements, its ``name`` and its
    ``fused_attention`` flag (see the module docstring; the optional
    capability flags are negotiated by :class:`OpSet`)."""

    name: str
    fused_attention: bool

    def int8_matmul(self, x8, w8, spec, *, bias32=None, b_vec=None): ...

    def int_softmax(self, scores, plan, **opts): ...

    def int_gelu(self, q, plan, dn_out, out_bits: int = 8): ...

    def int_layernorm(self, q, q_gamma, q_beta, plan,
                      out_bits: int = 8): ...

    def int_attention(self, q8, k8, v8, plan, causal: bool = True,
                      window: int = 0, out_bits: int = 8, requant=None,
                      b_vec=None): ...

    def int_decode_attention(self, q8, k8_cache, v8_cache, plan, valid_len,
                             requant=None, b_vec=None): ...


def _is_backend(obj) -> bool:
    """A backend *instance*: the six required ops plus ``name`` and
    ``fused_attention``.  A class is not one: a registered class is a
    factory, and calling its unbound methods would misbind ``self``."""
    if isinstance(obj, type):
        return False
    return (all(callable(getattr(obj, op, None)) for op in REQUIRED_OPS)
            and isinstance(getattr(obj, "name", None), str)
            and hasattr(obj, "fused_attention"))


_REGISTRY: Dict[str, Union[Backend, Callable[[], Backend]]] = {}
_LOCK = threading.Lock()
_BUILTIN_LOCK = threading.RLock()
_builtin = "todo"        # "todo" | "running" (its thread holds the lock) | "done"


def _ensure_builtin() -> None:
    """Register the built-in backends once, before any lookup or
    registration (so a user's backend never hides them).  The thread that
    registers them re-enters here from ``register_backend`` and returns;
    any other thread waits on the lock until they are in."""
    global _builtin
    if _builtin == "done":
        return
    with _BUILTIN_LOCK:
        if _builtin != "todo":
            return
        _builtin = "running"
        try:
            from repro_torch.ops.backends import register_builtin
            register_builtin()
        except BaseException:
            _builtin = "todo"
            raise
        _builtin = "done"


def register_backend(name: str, backend, *, overwrite: bool = False) -> None:
    """Register a backend instance or a zero-argument factory of one under
    ``name``; a name already taken raises unless ``overwrite``."""
    if not (_is_backend(backend) or callable(backend)):
        raise TypeError(f"{backend!r} implements neither the Backend "
                        "protocol nor a factory for one")
    _ensure_builtin()
    with _LOCK:
        if name in _REGISTRY and not overwrite:
            raise ValueError(f"backend {name!r} already registered "
                             "(pass overwrite=True to replace)")
        _REGISTRY[name] = backend


def unregister_backend(name: str) -> None:
    with _LOCK:
        _REGISTRY.pop(name, None)


def twin_backend(name: str) -> str:
    """The port's backend for ``name`` (a JAX backend name maps to its
    twin; a port name maps to itself)."""
    return TWINS.get(name, name)


def get_backend(name: str):
    """Look up a registered backend (through :data:`TWINS`), instantiating
    a lazy factory once."""
    _ensure_builtin()
    key = twin_backend(name)
    with _LOCK:
        entry = _REGISTRY.get(key)
    if entry is None:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{available_backends()}")
    if not _is_backend(entry):
        entry = entry()
        if not _is_backend(entry):
            raise TypeError(f"factory for {name!r} returned a "
                            "non-Backend")
        with _LOCK:
            _REGISTRY[key] = entry
    return entry


def available_backends():
    _ensure_builtin()
    with _LOCK:
        return sorted(_REGISTRY)


def _as_backend(spec):
    if isinstance(spec, str):
        return get_backend(spec)
    if _is_backend(spec):
        return spec
    raise TypeError(f"cannot interpret {spec!r} as a backend")


class OpSet:
    """A resolved operator bundle: one default backend + per-op overrides
    (e.g. the online attention on ``cuda_online`` with everything else on
    ``torch_ref``)."""

    __slots__ = ("default", "overrides")

    def __init__(self, default, overrides: Optional[Dict[str, object]] = None):
        self.default = _as_backend(default)
        ov = {}
        for op, b in (overrides or {}).items():
            if op not in OP_NAMES:
                raise KeyError(f"unknown op {op!r}; valid ops: {OP_NAMES}")
            ov[op] = _as_backend(b)
        self.overrides = ov

    @property
    def name(self) -> str:
        if not self.overrides:
            return self.default.name
        ov = ",".join(f"{op}={b.name}"
                      for op, b in sorted(self.overrides.items()))
        return f"{self.default.name}[{ov}]"

    def backend_for(self, op: str):
        if op not in OP_NAMES:
            raise KeyError(f"unknown op {op!r}; valid ops: {OP_NAMES}")
        return self.overrides.get(op, self.default)

    def with_overrides(self, **per_op) -> "OpSet":
        merged = dict(self.overrides)
        merged.update(per_op)
        return OpSet(self.default, merged)

    def __repr__(self):
        return f"OpSet({self.name})"

    # ------------------------------------------------------------ ops --

    def int8_matmul(self, x8, w8, spec, *, bias32=None, b_vec=None):
        return self.backend_for("int8_matmul").int8_matmul(
            x8, w8, spec, bias32=bias32, b_vec=b_vec)

    def int8_matmul_grouped(self, x8, w8, rows, spec, *, bias32=None,
                            b_vec=None):
        """Every expert's product at once (an MoE's experts): x8 (E, R,
        K), w8 (E, K, N), ``rows`` (E,) int32 (expert e's tokens are its
        first ``rows[e]`` rows), expert e's ``bias32`` / ``b_vec`` rows.
        It is an instantiation of ``int8_matmul`` and routes with it: the
        backend serving ``int8_matmul`` must implement
        ``int8_matmul_grouped`` (every built-in one does), else an MoE
        arch cannot run on it."""
        be = self.backend_for("int8_matmul")
        fn = getattr(be, "int8_matmul_grouped", None)
        if fn is None:
            raise NotImplementedError(
                f"backend {be.name!r} has no int8_matmul_grouped (the "
                "expert products of a mixture of experts); MoE archs need "
                "a backend that implements it")
        return fn(x8, w8, rows, spec, bias32=bias32, b_vec=b_vec)

    def int_softmax(self, scores, plan, **opts):
        """Row Shiftmax of int32 scores -> int8 probabilities; ``opts``:
        ``valid_len`` (a static padding mask), ``block_rows``, ``where``
        (oracle only: the kernel backends raise for it)."""
        return self.backend_for("int_softmax").int_softmax(scores, plan,
                                                           **opts)

    def int_layernorm(self, q, q_gamma, q_beta, plan, out_bits: int = 8):
        return self.backend_for("int_layernorm").int_layernorm(
            q, q_gamma, q_beta, plan, out_bits=out_bits)

    def int_gelu(self, q, plan, dn_out, out_bits: int = 8):
        return self.backend_for("int_gelu").int_gelu(q, plan, dn_out,
                                                     out_bits=out_bits)

    def int_attention(self, q8, k8, v8, plan, causal: bool = True,
                      window: int = 0, out_bits: int = 8, requant=None,
                      b_vec=None):
        """Full-sequence attention, (B, Sq, H, D) queries against (B, Skv,
        Hkv, D) keys/values; ``requant``/``b_vec`` as the decode op."""
        return self.backend_for("int_attention").int_attention(
            q8, k8, v8, plan, causal=causal, window=window,
            out_bits=out_bits, requant=requant, b_vec=b_vec)

    def int8_matmul_packed(self, x8, qw, spec):
        """Matmul against packed (int4 / msr4) weights, with negotiation:
        a backend advertising ``packed_matmul`` gets the packed operands as
        they are; for the rest the weights are reconstructed exactly
        (``ops.packed.unpack_weights``) for the backend's own
        ``int8_matmul``, so every backend gives the same integers.  A dense
        ``qw`` falls through to ``int8_matmul``."""
        qw = QuantLinearParams.of(qw)
        if not qw.is_packed:
            return self.int8_matmul(x8, qw.w8, spec, bias32=qw.bias32,
                                    b_vec=qw.b_mult)
        be = self.backend_for("int8_matmul_packed")
        if getattr(be, "packed_matmul", False):
            return be.int8_matmul_packed(x8, qw, spec)
        return be.int8_matmul(x8, unpack_weights(qw), spec,
                              bias32=qw.bias32, b_vec=qw.b_mult)

    def _compose_wo(self, be, o8, wo, wo_spec):
        """Exact unfolded composition: attention output -> o-projection
        (a packed wo through :meth:`int8_matmul_packed`)."""
        b, sq = o8.shape[0], o8.shape[1]
        x8 = o8.to(torch.int8).reshape(b * sq, -1)
        if wo.is_packed:
            acc = self.int8_matmul_packed(x8, wo, wo_spec)
        else:
            acc = be.int8_matmul(x8, wo.w8, wo_spec, bias32=wo.bias32,
                                 b_vec=wo.b_mult)
        if not wo_spec.is_raw and wo_spec.out_bits <= 8:
            acc = acc.to(torch.int8)       # the folded kernel's dtype
        return acc.reshape(b, sq, -1)

    def int_decode_attention(self, q8, k8_cache, v8_cache, plan, valid_len,
                             pages=None, page_size: int = 0, wo=None,
                             wo_spec=None, requant=None, kv_shifts=None):
        """Decode attention with capability negotiation (``pages`` selects
        the paged layout; ``wo``/``wo_spec`` ask for the folded
        o-projection; ``kv_shifts``, the ``(k_shift, v_shift)`` per-page
        shifts, marks the pools as packed int4, paged layout only)."""
        be = self.backend_for("int_decode_attention")
        if kv_shifts is not None and pages is None:
            raise ValueError("int4 KV (kv_shifts=) requires the paged "
                             "layout")
        kw = {}
        if pages is not None:
            paged_native = getattr(be, "paged_decode", False)
            if kv_shifts is not None:
                if paged_native and getattr(be, "packed_kv", False):
                    kw.update(kv_shifts=kv_shifts)
                else:
                    k8_cache = unpack_kv_pool(k8_cache, kv_shifts[0])
                    v8_cache = unpack_kv_pool(v8_cache, kv_shifts[1])
            if paged_native:
                kw.update(pages=pages, page_size=page_size)
            else:
                k8_cache = gather_pages(k8_cache, pages, page_size)
                v8_cache = gather_pages(v8_cache, pages, page_size)
        if wo is None:
            return be.int_decode_attention(q8, k8_cache, v8_cache, plan,
                                           valid_len, requant=requant, **kw)
        wo = _validate_wo(wo, wo_spec, requant)
        if getattr(be, "decode_wo_fold", False) and not wo.is_packed:
            return be.int_decode_attention(q8, k8_cache, v8_cache, plan,
                                           valid_len, requant=requant,
                                           wo=wo, wo_spec=wo_spec, **kw)
        o8 = be.int_decode_attention(q8, k8_cache, v8_cache, plan,
                                     valid_len, requant=requant, **kw)
        return self._compose_wo(be, o8, wo, wo_spec)

    def int_paged_prefill(self, q8, k8_new, v8_new, k_pool, v_pool, plan,
                          base_pos, pages, page_size: int, wo=None,
                          wo_spec=None, requant=None, kv_shifts=None):
        """Chunked paged prefill: scatter the chunk's K/V into the pools
        (in place) and attend causally over history + chunk.  With
        ``kv_shifts`` the pools are packed int4: the chunk's K/V are
        quantized and packed first (``ops.packed.pack_kv``), and a backend
        without ``packed_kv`` reads the pools dequantized.  Returns ``(o,
        k_pool, v_pool)``."""
        be = self.backend_for("int_paged_prefill")
        if wo is not None:
            wo = _validate_wo(wo, wo_spec, requant)
        if kv_shifts is not None:
            k8_new, v8_new = pack_kv(k8_new), pack_kv(v8_new)
        if getattr(be, "paged_prefill", False) and (
                kv_shifts is None or getattr(be, "packed_kv", False)):
            kw = {} if kv_shifts is None else dict(kv_shifts=kv_shifts)
            if wo is not None and getattr(be, "prefill_wo_fold", False) \
                    and not wo.is_packed:
                kw.update(wo=wo, wo_spec=wo_spec)
                wo = None
            o, k_pool, v_pool = be.int_paged_prefill(
                q8, k8_new, v8_new, k_pool, v_pool, plan, base_pos, pages,
                page_size, requant=requant, **kw)
            if wo is None:
                return o, k_pool, v_pool
            return self._compose_wo(be, o, wo, wo_spec), k_pool, v_pool
        # exact lowering: a chunk over pools that hold its K/V is paged
        # stepped-mask decode with valid_len = base_pos + C
        k_pool = scatter_chunk(k_pool, k8_new, base_pos, pages, page_size)
        v_pool = scatter_chunk(v_pool, v8_new, base_pos, pages, page_size)
        vl = base_pos.to(torch.int32) + q8.shape[1]
        o = self.int_decode_attention(q8, k_pool, v_pool, plan, vl,
                                      pages=pages, page_size=page_size,
                                      wo=wo, wo_spec=wo_spec, requant=requant,
                                      kv_shifts=kv_shifts)
        return o, k_pool, v_pool


def _validate_wo(wo, wo_spec, requant):
    """The fold feeds an int8 contraction: it needs the wo epilogue and an
    attention epilogue that clips to int8."""
    wo = QuantLinearParams.of(wo)
    if wo_spec is None:
        raise ValueError("folded wo projection needs wo_spec (the "
                         "o-projection's RequantSpec)")
    if requant is not None and (requant.is_raw or requant.out_bits > 8):
        raise ValueError("wo folding needs an int8 attention "
                         f"epilogue, got {requant}")
    return wo


# ------------------------------------------------------------ resolution --

_TLS = threading.local()


def _stack():
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def current_opset() -> Optional[OpSet]:
    """The innermost active :func:`use_backend` OpSet, if any."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_backend(spec, **per_op):
    """Scope a backend choice: ``with use_backend("cuda_online"): ...``;
    ``per_op`` overrides route single ops elsewhere, e.g.
    ``use_backend("torch_ref", int_attention="cuda_online")``."""
    if isinstance(spec, OpSet):
        ops = spec.with_overrides(**per_op) if per_op else spec
    else:
        ops = OpSet(spec, per_op or None)
    stack = _stack()
    stack.append(ops)
    try:
        yield ops
    finally:
        stack.pop()


def resolve_ops(spec=None, cfg=None) -> OpSet:
    """Resolve ``spec`` (OpSet / backend / name / None) to an OpSet: an
    explicit spec, else the active :func:`use_backend`, else
    ``REPRO_BACKEND``, else ``cfg.kernel_backend``, else ``"cuda"`` (names
    through :data:`TWINS`)."""
    if isinstance(spec, OpSet):
        return spec
    if spec is not None:
        return OpSet(spec)
    active = current_opset()
    if active is not None:
        return active
    env = os.environ.get(ENV_VAR)
    if env:
        return OpSet(env)
    if cfg is not None and getattr(cfg, "kernel_backend", None):
        return OpSet(cfg.kernel_backend)
    return OpSet(DEFAULT_BACKEND)
