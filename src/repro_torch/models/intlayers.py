"""Integer-path transformer layers of the serving path and the
full-sequence forward (the dense-decoder, encoder, mixture-of-experts and
Mamba subset of ``repro.models.intlayers``).

Every function consumes int8/int32 tensors and the design-time plans of
``repro_torch.quant.plans``.  Residual stream: int32 at ``cfg.s_res``
clipped to ``cfg.qmax_res``; matmul operands int8.  KV caches, contiguous
``(B, L, Hkv, hd)`` or paged pools ``(num_pages, page_size, Hkv, hd)``,
are updated **in place** (the reference returns new arrays; the bytes are
the same).  A Mamba block's state (the int32 SSD state ``h`` and the
int8 conv tail) is returned new, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.analysis import contracts
from repro_torch.core import activations as iact
from repro_torch.core import intmath
from repro_torch.core import norms
from repro_torch.core import softmax as ism
from repro_torch.core.attention import i_attention_chunked
from repro_torch.core.dyadic import (Dyadic, apply_dyadic_perchannel,
                                     clip_to_bits, rshift_round)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed import collectives
from repro_torch.models.common import ArchConfig
from repro_torch.ops import (QuantLinearParams, RequantSpec, get_backend,
                             resolve_ops)
from repro_torch.ops.packed import pack_kv
from repro_torch.quant import plans as qplans


# ------------------------------------------------------------- linear -----

def int_linear(x8, qw, plan: qplans.LinearPlan, ops=None):
    """x8 (..., K) int8 -> (..., N): int8 when the plan requantizes to
    <= 8 bits, else the int32 (clipped or raw) accumulator.  Packed
    (int4 / MSR-4) params dispatch to ``ops.int8_matmul_packed``."""
    ops = resolve_ops(ops)
    qw = QuantLinearParams.of(qw)
    lead = x8.shape[:-1]
    spec = RequantSpec.for_linear(plan)
    x2 = x8.reshape(-1, x8.shape[-1])
    if qw.is_packed:
        out = ops.int8_matmul_packed(x2, qw, spec)
    else:
        out = ops.int8_matmul(x2, qw.w8, spec, bias32=qw.bias32,
                              b_vec=qw.b_mult)
    out = out.reshape(*lead, qw.n_dim)
    if not spec.is_raw and plan.out_bits <= 8:
        out = out.to(torch.int8)
    return out


def _tp_wo_project(o8, qw, plan: qplans.LinearPlan, group, ops=None):
    """Head-sharded o-projection (tensor-parallel serving).

    ``o8``: (..., H_local·hd) int8, this rank's slice of the attention
    output; ``qw.w8``: the matching *row* slice of wo, ``qw.b_mult`` /
    ``qw.bias32`` whole.  Each rank computes the raw int32 partial
    product (K1 with ``RequantSpec.raw()``, no bias),
    :func:`~repro_torch.distributed.collectives.psum_int32` sums the
    partials over ``group`` exactly, and only then do the bias and the
    per-channel requant apply, once, on the full-sum accumulator: the
    requant rounds as it would on a single device."""
    ops = resolve_ops(ops)
    qw = QuantLinearParams.of(qw)
    if qw.is_packed:
        raise ValueError("the tensor-parallel o-projection takes a dense "
                         "wo row slice: packed weights do not shard "
                         "(ROADMAP §3)")
    lead = o8.shape[:-1]
    acc = ops.int8_matmul(o8.reshape(-1, o8.shape[-1]), qw.w8,
                          RequantSpec.raw())
    acc = collectives.psum_int32(acc, group)
    if qw.bias32 is not None:
        acc = acc + qw.bias32
    spec = RequantSpec.for_linear(plan)
    out = acc
    if not spec.is_raw:
        out = clip_to_bits(apply_dyadic_perchannel(acc, qw.b_mult, spec.c,
                                                   spec.pre, axis=-1),
                           spec.out_bits)
        if spec.out_bits <= 8:
            out = out.to(torch.int8)
    return out.reshape(*lead, qw.n_dim)


def int_norm(qnorm, q32, plan: norms.INormPlan, ops=None):
    """q32 (..., D) int32 at s_res -> int8 at s_act8."""
    ops = resolve_ops(ops)
    out = ops.int_layernorm(q32, qnorm["gamma_q"], qnorm.get("beta_q"),
                            plan, out_bits=8)
    return out.to(torch.int8)


# ------------------------------------------------------------- rope -------

ROPE_FRAC = 14


def build_rope_table(max_seq: int, hd: int, theta: float,
                     device=DEFAULT_DEVICE):
    """Design-time cos/sin tables at 2^-14 (integer RoPE), int32
    ``(max_seq, hd/2)`` each, computed in float64 exactly as the
    reference does, on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""
    pos = np.arange(max_seq, dtype=np.float64)[:, None]
    freqs = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    ang = pos * freqs[None, :]
    cos = np.round(np.cos(ang) * (1 << ROPE_FRAC)).astype(np.int32)
    sin = np.round(np.sin(ang) * (1 << ROPE_FRAC)).astype(np.int32)
    dev = resolve_device(device)
    return (torch.as_tensor(cos, device=dev),
            torch.as_tensor(sin, device=dev))


def rope_gather(rope_tab, positions, pos_span=None):
    """cos/sin rows for ``positions`` ((B,S) or (S,)), shaped to broadcast
    over (B, S, H, hd/2).  The reference's ``jnp.take`` would clamp an
    out-of-range position; here one raises ``IndexError``.

    ``pos_span``: ``(lo, hi)``, the least and greatest position, known on
    the host (the serving engine passes it, so a step reads nothing back
    from the card).  Without it the range is read from ``positions``:
    free on the CPU, a wait on the device otherwise."""
    cos_t, sin_t = rope_tab
    positions = positions.to(device=cos_t.device, dtype=torch.long)
    if pos_span is None and positions.numel():
        pos_span = (int(positions.min()), int(positions.max()))
    if pos_span is not None and (pos_span[0] < 0
                                 or pos_span[1] >= cos_t.shape[0]):
        raise IndexError(f"RoPE positions {pos_span[0]}..{pos_span[1]} "
                         f"outside the table's {cos_t.shape[0]} rows")
    cos, sin = cos_t[positions], sin_t[positions]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    return cos[:, :, None, :], sin[:, :, None, :]


def rope_rotate(q8, cos, sin):
    """Integer rotation of (B,S,H,hd) int8 by gathered cos/sin rows."""
    q = q8.to(torch.int32)
    q1, q2 = torch.chunk(q, 2, dim=-1)
    r1 = rshift_round(q1 * cos - q2 * sin, ROPE_FRAC)
    r2 = rshift_round(q1 * sin + q2 * cos, ROPE_FRAC)
    out = torch.cat([r1, r2], dim=-1)
    return torch.clamp(out, -127, 127).to(torch.int8)


def apply_int_rope(q8, positions, rope_tab):
    """q8: (B,S,H,hd) int8; positions: (B,S) or (S,) int."""
    cos, sin = rope_gather(rope_tab, positions)
    return rope_rotate(q8, cos, sin)


# --------------------------------------------------------- attention ------

def _qkv(qp, x8, plans: qplans.AttnPlan, cfg: ArchConfig, ops, kv_src=None):
    """Q of ``x8``, K and V of ``kv_src`` (a cross attention's memory;
    default ``x8``), each (B, S, heads, hd) int8."""
    b, s, _ = x8.shape
    kv_src = x8 if kv_src is None else kv_src
    sk = kv_src.shape[1]
    q8 = int_linear(x8, qp["wq"], plans.qkv, ops) \
        .reshape(b, s, cfg.n_heads, cfg.hd)
    k8 = int_linear(kv_src, qp["wk"], plans.qkv, ops) \
        .reshape(b, sk, cfg.n_kv_heads, cfg.hd)
    v8 = int_linear(kv_src, qp["wv"], plans.qkv, ops) \
        .reshape(b, sk, cfg.n_kv_heads, cfg.hd)
    return q8, k8, v8


#: the reference's threshold (``intlayers.int_attn_fwd``) above which a
#: backend without a fused attention kernel streams the two-pass chunked
#: attention (the contract that routes on it owns it)
FULL_MATRIX_MAX = contracts.FULL_MATRIX_MAX


def int_attn_fwd(qp, x8, plans: qplans.AttnPlan, cfg: ArchConfig,
                 rope_tab=None, positions=None, causal=True, window: int = 0,
                 memory8=None, ops=None, fuse_attention: bool = True):
    """Full-sequence self or cross attention.  x8: (B,S,D) int8 -> (B,S,D)
    int32 at s_res.  ``rope_tab``: integer RoPE tables (rotated at
    ``positions``, default ``0..S-1``); ``causal``/``window``: the mask.
    ``memory8`` (B, Skv, D) int8: cross attention, K and V projected from
    the memory, unmasked (``causal`` is ignored) and never rotated.

    The branches are the reference's, in its order: a backend with a fused
    attention kernel (``cuda``, ``cuda_online``) takes every length;
    otherwise (``cuda_ref`` and ``torch_ref``, the twins of ``ref``, or
    ``fuse_attention=False``) self attention above ``S * Skv =
    FULL_MATRIX_MAX`` (``analysis.contracts.ref_streams_chunked``)
    streams the chunked two-pass
    (``core.attention.i_attention_chunked``, chunks of ``min(1024,
    Skv)``, the KV heads repeated for GQA; it asserts ``S % 1024 == 0``
    as the reference does), and at or below it, and cross attention at
    every length, take the exact full-matrix integers: the backend's own
    ``int_attention`` (K5 on ``cuda_ref``), or K5 where the backend is a
    fused one, which must not be re-entered.  The chunked path is plain
    PyTorch on the operands' device, as the reference's is plain ``jnp``
    outside any kernel."""
    ops = resolve_ops(ops, cfg)
    b, s, _ = x8.shape
    q8, k8, v8 = _qkv(qp, x8, plans, cfg, ops, memory8)
    sk = k8.shape[1]
    cross = memory8 is not None
    causal = causal and not cross
    if rope_tab is not None and not cross:
        pos = positions if positions is not None else torch.arange(
            s, device=x8.device)
        q8 = apply_int_rope(q8, pos, rope_tab)
        k8 = apply_int_rope(k8, pos, rope_tab)
    attn_backend = ops.backend_for("int_attention")
    requant = RequantSpec.per_tensor(plans.attn.dn_out)
    if fuse_attention and attn_backend.fused_attention:
        o8 = ops.int_attention(q8, k8, v8, plans.attn, causal=causal,
                               window=window, requant=requant)
    elif contracts.ref_streams_chunked(s, sk, cross):
        rep = cfg.q_group
        k8r = k8.repeat_interleave(rep, dim=2) if rep > 1 else k8
        v8r = v8.repeat_interleave(rep, dim=2) if rep > 1 else v8
        o8 = i_attention_chunked(q8, k8r, v8r, plans.attn,
                                 chunk=min(1024, sk), causal=causal,
                                 window=window)
    else:
        # exact numerics: never re-enter a fused (possibly online) kernel
        be = get_backend("cuda") if attn_backend.fused_attention \
            else attn_backend
        o8 = be.int_attention(q8, k8, v8, plans.attn, causal=causal,
                              window=window, requant=requant)
    return int_linear(o8.to(torch.int8).reshape(b, s, cfg.n_heads * cfg.hd),
                      qp["wo"], plans.out, ops)


def verify_positions(pos, n_new, s: int):
    """The rows of a speculative verify step: lane ``b``'s ``n_new[b]``
    real tokens sit right-aligned in ``s`` rows, row ``i`` at logical
    position ``pos[b] + n_new[b] - s + i``.  Returns ``(positions,
    real)``, both ``(B, s)``: the positions clamped at 0 for the pad rows
    (a negative index would wrap to the table's last row), and whether
    each row is real."""
    rows = torch.arange(s, device=pos.device)[None, :]
    n = n_new.to(device=pos.device, dtype=torch.long)[:, None]
    rpos = pos.to(torch.long)[:, None] + n - s + rows
    return torch.clamp(rpos, min=0), rows >= s - n


def real_rows(n_new, s: int) -> np.ndarray:
    """Flat indices ``b * s + i`` of the real rows of a verify step (``i >=
    s - n_new[b]``), from ``n_new`` on the host, ascending."""
    n_new = np.asarray(n_new, dtype=np.int64)
    return np.concatenate([b * s + np.arange(s - n, s)
                           for b, n in enumerate(n_new)]).astype(np.int64)


class StepRows(NamedTuple):
    """Where a decode or verify step's rows sit, the same for every layer
    (:func:`step_rows`): ``positions`` (B, S) long for RoPE; ``where``
    the index of the K/V rows written into a layer's cache; ``rows`` the
    flat rows of the step's (B * S) K/V that ``where`` takes, or None for
    all of them; ``valid`` (B,) int32 the live positions of each lane
    that decode attention reads."""
    positions: torch.Tensor
    where: tuple
    rows: Optional[torch.Tensor]
    valid: torch.Tensor


def step_rows(pos, length: int, s: int = 1, n_new=None, write_rows=None,
              pages=None, page_size: int = 0, window: int = 0) -> StepRows:
    """The rows a step writes and the positions it reads, computed once a
    step.  A decode step (``s`` 1) writes logical slot ``pos`` (``pos %
    window`` for a sliding window) and reads ``min(pos + 1, length)``
    positions when windowed or paged, else ``pos + 1``.  A verify step
    (``n_new``) writes its real rows (:func:`verify_positions`) and reads
    ``pos + n_new`` positions (the stepped mask); its pad rows write
    nothing live: paged, the null page 0; contiguous, they are dropped,
    and only the rows ``write_rows`` names (flat ``b * s + i``,
    :func:`real_rows`, built on the host so that nothing waits on the
    card) are written.  Paged, slot ``t`` of lane ``b`` is ``(pages[b, t
    // page_size], t % page_size)``; contiguous, ``(b, t)``."""
    if n_new is None:
        positions = pos.to(torch.long)[:, None]
        valid = torch.clamp(pos + 1, max=length) \
            if window > 0 or pages is not None else pos + 1
    else:
        positions, real = verify_positions(pos, n_new, s)
        valid = pos + n_new.to(pos.dtype)
    valid = valid.to(torch.int32)
    slot = positions % window if window > 0 else positions       # (B, S)
    if pages is not None:
        page = torch.gather(pages.to(torch.long), 1, slot // page_size)
        if n_new is not None:
            page = torch.where(real, page, 0)
        return StepRows(positions, (page, slot % page_size), None, valid)
    if n_new is None:
        lanes = torch.arange(pos.shape[0], device=slot.device)[:, None]
        return StepRows(positions, (lanes, slot), None, valid)
    if write_rows is None:
        raise ValueError("a contiguous verify step needs write_rows (the "
                         "flat real rows, intlayers.real_rows of n_new "
                         "built on the host)")
    rows = write_rows.to(device=slot.device, dtype=torch.long)
    return StepRows(positions, (rows // s, slot.reshape(-1)[rows]), rows,
                    valid)


def _refuse_tp_fold(tp_group, fold_wo: bool) -> None:
    if tp_group is not None and fold_wo:
        raise ValueError("fold_wo cannot cross the tensor-parallel "
                         "all-reduce: the wo requant must round once, "
                         "after psum (pass fold_wo=False under tp)")


def _wo(o8, qw, plan: qplans.LinearPlan, tp_group, ops):
    """The unfolded o-projection: summed over the tensor-parallel group
    when there is one."""
    if tp_group is not None:
        return _tp_wo_project(o8, qw, plan, tp_group, ops)
    return int_linear(o8, qw, plan, ops)


def int_attn_decode(qp, x8, cache, pos, plans: qplans.AttnPlan,
                    cfg: ArchConfig, rope_tab=None, window: int = 0,
                    ops=None, pages=None, page_size: int = 0,
                    max_len: int = 0, fold_wo: bool = False, rope=None,
                    n_new=None, writes=None, tp_group=None):
    """One-token decode.  x8: (B,1,D); cache ``{"k8","v8"}``, written in
    place; ``pos``: (B,) position of each lane's token, written at
    logical slot ``pos``, or ``pos % window`` for a sliding window (the
    rolling buffer).

    Cache layouts: contiguous ``(B, L, Hkv, hd)`` by default, slot ``s``
    of lane ``b`` at ``cache[b, s]``; with ``pages`` (int32 ``(B,
    max_pages)``) a physical pool ``(num_pages, page_size, Hkv, hd)``,
    slot ``s`` at ``(pages[b, s // page_size], s % page_size)`` —
    unmapped lanes write into the reserved null page 0.  ``max_len``
    bounds the paged occupancy (default: the page-table span).  Live
    positions: ``min(pos + 1, L)`` when windowed or paged, else ``pos +
    1`` (:func:`step_rows`).  ``rope``: cos/sin already gathered for the
    rows' positions (:func:`rope_gather`), else gathered here from
    ``rope_tab``; ``writes``: the step's :func:`step_rows`, else built
    here.

    ``n_new`` (B,): the speculative verify step (full causal attention
    only).  x8 is then (B, S, D) with each lane's real tokens
    right-aligned (:func:`verify_positions`); ``valid_len = pos + n_new``
    gives row ``i`` the stepped mask of positions ``<= pos + n_new - S +
    i``, what a one-token decode of the same tokens would see (K3 at Sq
    = S).  Pad rows write nothing live (:func:`step_rows`); the
    contiguous layout takes ``writes`` built with the host's
    ``write_rows``.  Precondition (the engine's): ``pos + n_new <= L``.

    ``tp_group``: tensor-parallel serving over that process group:
    ``cfg`` has the rank's local heads (``distributed.tp_serving.
    local_cfg``), ``qp`` its shard, and the o-projection is a partial
    product summed over the group before its one requant
    (:func:`_tp_wo_project`); ``fold_wo`` must be off (a folded epilogue
    would requant each rank's partial).  Returns (out32 (B,S,D), cache)."""
    _refuse_tp_fold(tp_group, fold_wo)
    ops = resolve_ops(ops)
    b, s = x8.shape[:2]
    paged = pages is not None
    packed_kv = "k_shift" in cache
    if packed_kv and not paged:
        raise ValueError("int4 KV pages (k_shift/v_shift in the cache) "
                         "need the paged layout")
    if n_new is not None and window > 0:
        raise ValueError("speculative verify needs full causal attention "
                         "(window == 0)")
    if writes is None:
        L = (max_len or pages.shape[1] * page_size) if paged \
            else cache["k8"].shape[1]
        writes = step_rows(pos, L, s, n_new, pages=pages,
                           page_size=page_size, window=window)
    q8, k8, v8 = _qkv(qp, x8, plans, cfg, ops)
    if rope is None and rope_tab is not None:
        rope = rope_gather(rope_tab, writes.positions)
    if rope is not None:
        q8 = rope_rotate(q8, *rope)
        k8 = rope_rotate(k8, *rope)
    k_w, v_w = k8, v8
    if packed_kv:
        k_w, v_w = pack_kv(k_w), pack_kv(v_w)
    if writes.rows is not None:
        k_w = k_w.reshape(b * s, *k_w.shape[2:])[writes.rows]
        v_w = v_w.reshape(b * s, *v_w.shape[2:])[writes.rows]
    cache["k8"].index_put_(writes.where, k_w)
    cache["v8"].index_put_(writes.where, v_w)
    kv = dict(pages=pages, page_size=page_size) if paged else {}
    if packed_kv:
        kv.update(kv_shifts=(cache["k_shift"], cache["v_shift"]))
    requant = RequantSpec.per_tensor(plans.attn.dn_out)
    if fold_wo:
        out32 = ops.int_decode_attention(
            q8, cache["k8"], cache["v8"], plans.attn, writes.valid,
            requant=requant, wo=QuantLinearParams.of(qp["wo"]),
            wo_spec=RequantSpec.for_linear(plans.out), **kv)
    else:
        o8 = ops.int_decode_attention(
            q8, cache["k8"], cache["v8"], plans.attn, writes.valid,
            requant=requant, **kv)
        o8 = o8.to(torch.int8).reshape(b, s, cfg.n_heads * cfg.hd)
        out32 = _wo(o8, qp["wo"], plans.out, tp_group, ops)
    return out32, cache


def int_attn_prefill_chunk(qp, x8, cache, base_pos, plans: qplans.AttnPlan,
                           cfg: ArchConfig, rope_tab=None, ops=None,
                           pages=None, page_size: int = 0,
                           fold_wo: bool = False, rope=None,
                           tp_group=None):
    """Chunked prefill attention over a paged pool.  x8: (B, C, D), lane
    ``b`` covering logical positions ``[base_pos[b], base_pos[b] + C)``.
    Writes the chunk's K/V through the table (in place; packed int4 pools,
    ``k_shift``/``v_shift`` in the cache, take them quantized and packed
    by the dispatch layer) and runs causal attention over history +
    chunk.  ``rope``: cos/sin already gathered for those positions.
    ``tp_group``: tensor-parallel serving, as in :func:`int_attn_decode`.
    Returns (out32 (B, C, D), cache)."""
    if cfg.window:
        raise NotImplementedError("chunked prefill needs full causal "
                                  "attention")
    _refuse_tp_fold(tp_group, fold_wo)
    ops = resolve_ops(ops)
    b, c, _ = x8.shape
    q8, k8, v8 = _qkv(qp, x8, plans, cfg, ops)
    if rope is None and rope_tab is not None:
        positions = base_pos[:, None] + torch.arange(
            c, dtype=base_pos.dtype, device=base_pos.device)
        rope = rope_gather(rope_tab, positions)
    if rope is not None:
        q8 = rope_rotate(q8, *rope)
        k8 = rope_rotate(k8, *rope)
    requant = RequantSpec.per_tensor(plans.attn.dn_out)
    kw = {}
    if "k_shift" in cache:
        kw.update(kv_shifts=(cache["k_shift"], cache["v_shift"]))
    if fold_wo:
        out32, k_pool, v_pool = ops.int_paged_prefill(
            q8, k8, v8, cache["k8"], cache["v8"], plans.attn, base_pos,
            pages, page_size, requant=requant,
            wo=QuantLinearParams.of(qp["wo"]),
            wo_spec=RequantSpec.for_linear(plans.out), **kw)
    else:
        o8, k_pool, v_pool = ops.int_paged_prefill(
            q8, k8, v8, cache["k8"], cache["v8"], plans.attn, base_pos,
            pages, page_size, requant=requant, **kw)
        o8 = o8.to(torch.int8).reshape(b, c, cfg.n_heads * cfg.hd)
        out32 = _wo(o8, qp["wo"], plans.out, tp_group, ops)
    return out32, {"k8": k_pool, "v8": v_pool}


# --------------------------------------------------------------- ffn ------

def int_ffn_fwd(qp, x8, plans: qplans.FfnPlan, cfg: ArchConfig, ops=None):
    """SwiGLU or GELU FFN.  x8 (B,S,D) int8 -> int32 at s_res.  The i-SiLU
    gate and the gate product are plain tensor code; i-GELU is the
    ``int_gelu`` op (K6 on the ``cuda`` backend)."""
    ops = resolve_ops(ops)
    h1 = int_linear(x8, qp["w1"], plans.up, ops)            # 11-bit int32
    if cfg.activation == "swiglu":
        h3 = int_linear(x8, qp["w3"], plans.up, ops)
        a8 = iact.i_silu(h1, plans.act_silu, out_bits=8)
        prod = a8 * h3                                      # s8 * s10
        h = clip_to_bits(plans.dn_gate(prod), 8).to(torch.int8)
    else:
        a = ops.int_gelu(h1, plans.act_gelu.gelu, plans.act_gelu.dn_out,
                         out_bits=8)
        h = a.to(torch.int8)
    return int_linear(h, qp["w2"], plans.down, ops)


# --------------------------------------------------------------- moe ------

class MoeRoute(NamedTuple):
    """One routing of :func:`moe_route`, per (group, token, slot):
    ``expert_ids`` (long) the slot's expert, in ``jax.lax.top_k``'s order;
    ``gates8`` int8 at 2^-7, the i-softmax over the k selected logits;
    ``pos`` (int32) the token's place among its expert's assignments in
    its group, counted slot after slot; ``keep`` ``pos < cap``.  ``kept``
    (G, E) int32: the assignments each (group, expert) keeps."""
    expert_ids: torch.Tensor
    gates8: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    kept: torch.Tensor


def moe_capacity(cfg: ArchConfig, tg: int) -> int:
    """Places an expert has in a group of ``tg`` tokens, counted over the
    *padded* experts, as the reference counts them."""
    return max(4, int(cfg.capacity_factor * tg * cfg.top_k
                      / cfg.padded_experts()))


def moe_route(logits, plans: qplans.MoePlan, cfg: ArchConfig,
              cap: int) -> MoeRoute:
    """The reference's routing of int32 router logits (G, T, E): padding
    experts at ``-(2**30)``, the top k, i-softmax gates over the k
    logits, and the capacity positions.  The top k are the first k of a
    stable descending sort: ``jax.lax.top_k`` puts the lower index first
    among equal logits, ``torch.topk`` need not, and the slot order
    decides the positions and which gate goes with which expert.

    The reference counts positions slot after slot (``pos = counts +
    cumsum(a) - a`` over the tokens of one slot, ``counts`` the
    assignments of the earlier slots): a (token, slot)'s place is the
    number of assignments to its expert before it in slot-major order.
    That is one running count over the k * T assignments, taken here
    along the last axis of an (G, E, k * T) one-hot.  Nothing is read
    back to the host."""
    e, k = cfg.padded_experts(), cfg.top_k
    g, t = logits.shape[:2]
    experts = torch.arange(e, device=logits.device)
    if e != cfg.n_experts:
        logits = torch.where(experts >= cfg.n_experts,
                             torch.full_like(logits, ism.NEG), logits)
    ids = torch.sort(logits, dim=-1, descending=True,
                     stable=True).indices[..., :k]
    gates8 = ism.i_softmax(torch.gather(logits, -1, ids), plans.gate_sm)
    order = ids.transpose(1, 2).reshape(g, 1, k * t)          # slot-major
    seen = torch.cumsum((order == experts[:, None]).to(torch.int32),
                        dim=-1, dtype=torch.int32)           # (G, E, k*T)
    pos = (torch.gather(seen, 1, order) - 1).reshape(g, k, t
                                                     ).transpose(1, 2)
    return MoeRoute(ids, gates8, pos, pos < cap,
                    torch.clamp(seen[..., -1], max=cap))


def _expert_linear(x8, qw, rows, plan: qplans.LinearPlan, ops):
    """The experts' products (E, R, K) -> (E, R, N), K1's grouped
    instantiation on ``cuda``: the reference's ``int_expert_linear``."""
    out = ops.int8_matmul_grouped(x8, qw.w8, rows,
                                  RequantSpec.for_linear(plan),
                                  bias32=qw.bias32, b_vec=qw.b_mult)
    return out.to(torch.int8) if plan.out_bits <= 8 else out


def int_moe_fwd(qp, x8, plans: qplans.MoePlan, cfg: ArchConfig, ops=None,
                group_size: int = 512):
    """Integer MoE: x8 (B, S, D) int8 -> int32 at s_res, the reference's
    integers.  Int32 router logits (K1, raw) over ``g = max(1, S //
    group_size)`` groups of ``S // g`` tokens, the routing of
    :func:`moe_route` with :func:`moe_capacity` places an expert, the
    expert FFNs, the combine ``sum_slot rshift_round(y * gate,
    PROB_SHIFT)``, plus the shared experts' FFN.

    Each (group, expert, place) holds at most one token, so the
    reference's one-hot dispatch and combine einsums are selections here:
    expert e's kept tokens are packed into the first ``rows[e]`` rows of
    its (G * cap) rows, group after group, and every linear of the
    experts is one :func:`_expert_linear` (one launch for all experts).
    A dropped (token, slot) adds ``rshift_round(0 * gate, 7) = 0``.  The
    shapes depend on B, S, E, k and cap only, and nothing is read back to
    the host.  Prefill routes groups of ``group_size`` = 512 tokens
    (capacity drops tokens); decode and verify ``group_size = 1`` (never
    drops)."""
    ops = resolve_ops(ops, cfg)
    w1, w2 = QuantLinearParams.of(qp["w1"]), QuantLinearParams.of(qp["w2"])
    w3 = QuantLinearParams.of(qp["w3"]) if "w3" in qp else None
    if any(q is not None and q.is_packed for q in (w1, w2, w3)):
        raise ValueError("packed expert weights are out of scope: the "
                         "reference's int_expert_linear reads dense w8")
    b, s, d = x8.shape
    e = cfg.padded_experts()
    k = cfg.top_k
    g = max(1, s // group_size)
    tg = s // g          # g * tg < s: the reshape fails, as the reference's
    cap = moe_capacity(cfg, tg)
    xg = x8.reshape(b * g, tg, d)
    groups = b * g
    logits = int_linear(xg, qp["router"], plans.router, ops)     # int32
    route = moe_route(logits, plans, cfg, cap)

    # kept (group, token, slot) -> row of expert e's packed rows
    r = groups * cap
    rows = route.kept.sum(dim=0).to(torch.int32)                  # (E,)
    off = torch.cumsum(route.kept, dim=0) - route.kept            # (G, E)
    place = torch.gather(off, 1, route.expert_ids.reshape(groups, -1)
                         ).reshape(route.pos.shape) + route.pos
    flat = torch.where(route.keep, route.expert_ids * r + place,
                       torch.full_like(place, e * r))             # e*r: drop
    buf = torch.zeros((e * r + 1, d), dtype=torch.int8, device=x8.device)
    buf[flat.reshape(-1)] = xg[:, :, None, :].expand(groups, tg, k, d
                                                     ).reshape(-1, d)
    xe = buf[:e * r].view(e, r, d)

    h1 = _expert_linear(xe, w1, rows, plans.expert.up, ops)
    if cfg.activation == "swiglu":
        h3 = _expert_linear(xe, w3, rows, plans.expert.up, ops)
        a8 = iact.i_silu(h1, plans.expert.act_silu, out_bits=8)
        h = clip_to_bits(plans.expert.dn_gate(a8 * h3), 8).to(torch.int8)
    else:
        h = ops.int_gelu(h1, plans.expert.act_gelu.gelu,
                         plans.expert.act_gelu.dn_out,
                         out_bits=8).to(torch.int8)
    y = _expert_linear(h, w2, rows, plans.expert.down, ops)      # s_res
    yf = y.reshape(e * r, d)

    y_all = torch.where(route.keep[..., None],
                        yf[torch.where(route.keep, flat, 0)], 0)  # (G,T,k,D)
    gated = rshift_round(y_all * route.gates8[..., None].to(torch.int32),
                         ism.PROB_SHIFT)
    out32 = gated.sum(dim=2, dtype=torch.int32).reshape(b, s, d)
    if plans.shared is not None:
        out32 = out32 + int_ffn_fwd(qp["shared"], x8, plans.shared, cfg,
                                    ops)
    return out32


# -------------------------------------------------------------- mamba -----

class IntMambaState(NamedTuple):
    h: torch.Tensor        # (B, H, N, P) int32 at s_h
    conv: torch.Tensor     # (B, K-1, C) int8


def init_int_mamba_state(cfg: ArchConfig, batch: int,
                         device=DEFAULT_DEVICE) -> IntMambaState:
    """A zero state for ``batch`` lanes, on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    h = torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                    dtype=torch.int32, device=dev)
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv = torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=torch.int8,
                       device=dev)
    return IntMambaState(h, conv)


def _INT32_PLAN(mp: qplans.MambaPlan) -> qplans.LinearPlan:
    """The Δt projection keeps the raw int32 accumulator (its requant
    comes after the dt_bias add): K1's raw epilogue."""
    return qplans.LinearPlan(mp.in_proj.s_in, 0.0, 32, 0, 0,
                             mp.in_proj.k_dim)


def _int_conv_step(xbc8_t, conv_state, qconv_w8, mp: qplans.MambaPlan):
    """Depthwise causal conv, one step.  xbc8_t: (B, C) int8 ->
    (out8 (B, C) int8, the new tail (B, K-1, C))."""
    window = torch.cat([conv_state, xbc8_t[:, None, :]], dim=1)
    acc = (window.to(torch.int32) * qconv_w8.to(torch.int32)[None]).sum(
        dim=1, dtype=torch.int32)
    h10 = clip_to_bits(mp.dn_conv(acc), 11)
    out8 = iact.i_silu(h10, mp.silu_conv, out_bits=8).to(torch.int8)
    return out8, window[:, 1:]


def _silu16(zq, plan: iact.ISiluPlan):
    """sigmoid(z) as a 2^-15 fraction (int32), z int32 at plan.s_in."""
    q = zq.to(torch.int32)
    e = intmath.i_exp(-torch.abs(q), plan.iexp)
    e16 = torch.clamp(plan.dn_e16(e), 0, 1 << 15)
    one16 = torch.full_like(e16, 1 << 15)
    den = one16 + e16
    r = torch.div(torch.full_like(den, 1 << 30), den, rounding_mode="floor")
    num = torch.where(q >= 0, one16, e16)
    return (num * r) >> 15


def _round_shift(x, sd):
    """``(x + half) >> sd`` with ``half = 1 << (sd - 1)`` where ``sd > 0``,
    else 0 (``(1 << sd) >> 1``): the rounded arithmetic shift of a
    block-floating-point exponent ``sd`` (a tensor, ``0 <= sd < 31``,
    that broadcasts against ``x``)."""
    return (x + ((1 << sd) >> 1)) >> sd


def _ssd_readout(h, c8, x8, d_q, mp: qplans.MambaPlan):
    """The read-out of one token from the state ``h`` (B, H, N, P): h as
    int8 on one block-floating-point exponent a lane (shared across the
    heads, so the RMSNorm after cancels it), ``y = C . h8`` over the
    state (``int_einsum``: exact float64 on the card) plus ``D * x`` on
    the same shifted grid.  c8 (B, H or 1, N), x8 (B, H, P) int8 ->
    int32 (B, H, P)."""
    h_max = torch.abs(h).amax(dim=(1, 2, 3), keepdim=True)
    sd = torch.clamp(intmath.int_bit_length(h_max) - 7, min=0)   # (B,1,1,1)
    h8 = torch.clamp(_round_shift(h, sd), -127, 127)
    y = intmath.int_einsum("bhn,bhnp->bhp", c8.expand(h.shape[:3]), h8)
    # D*x on the same (shifted) h grid: D_q at 2^-16, >> sd
    return y + ((d_q[None, :, None] * x8.to(torch.int32)) >> sd[:, :, 0])


def _gate_norm_out(qp, y32, z8, mp: qplans.MambaPlan, ops):
    """y * sigmoid(z), then a per-row block-floating-point shift to <= 12
    bits into the RMSNorm over d_inner (K2 on the ``cuda`` backend; the
    norm is scale-invariant, so the row shift cancels), then out_proj
    (K1) -> int32 at s_res."""
    sig16 = _silu16(mp.dn_z10(z8.to(torch.int32)), mp.silu_z)
    gated = ism.rescale_sum(y32, sig16)          # y * sigmoid(z), int32
    row_max = torch.abs(gated).amax(dim=-1, keepdim=True)
    s_dyn = torch.clamp(intmath.int_bit_length(row_max) - 11, min=0)
    y12 = _round_shift(gated, s_dyn)
    y8 = int_norm({"gamma_q": qp["norm_gamma_q"]}, y12, mp.norm, ops)
    return int_linear(y8, qp["out_proj"], mp.out_proj, ops)


def _dt_decay(dt_acc, qp, mp: qplans.MambaPlan):
    """Δt and the decay from the raw Δt accumulator (..., H): Δt =
    i-softplus(dt_acc + dt_bias) at s_dt (13 bits), decay = i-exp(-Δt *
    A) as a 2^-15 fraction.  Returns (dt, decay16), both int32."""
    dt_in = clip_to_bits(mp.dn_dt_in(dt_acc + qp["dt_bias_q"]), 11)
    dt = iact.i_softplus(dt_in, mp.softplus, out_bits=13)
    dtA = mp.dn_dtA(dt * qp["A_q"])                          # -> 2^-14
    decay16 = torch.clamp(mp.dn_decay16(intmath.i_exp(-dtA,
                                                      mp.iexp_decay)),
                          0, 1 << 15)
    return dt, decay16


def _split_xbc(xbc8, cfg: ArchConfig):
    """x (..., H, P), B and C (..., G, N) of the conv's output."""
    di, gq, n = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state
    lead = xbc8.shape[:-1]
    x8 = xbc8[..., :di].reshape(*lead, cfg.ssm_heads, cfg.ssm_head_dim)
    b8 = xbc8[..., di:di + gq * n].reshape(*lead, gq, n)
    c8 = xbc8[..., di + gq * n:].reshape(*lead, gq, n)
    return x8, b8, c8


def _per_head(t, cfg: ArchConfig, dim: int):
    """A group's B or C for each of its heads (``jnp.repeat`` over the
    groups); one group broadcasts as it is."""
    rep = cfg.ssm_heads // cfg.ssm_groups
    return t.repeat_interleave(rep, dim=dim) if cfg.ssm_groups > 1 else t


def int_mamba_step(qp, u8_t, state: IntMambaState, mp: qplans.MambaPlan,
                   cfg: ArchConfig, ops=None):
    """One token.  u8_t: (B, D) int8 -> (out32 (B, D) at s_res, the new
    state).  in_proj and out_proj are K1 launches, the Δt projection K1's
    raw epilogue, the gated norm K2; the conv, Δt, the decay and the
    state update are plain tensor code, as the reference's are plain
    ``jnp``."""
    ops = resolve_ops(ops, cfg)
    b = u8_t.shape[0]
    di = cfg.ssm_d_inner
    zxbc8 = int_linear(u8_t, qp["in_proj"], mp.in_proj, ops)
    dt_acc = int_linear(u8_t, qp["dt_proj"], _INT32_PLAN(mp), ops)
    z8, xbc8 = zxbc8[:, :di], zxbc8[:, di:]
    xbc8, conv_new = _int_conv_step(xbc8, state.conv, qp["conv_w8"], mp)
    x8, b8, c8 = _split_xbc(xbc8, cfg)
    dt, decay16 = _dt_decay(dt_acc, qp, mp)                  # (B, H)
    # contribution dt * B * x (s_dt * s_xbc * s_xbc) -> s_h
    b8h = _per_head(b8, cfg, 1)
    contrib = mp.dn_h(dt[:, :, None, None] * (
        b8h[:, :, :, None].to(torch.int32) * x8[:, :, None, :].to(
            torch.int32)))
    h = ism.rescale_sum(state.h, decay16[:, :, None, None]) + contrib
    h = torch.clamp(h, -mp.qmax_h, mp.qmax_h)
    y = _ssd_readout(h, _per_head(c8, cfg, 1), x8, qp["D_q"], mp)
    out32 = _gate_norm_out(qp, y.reshape(b, di), z8, mp, ops)
    return out32, IntMambaState(h, conv_new)


def _rshift_round_(x, s: int):
    """:func:`rshift_round` in place on an int32 tensor the caller owns."""
    if s > 0:
        return x.add_(1 << (s - 1)).bitwise_right_shift_(s)
    return x.bitwise_left_shift_(-s) if s < 0 else x


def _dyadic_(q, dn: Dyadic):
    """``dn(q)`` in place (the same three stages as
    :func:`core.dyadic.apply_dyadic`)."""
    _rshift_round_(q, dn.pre)
    q.mul_(dn.b)
    return _rshift_round_(q, dn.c - dn.pre)


def int_mamba_prefill(qp, u8, mp: qplans.MambaPlan, cfg: ArchConfig,
                      state: Optional[IntMambaState] = None, ops=None):
    """Integer prefill with the token-parallel stages hoisted out of the
    recurrence (the reference's): the projections (K1), the conv, Δt, the
    decays and the contributions over the whole sequence, then L
    sequential state updates and read-outs, then the gate, the norm (K2)
    and out_proj (K1) over the sequence.  u8: (B, L, D) int8; ``state``
    the carried-in state (default zero).  Returns (out32 (B, L, D) at
    s_res, the state after the last token).

    The contributions are one (B, L, H, N, P) int32 tensor (4 x 512 at
    mamba2-130m's widths: 1.61 GB), built in place so that no second
    copy of it exists."""
    ops = resolve_ops(ops, cfg)
    b, l, _ = u8.shape
    di = cfg.ssm_d_inner
    if state is None:
        state = init_int_mamba_state(cfg, b, u8.device)
    zxbc8 = int_linear(u8, qp["in_proj"], mp.in_proj, ops)        # (B,L,*)
    dt_acc = int_linear(u8, qp["dt_proj"], _INT32_PLAN(mp), ops)
    z8, xbc8 = zxbc8[..., :di], zxbc8[..., di:]
    # causal depthwise conv over the sequence, seeded by the carried tail
    km1 = state.conv.shape[1]
    full = torch.cat([state.conv, xbc8], dim=1)
    w = qp["conv_w8"].to(torch.int32)
    acc = sum(full[:, i:i + l].to(torch.int32) * w[i]
              for i in range(km1 + 1))
    conv_tail = full[:, -km1:]
    h10 = clip_to_bits(mp.dn_conv(acc), 11)
    xbc8a = iact.i_silu(h10, mp.silu_conv, out_bits=8).to(torch.int8)
    x8, b8, c8 = _split_xbc(xbc8a, cfg)
    dt, decay16 = _dt_decay(dt_acc, qp, mp)                      # (B,L,H)
    contrib = _per_head(b8, cfg, 2)[..., :, None].to(torch.int32) \
        * x8[..., None, :].to(torch.int32)                       # (B,L,H,N,P)
    _dyadic_(contrib.mul_(dt[..., None, None]), mp.dn_h)
    c8h = _per_head(c8, cfg, 2)

    # the sequential state recurrence + read-out
    h = state.h
    y32 = torch.empty((b, l, cfg.ssm_heads, cfg.ssm_head_dim),
                      dtype=torch.int32, device=u8.device)
    for t in range(l):
        h = ism.rescale_sum(h, decay16[:, t, :, None, None]) + contrib[:, t]
        h = torch.clamp(h, -mp.qmax_h, mp.qmax_h)
        y32[:, t] = _ssd_readout(h, c8h[:, t], x8[:, t], qp["D_q"], mp)
    del contrib
    out32 = _gate_norm_out(qp, y32.reshape(b, l, di), z8, mp, ops)
    return out32, IntMambaState(h, conv_tail)
