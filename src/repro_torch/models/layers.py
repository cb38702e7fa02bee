"""Float-path transformer layers with optional fake-quant (QAT) (twin of
``repro.models.layers``): the init of every sublayer (the random float
model the serving driver quantizes) and the float / QAT forwards the
training step differentiates.

Draws come from an explicit ``torch.Generator``; they are not the JAX
package's draws (tests carry JAX's float params across instead).

Under QAT every tensor the accelerator sees in INT8 / INT10 is
fake-quantized with a straight-through gradient, as in the reference.
``attn_fwd`` and ``ffn_fwd`` take their inputs through
``distributed.sharding.comm_quant_gather`` (the int8 transport of the
sequence-parallel gather): under any mesh, a ``(1, 1)`` one included, it
puts them on the int8 grid, as the reference's does; without a mesh it
is the identity, even under QAT.  ``moe_fwd`` and ``mamba_fwd``
fake-quantize theirs through :func:`maybe_fq`.

Under a mesh of more than one rank (``launch.mesh``) each layer takes
the rank's block of the residual stream — its batch rows, and its
sequence block over ``model`` where ``seq_len`` (the whole length) is
given — and returns the same block.  Attention (self and cross) and the
dense FFN are tensor-parallel when their weights hold the rank's heads
/ ``d_ff`` columns (column-parallel ``wq`` / ``wk`` / ``wv`` / ``w1`` /
``w3``, row-parallel ``wo`` / ``w2`` whose partial sums are
reduce-scattered into the residual's block, the per-channel absmax of
``wo`` / ``w2`` reduced over ``model``); the MoE and Mamba gather the
whole sequence and run whole on every model rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quant import fake_quant, per_channel_absmax
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import current_mesh, data_axes
from repro_torch.models.common import ArchConfig, apply_rope


def _init(gen: torch.Generator, shape, dtype, scale: float = 1.0):
    """Normal(0, scale / sqrt(fan_in)) with fan_in = shape[0]."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)


def init_norm(cfg: ArchConfig, dtype, device):
    p = {"gamma": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["beta"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def init_attn(gen, cfg: ArchConfig, dtype):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": _init(gen, (d, cfg.n_heads, hd), dtype),
        "wk": _init(gen, (d, cfg.n_kv_heads, hd), dtype),
        "wv": _init(gen, (d, cfg.n_kv_heads, hd), dtype),
        "wo": _init(gen, (cfg.n_heads, hd, d), dtype),
    }
    if cfg.attn_bias:
        dev = gen.device
        p["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
    return p


def init_ffn(gen, cfg: ArchConfig, dtype, d_ff: Optional[int] = None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    p = {"w1": _init(gen, (d, f), dtype),
         "w2": _init(gen, (f, d), dtype)}
    if cfg.activation == "swiglu":
        p["w3"] = _init(gen, (d, f), dtype)
    else:
        p["b1"] = torch.zeros((f,), dtype=dtype, device=gen.device)
        p["b2"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    return p


def init_moe(gen, cfg: ArchConfig, dtype):
    """The router (D, E), the experts' w1 / w3 (E, D, F) and w2 (E, F, D)
    over the padded expert count E, and the shared experts' FFN, drawn
    in the reference's order."""
    d = cfg.d_model
    e = cfg.padded_experts()
    f = cfg.moe_d_ff or cfg.d_ff
    p = {"router": _init(gen, (d, e), dtype),
         "w1": _init(gen, (e, d, f), dtype),
         "w2": _init(gen, (e, f, d), dtype)}
    if cfg.activation == "swiglu":
        p["w3"] = _init(gen, (e, d, f), dtype)
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(gen, cfg, dtype,
                               d_ff=f * cfg.n_shared_experts)
    return p


# ------------------------------------------------------------- helpers ----

def maybe_fq(x, scale, bits=8, enabled=False):
    return fake_quant(x, scale, bits) if enabled else x


def fq_weight(w, axis=-1, enabled=False, max_over=None):
    """Per-out-channel fake quant (axis = out-channel dim).  ``max_over``:
    the mesh axis a reduced dim of ``w`` is sharded over (a row-parallel
    weight): the absmax is then all-reduced (MAX) over it, so every rank
    quantizes on the whole weight's grid."""
    if not enabled:
        return w
    amax = per_channel_absmax(w, axis)
    if max_over is not None:
        amax = sh.all_reduce_max_(amax.detach().clone(), max_over)
    s = torch.clamp(amax, min=1e-6) / 127.0
    shape = [1] * w.dim()
    shape[axis] = -1
    return fake_quant(w, s.reshape(shape), 8)


def norm_fwd(p, x, cfg: ArchConfig, eps: float = 1e-6):
    """LayerNorm / RMSNorm: the row statistics in float32, the (B, S, D)
    tensor in the input dtype, as the reference computes them."""
    stats_in = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = torch.mean(stats_in, -1, keepdim=True)
        var = torch.var(stats_in, -1, unbiased=False, keepdim=True)
        inv = (1.0 / torch.sqrt(var + eps)).to(x.dtype)
        out = (x - mu.to(x.dtype)) * inv * p["gamma"] + p["beta"]
    else:
        rms = torch.sqrt(torch.mean(stats_in * stats_in, -1, keepdim=True)
                         + eps)
        out = x * (1.0 / rms).to(x.dtype) * p["gamma"]
    return out.to(x.dtype)


def _linear(x, w):
    """``x`` (..., K) times ``w`` (K, ...): the reference's einsums over
    one contracted axis (``bsd,dhk->bshk``, ``bsf,fd->bsd``, ...)."""
    k = x.shape[-1]
    return (x @ w.reshape(k, -1)).reshape(*x.shape[:-1], *w.shape[1:])


# ----------------------------------------------------------- attention ----

def _repeat_kv(k, group: int):
    return torch.repeat_interleave(k, group, dim=2) if group > 1 else k


def attn_fwd(p, x, cfg: ArchConfig, positions=None, causal=True,
             window: int = 0, memory=None, qat=False, q_chunk: int = 1024,
             seq_len=None):
    """Self- or cross-attention. x: (B,S,D); memory: (B,Sm,D) for cross.

    The query rows run in chunks of at most ``q_chunk`` (the largest
    divisor of S not above it); with more than one chunk, each chunk is
    recomputed in the backward (``torch.utils.checkpoint``) instead of
    keeping every chunk's (B, H, qc, Sk) scores, as the reference's
    per-chunk ``jax.remat``.  The scores are float32 (the reference's
    ``preferred_element_type``), the probabilities in ``x``'s dtype.

    Under a mesh, ``x`` is the rank's sequence block when ``seq_len`` is
    given (gathered at the input, its output reduce-scattered back), and
    ``wq`` holding fewer than ``n_heads`` heads makes the layer
    tensor-parallel: the rank's query heads, their kv heads (``wk`` /
    ``wv`` sharded alike, or whole where ``n_kv_heads`` does not divide,
    the rank then taking the kv heads of its query heads), and ``wo``'s
    rows of them; ``memory`` is whole."""
    b, d = x.shape[0], x.shape[-1]
    xq = sh.comm_quant_gather(x, cfg.s_act8, True, seq_len) if qat \
        else sh.gather_seq(x, seq_len)
    s = xq.shape[1]
    if memory is None:
        kq = xq
    else:
        kq = sh.comm_quant_gather(memory, cfg.s_act8, enabled=qat)
    sk = kq.shape[1]
    hl = p["wq"].shape[1]
    tp = hl < cfg.n_heads
    q = _linear(xq, fq_weight(p["wq"], 1, qat))
    k = _linear(kq, fq_weight(p["wk"], 1, qat))
    v = _linear(kq, fq_weight(p["wv"], 1, qat))
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.pos == "rope" and memory is None and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if tp and k.shape[2] == cfg.n_kv_heads:
        # kv heads replicated: the kv head of each of the rank's heads
        h0 = current_mesh().index("model") * hl
        kv_of = torch.div(torch.arange(h0, h0 + hl, device=x.device),
                          cfg.q_group, rounding_mode="floor")
        k, v = k.index_select(2, kv_of), v.index_select(2, kv_of)
    else:
        k = _repeat_kv(k, cfg.q_group)
        v = _repeat_kv(v, cfg.q_group)

    scale = 1.0 / math.sqrt(cfg.hd)
    qc = min(q_chunk, s)
    while s % qc:
        qc -= 1
    n_chunks = s // qc
    kf = k.to(torch.float32)

    def one_chunk(qi: int, q_blk):
        sc = torch.einsum("bqhk,bthk->bhqt", q_blk.to(torch.float32),
                          kf) * scale
        if causal or window > 0:
            rows = qi * qc + torch.arange(qc, device=x.device)[:, None]
            cols = torch.arange(sk, device=x.device)[None, :]
            m = torch.ones((qc, sk), dtype=torch.bool, device=x.device)
            if causal:
                m = m & (cols <= rows)
            if window > 0:
                m = m & (cols > rows - window)
            sc = torch.where(m[None, None], sc, -1e30)
        pr = torch.softmax(sc, dim=-1).to(x.dtype)
        pr = maybe_fq(pr, 1.0 / 127.0, enabled=qat)   # int8 prob grid
        return torch.einsum("bhqt,bthk->bqhk", pr, v)

    if n_chunks == 1:
        o = one_chunk(0, q)
    else:
        o = torch.cat([checkpoint(one_chunk, i, q[:, i * qc:(i + 1) * qc],
                                  use_reentrant=False)
                       for i in range(n_chunks)], dim=1)
    o = maybe_fq(o, cfg.s_act8, enabled=qat)
    wo = fq_weight(p["wo"], 2, qat, max_over="model" if tp else None)
    if not tp:
        return sh.scatter_seq(o.reshape(b, s, -1) @ wo.reshape(-1, d),
                              seq_len, partial=False)
    out = sh.partial_matmul(o.reshape(b, s, -1), wo.reshape(-1, d))
    return sh.scatter_seq(out, seq_len, partial=True, dtype=x.dtype)


# ----------------------------------------------------------------- ffn ----

def ffn_fwd(p, x, cfg: ArchConfig, qat=False, seq_len=None, d_ff=None):
    """SwiGLU (w1, w3, w2) or GELU (exact erf) with biases b1 / b2; the
    pre-activations on the 10-bit grid and the hidden on the int8 grid
    under QAT.  The input goes through ``comm_quant_gather`` under QAT.
    Under a mesh, ``w1`` holding fewer columns than ``d_ff`` (default
    ``cfg.d_ff``) makes it tensor-parallel: the rank's ``d_ff`` columns
    of w1 / w3 / b1 and rows of w2, the partial sums reduce-scattered
    into the residual's block (``seq_len``: as ``attn_fwd``), then b2."""
    xq = sh.comm_quant_gather(x, cfg.s_act8, True, seq_len) if qat \
        else sh.gather_seq(x, seq_len)
    tp = p["w1"].shape[-1] < (cfg.d_ff if d_ff is None else d_ff)
    if cfg.activation == "swiglu":
        h1 = xq @ fq_weight(p["w1"], 1, qat)
        h3 = xq @ fq_weight(p["w3"], 1, qat)
        h1 = maybe_fq(h1, cfg.s_act10, bits=10, enabled=qat)
        h3 = maybe_fq(h3, cfg.s_act10, bits=10, enabled=qat)
        h = F.silu(h1) * h3
    else:
        h1 = xq @ fq_weight(p["w1"], 1, qat)
        h1 = h1 + p["b1"]
        h1 = maybe_fq(h1, cfg.s_act10, bits=10, enabled=qat)
        h = F.gelu(h1, approximate="none")
    h = maybe_fq(h, cfg.s_act8, enabled=qat)
    w2 = fq_weight(p["w2"], 1, qat, max_over="model" if tp else None)
    if tp:
        out = sh.scatter_seq(sh.partial_matmul(h, w2), seq_len,
                             partial=True, dtype=x.dtype)
    else:
        out = sh.scatter_seq(h @ w2, seq_len, partial=False)
    if cfg.activation != "swiglu":
        out = out + p["b2"]
    return out


# ----------------------------------------------------------------- moe ----

def top_k_lowest_index(probs, k: int):
    """``(values, indices)`` of the ``k`` largest entries of the last axis,
    in descending order; of equal values the lower index comes first, as
    ``jax.lax.top_k`` orders them (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: a row of zeros where ``idx`` is outside
    [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_fwd(p, x, cfg: ArchConfig, qat=False, group_size: int = 512,
            seq_len=None):
    """Capacity-based top-k routing with dispatch / combine einsums over
    groups of ``S // max(1, S // group_size)`` tokens.  Returns (out,
    aux_loss), the Switch load-balance loss ``E * sum(mean prob x
    fraction routed first)`` over the padded experts.

    As the reference: padding experts are masked at -1e30; the gates are
    the top-k probabilities renormalised; slot after slot, a token
    takes the next free place of its expert up to the capacity
    ``max(4, int(capacity_factor * tg * k / E))`` (E padded), and is
    dropped from that slot past it; ties take the lower expert index
    (:func:`top_k_lowest_index`).

    Under a mesh the rank's sequence block (``seq_len``: as
    ``attn_fwd``) is gathered and the layer runs whole on every model
    rank (whole weights), returning the rank's block; the load-balance
    statistics are averaged over the data axes, so ``aux`` is the
    reference's over the global batch on every rank."""
    x = sh.gather_seq(x, seq_len)
    b, s, d = x.shape
    e = cfg.padded_experts()
    k = cfg.top_k
    g = max(1, s // group_size)
    tg = s // g
    cap = max(4, int(cfg.capacity_factor * tg * k / e))
    xg = x.reshape(b * g, tg, d)

    xq = maybe_fq(xg, cfg.s_act8, enabled=qat)
    logits = (xq @ fq_weight(p["router"], 1, qat)).to(torch.float32)
    if cfg.padded_experts() != cfg.n_experts:       # mask padding experts
        pad = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = torch.where(pad[None, None], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k_lowest_index(probs, k)      # (g,t,k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, -1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch): E * mean(frac_tokens * frac_prob)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(_one_hot(expert_ids[..., 0], e, torch.float32),
                    dim=(0, 1))
    mesh = current_mesh()
    if mesh is not None and mesh.axis_size(data_axes(mesh)) > 1:
        n = mesh.axis_size(data_axes(mesh))
        me = sh.all_reduce(me, data_axes(mesh)) / n
        ce = sh.all_reduce(ce, data_axes(mesh)) / n
    aux = e * torch.sum(me * ce)

    # capacity assignment, slot-by-slot (k is small)
    dispatch = torch.zeros((b * g, tg, e, cap), dtype=x.dtype,
                           device=x.device)
    combine = torch.zeros((b * g, tg, e, cap), dtype=torch.float32,
                          device=x.device)
    counts = torch.zeros((b * g, e), dtype=torch.int32, device=x.device)
    for slot in range(k):
        a = _one_hot(expert_ids[..., slot], e, torch.int32)
        pos = counts[:, None, :] + torch.cumsum(a, dim=1, dtype=torch.int32) \
            - a
        keep = (pos < cap) & (a > 0)
        oh = _one_hot(pos, cap, x.dtype) * keep[..., None].to(x.dtype)
        dispatch = dispatch + a[..., None].to(x.dtype) * oh
        combine = combine + (gate_vals[..., slot][..., None, None]
                             * oh.to(torch.float32))
        counts = counts + torch.sum(a, dim=1, dtype=torch.int32)

    buf = torch.einsum("gtd,gtec->gecd", xg, dispatch).to(x.dtype)
    bq = maybe_fq(buf, cfg.s_act8, enabled=qat)
    if cfg.activation == "swiglu":
        h1 = torch.einsum("gecd,edf->gecf", bq, fq_weight(p["w1"], 2, qat))
        h3 = torch.einsum("gecd,edf->gecf", bq, fq_weight(p["w3"], 2, qat))
        h = F.silu(maybe_fq(h1, cfg.s_act10, 10, qat)) \
            * maybe_fq(h3, cfg.s_act10, 10, qat)
    else:
        h1 = torch.einsum("gecd,edf->gecf", bq, fq_weight(p["w1"], 2, qat))
        h = F.gelu(maybe_fq(h1, cfg.s_act10, 10, qat), approximate="none")
    h = maybe_fq(h, cfg.s_act8, enabled=qat)
    y = torch.einsum("gecf,efd->gecd", h, fq_weight(p["w2"], 2, qat))
    out = torch.einsum("gecd,gtec->gtd", y.to(x.dtype),
                       combine.to(x.dtype))
    out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + ffn_fwd(p["shared"], x, cfg, qat=qat,
                            d_ff=p["shared"]["w1"].shape[-1])
    return sh.scatter_seq(out, seq_len, partial=False), aux
