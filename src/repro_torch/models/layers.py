"""Float-path transformer layers with optional fake-quant (QAT) (twin of
``repro.models.layers``): the init of every sublayer (the random float
model the serving driver quantizes) and the float / QAT forwards the
training step differentiates.

Draws come from an explicit ``torch.Generator``; they are not the JAX
package's draws (tests carry JAX's float params across instead).

Under QAT every tensor the accelerator sees in INT8 / INT10 is
fake-quantized with a straight-through gradient, as in the reference.
On one device the reference's ``comm_quant_gather`` (its int8 transport
of a sequence-parallel gather) is the identity even under QAT, so
``attn_fwd`` and ``ffn_fwd`` do not fake-quantize their inputs there;
``moe_fwd`` and ``mamba_fwd`` do, through :func:`maybe_fq`.  The port
runs on one device and keeps exactly that.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quant import fake_quant, per_channel_absmax
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


def fq_weight(w, axis=-1, enabled=False):
    """Per-out-channel fake quant (axis = out-channel dim)."""
    if not enabled:
        return w
    s = torch.clamp(per_channel_absmax(w, axis), min=1e-6) / 127.0
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
             window: int = 0, memory=None, qat=False, q_chunk: int = 1024):
    """Self- or cross-attention. x: (B,S,D); memory: (B,Sm,D) for cross.

    The query rows run in chunks of at most ``q_chunk`` (the largest
    divisor of S not above it); with more than one chunk, each chunk is
    recomputed in the backward (``torch.utils.checkpoint``) instead of
    keeping every chunk's (B, H, qc, Sk) scores, as the reference's
    per-chunk ``jax.remat``.  The scores are float32 (the reference's
    ``preferred_element_type``), the probabilities in ``x``'s dtype."""
    b, s, d = x.shape
    kv_src = memory if memory is not None else x
    sk = kv_src.shape[1]
    # comm_quant_gather: the identity on one device, even under QAT
    q = _linear(x, fq_weight(p["wq"], 1, qat))
    k = _linear(kv_src, fq_weight(p["wk"], 1, qat))
    v = _linear(kv_src, fq_weight(p["wv"], 1, qat))
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.pos == "rope" and memory is None and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
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
    wo = fq_weight(p["wo"], 2, qat)
    return o.reshape(b, s, -1) @ wo.reshape(-1, d)


# ----------------------------------------------------------------- ffn ----

def ffn_fwd(p, x, cfg: ArchConfig, qat=False):
    """SwiGLU (w1, w3, w2) or GELU (exact erf) with biases b1 / b2; the
    pre-activations on the 10-bit grid and the hidden on the int8 grid
    under QAT.  The input is not fake-quantized on one device
    (``comm_quant_gather``)."""
    if cfg.activation == "swiglu":
        h1 = x @ fq_weight(p["w1"], 1, qat)
        h3 = x @ fq_weight(p["w3"], 1, qat)
        h1 = maybe_fq(h1, cfg.s_act10, bits=10, enabled=qat)
        h3 = maybe_fq(h3, cfg.s_act10, bits=10, enabled=qat)
        h = F.silu(h1) * h3
    else:
        h1 = x @ fq_weight(p["w1"], 1, qat)
        h1 = h1 + p["b1"]
        h1 = maybe_fq(h1, cfg.s_act10, bits=10, enabled=qat)
        h = F.gelu(h1, approximate="none")
    h = maybe_fq(h, cfg.s_act8, enabled=qat)
    out = h @ fq_weight(p["w2"], 1, qat)
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


def moe_fwd(p, x, cfg: ArchConfig, qat=False, group_size: int = 512):
    """Capacity-based top-k routing with dispatch / combine einsums over
    groups of ``S // max(1, S // group_size)`` tokens.  Returns (out,
    aux_loss), the Switch load-balance loss ``E * sum(mean prob x
    fraction routed first)`` over the padded experts.

    As the reference: padding experts are masked at -1e30; the gates are
    the top-k probabilities renormalised; slot after slot, a token
    takes the next free place of its expert up to the capacity
    ``max(4, int(capacity_factor * tg * k / E))`` (E padded), and is
    dropped from that slot past it; ties take the lower expert index
    (:func:`top_k_lowest_index`)."""
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
        out = out + ffn_fwd(p["shared"], x, cfg, qat=qat)
    return out, aux
