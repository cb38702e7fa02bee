"""Mamba-2 (SSD) float blocks (twin of the float half of
``repro.models.mamba``): the random float block the integer path
quantizes, and the float / QAT forward the training step
differentiates — the chunk-parallel SSD algorithm (an intra-chunk
quadratic form and an inter-chunk state recurrence).  The integer step
and prefill are in ``models.intlayers``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import _init, fq_weight, maybe_fq


def proj_width(cfg: ArchConfig) -> int:
    """in_proj's output: z, x (d_inner each), B, C (groups x state each),
    then one Δt a head."""
    di = cfg.ssm_d_inner
    return 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads


def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype):
    """One Mamba block's float params, drawn from ``gen`` in the order
    in_proj, conv_w, dt_bias, out_proj.  A_log, D and dt_bias are float32
    whatever ``dtype`` is, as in the reference: A = 1..16 over the heads,
    D = 1, and dt_bias the inverse softplus of a Δt log-uniform in
    [0.001, 0.1]."""
    d, di, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
    dev = gen.device
    conv_ch = di + 2 * cfg.ssm_groups * cfg.ssm_state
    in_proj = _init(gen, (d, proj_width(cfg)), dtype)
    conv_w = _init(gen, (cfg.ssm_conv, conv_ch), dtype, scale=3.0)
    u = torch.rand((h,), generator=gen, dtype=torch.float32, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    out_proj = _init(gen, (di, d), dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm_gamma": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": out_proj,
    }


def _split_proj(zxbcdt, cfg: ArchConfig):
    """in_proj's output -> (z, x, B, C, dt)."""
    di, g, n, h = (cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state,
                   cfg.ssm_heads)
    return torch.split(zxbcdt, [di, di, g * n, g * n, h], dim=-1)


def _conv1d(xbc, w, state=None):
    """Causal depthwise conv, width K. xbc: (B,L,C); w: (K,C).

    With ``state`` (B,K-1,C): decode mode, returns (out, new_state)."""
    k = w.shape[0]
    n = xbc.shape[1]
    if state is not None:
        full = torch.cat([state, xbc], dim=1)
        out = sum(full[:, i:i + n] * w[i] for i in range(k))
        return out, full[:, -(k - 1):]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + n] * w[i] for i in range(k)), None


def _segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{j < m <= i} x[..., m]
    below the diagonal, -inf above it (``exp`` of it is 0 there, and no
    gradient flows into the masked entries)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunk-parallel SSD.  x:(b,l,h,p) dt:(b,l,h) A:(h,) B,C:(b,l,g,n).

    Returns (y, h_last).  h: (b,h,n,p)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"sequence {l} is not a multiple of chunk {chunk}")
    nc = l // chunk
    rep = h // g
    xs = x.reshape(b, nc, chunk, h, p)
    dts = dt.reshape(b, nc, chunk, h)
    Bs = torch.repeat_interleave(B.reshape(b, nc, chunk, g, n), rep, dim=3)
    Cs = torch.repeat_interleave(C.reshape(b, nc, chunk, g, n), rep, dim=3)
    dtA = dts * A[None, None, None, :]                  # (b,nc,c,h) <= 0
    ca = torch.cumsum(dtA, dim=2)

    # intra-chunk (diag) term
    L = torch.exp(_segsum(dtA.permute(0, 1, 3, 2)))     # (b,nc,h,c,c)
    scores = torch.einsum("bzchn,bzdhn->bzhcd", Cs, Bs) * L
    y_diag = torch.einsum("bzhcd,bzdh,bzdhp->bzchp", scores, dts, xs)

    # chunk states
    decay_to_end = torch.exp(ca[:, :, -1:, :] - ca)     # (b,nc,c,h)
    S = torch.einsum("bzchn,bzch,bzch,bzchp->bzhnp",
                     Bs, decay_to_end, dts, xs)         # (b,nc,h,n,p)

    # inter-chunk recurrence
    chunk_decay = torch.exp(torch.sum(dtA, dim=2))      # (b,nc,h)
    hprev = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    h_prevs = []
    for z in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * chunk_decay[:, z, :, None, None] + S[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)               # (b,nc,h,n,p)

    y_off = torch.einsum("bzchn,bzch,bzhnp->bzchp",
                         Cs, torch.exp(ca), h_prevs)
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, hprev


def mamba_fwd(p, u, cfg: ArchConfig, qat=False, chunk: int = 128,
              h0=None, conv_state=None, return_state=False, seq_len=None):
    """Float/QAT forward. u: (B,L,D) -> (B,L,D).

    Under QAT the input and the output projection's input are on the int8
    activation grid, x / B / C on the +-16 int8 grid after the conv, and
    Δt saturates at 2.0 (the integer path's grids).  Under a mesh the
    rank's sequence block (``seq_len``: the whole length, where the
    residual is sequence-sharded) is gathered, the block runs whole on
    every model rank (the SSD recurrence needs the whole sequence) and
    the rank's block of the output is returned."""
    u = sh.gather_seq(u, seq_len)
    b, l, d = u.shape
    di = cfg.ssm_d_inner
    uq = maybe_fq(u, cfg.s_act8, enabled=qat)
    zxbcdt = uq @ fq_weight(p["in_proj"], 1, qat)
    z, x, B, C, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([x, B, C], dim=-1)
    xbc, new_conv = _conv1d(xbc, p["conv_w"].to(u.dtype), conv_state)
    xbc = F.silu(xbc)
    xbc = maybe_fq(xbc, 16.0 / 127.0, enabled=qat)
    gn = cfg.ssm_groups * cfg.ssm_state
    x, B, C = torch.split(xbc, [di, gn, gn], dim=-1)
    h = cfg.ssm_heads
    x = x.reshape(b, l, h, cfg.ssm_head_dim)
    B = B.reshape(b, l, cfg.ssm_groups, cfg.ssm_state)
    C = C.reshape(b, l, cfg.ssm_groups, cfg.ssm_state)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    if qat:
        dt = torch.clamp(dt, max=2.0)
    A = -torch.exp(p["A_log"])
    ck = min(chunk, l)
    while l % ck:
        ck -= 1
    y, h_last = ssd_chunked(x.to(torch.float32), dt, A,
                            B.to(torch.float32), C.to(torch.float32), ck,
                            h0=h0)
    y = y + x.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(b, l, di).to(u.dtype)
    y = y * F.silu(z)
    # RMSNorm before out-projection (mamba2)
    yf = y.to(torch.float32)
    y = (yf / torch.sqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
         * p["norm_gamma"]).to(u.dtype)
    y = maybe_fq(y, cfg.s_act8, enabled=qat)
    out = sh.scatter_seq(y @ fq_weight(p["out_proj"], 1, qat), seq_len,
                         partial=False)
    if return_state:
        return out, (h_last, new_conv)
    return out


def mamba_step(p, u_t, state, cfg: ArchConfig):
    """Float single-token decode step.  u_t: (B,D); state: (h, conv)."""
    h_prev, conv_state = state
    out, (h_new, conv_new) = mamba_fwd(
        p, u_t[:, None, :], cfg, qat=False, chunk=1, h0=h_prev,
        conv_state=conv_state, return_state=True)
    return out[:, 0], (h_new, conv_new)


def init_mamba_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device="cuda"):
    """Zero (h (B, heads, state, head_dim), conv (B, K - 1, channels)) on
    ``device`` (default the card; raises without one unless given
    ``device="cpu"``)."""
    dev = resolve_device(device)
    h = torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                     cfg.ssm_head_dim), dtype=dtype, device=dev)
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv = torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                       device=dev)
    return h, conv
