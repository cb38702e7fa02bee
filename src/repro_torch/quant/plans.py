"""Design-time quantization plans (SwiftTron §III-A; twin of
``repro.quant.plans``).

A *plan* is the frozen set of integer constants one layer kind needs:
dyadic requant pairs, i-exp constants, reciprocal widths — plain
NamedTuples of Python ints/floats, shared across the layers of a kind.
Per-channel weight scales live in the quantized params as int32
multiplier vectors with a plan-level shared shift.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from repro_torch.core import activations as iact
from repro_torch.core import attention as iattn
from repro_torch.core import intmath, norms
from repro_torch.core import softmax as ism
from repro_torch.core.dyadic import Dyadic, fit_dyadic
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import require_ported


class LinearPlan(NamedTuple):
    """INT8 matmul + per-channel dyadic requant epilogue."""
    s_in: float
    s_out: float            # 0.0 -> keep int32 accumulator (no requant)
    out_bits: int
    c: int                  # shared shift for the per-channel multipliers
    pre: int
    k_dim: int              # contraction size (accumulator bound)

    @property
    def acc_qmax(self) -> int:
        return self.k_dim * 127 * 127


def make_linear_plan(s_in: float, s_w_max: float, s_out: float, k_dim: int,
                     out_bits: int = 8) -> LinearPlan:
    """Size the shared (c, pre) for the worst-case channel ratio."""
    acc_qmax = k_dim * 127 * 127
    if s_out == 0.0:
        return LinearPlan(s_in, 0.0, 32, 0, 0, k_dim)
    dn = fit_dyadic(s_in * s_w_max / s_out, acc_qmax)
    return LinearPlan(s_in, s_out, out_bits, dn.c, dn.pre, k_dim)


class AttnPlan(NamedTuple):
    qkv: LinearPlan
    attn: iattn.IAttnPlan
    out: LinearPlan          # o-proj: s_act8 -> s_res


class FfnPlan(NamedTuple):
    up: LinearPlan           # w1 (and w3): s_act8 -> s_act10
    act_gelu: Optional[iact.IGeluActPlan]   # GELU FFNs
    act_silu: Optional[iact.ISiluPlan]      # SwiGLU FFNs
    dn_gate: Optional[Dyadic]    # silu(h1)*h3 product -> s_act8
    down: LinearPlan         # w2: s_act8 -> s_res


class MoePlan(NamedTuple):
    router: LinearPlan       # s_act8 -> int32 logits (raw)
    gate_sm: ism.ISoftmaxPlan
    expert: FfnPlan
    dn_combine: Dyadic       # sum_k gate*y (s_act8 * 2^-7) -> s_res
    shared: Optional[FfnPlan]


class EmbedPlan(NamedTuple):
    s_emb: float             # int8 embedding table scale
    dn_res: Dyadic           # s_emb -> s_res


class HeadPlan(NamedTuple):
    s_in: float              # logits stay int32 at s_in * s_w


class MambaPlan(NamedTuple):
    """One Mamba block's constants: the projections, Δt (i-softplus), the
    decay (i-exp at 2^-14), the SSD state at 2^-16 saturating at
    ``qmax_h``, the gate, the norm over ``d_inner`` and the conv."""
    in_proj: LinearPlan      # s_act8 -> s_act8 (z,x,B,C) ; dt handled below
    dn_dt_in: Dyadic         # accumulator -> s_dt_in (10 bit)
    s_dt_in: float
    softplus: iact.ISoftplusPlan     # -> s_dt
    s_dt: float
    s_A: float
    dn_dtA: Dyadic                   # (s_dt * s_A) -> 2^-14 i-exp grid
    iexp_decay: intmath.IExpPlan     # at 2^-14
    dn_decay16: Dyadic
    dn_h: Dyadic             # dt*B*x contribution -> s_h
    s_h: float
    qmax_h: int
    dn_h8: Dyadic            # h -> int8 at s_h8
    s_h8: float
    dn_y: Dyadic             # C*h8 acc -> s_act8
    silu_z: iact.ISiluPlan
    dn_z10: Dyadic           # z (int8, s_act8) -> 10-bit grid for i-exp
    dn_gate: Dyadic          # y * sig16 -> s_act8
    norm: norms.INormPlan
    out_proj: LinearPlan
    dn_conv: Dyadic          # conv acc (s8 * s_conv) -> conv grid (+-32)
    silu_conv: iact.ISiluPlan    # conv activation -> s_xbc
    s_xbc: float             # x/B/C grid after conv+silu (wider than s8)


class LayerPlans(NamedTuple):
    """Everything the integer path of one architecture needs (the
    reference's field set).  ``cross``: the cross attention's plans of
    an encoder-decoder or a VLM, the self attention's own (the
    reference's ``cross = attn``), else None."""
    cfg_name: str
    embed: EmbedPlan
    norm: norms.INormPlan
    attn: Optional[AttnPlan]
    ffn: Optional[FfnPlan]
    moe: Optional[MoePlan]
    mamba: Optional[MambaPlan]
    cross: Optional[AttnPlan]
    head: HeadPlan
    final_norm: norms.INormPlan


S_W8 = 2.0 / 127.0          # nominal per-channel weight scale bound


def _ffn_plan(cfg: ArchConfig, d_in: int, d_ff: int) -> FfnPlan:
    s8, s10 = cfg.s_act8, cfg.s_act10
    up = make_linear_plan(s8, S_W8, s10, d_in, out_bits=11)
    if cfg.activation == "swiglu":
        silu = iact.make_isilu(s10, 1024, s_out=s8)
        # gate: silu_out(int8, s8) * h3(10bit, s10) -> requant to s8
        dn_gate = fit_dyadic(s8 * s10 / s8, 127 * 1024)
        gelu = None
    else:
        gelu = iact.make_igelu_act(s10, 1024, s_out=s8)
        silu, dn_gate = None, None
    down = make_linear_plan(s8, S_W8, cfg.s_res, d_ff, out_bits=14)
    return FfnPlan(up, gelu, silu, dn_gate, down)


def build_layer_plans(cfg: ArchConfig, calib: Optional[dict] = None
                      ) -> LayerPlans:
    """``calib``: measured per-tensor scales from ``quant.convert``:
    ``s_emb``, ``s_router`` for a mixture of experts (its router logits'
    scale) and ``s_dtw`` / ``s_conv`` for a Mamba block (its Δt
    projection's and conv's; the defaults are the design nominals)."""
    require_ported(cfg)
    calib = dict(calib or {})
    s8 = cfg.s_act8
    d = cfg.d_model
    norm_plan = norms.make_inorm(d, cfg.s_res, cfg.qmax_res,
                                 s_gamma=2.0 / 127.0, s_out=s8,
                                 subtract_mean=(cfg.norm == "layernorm"))
    s_emb = calib.get("s_emb", s8)
    embed = EmbedPlan(s_emb, fit_dyadic(s_emb / cfg.s_res, 127))
    attn = None
    if cfg.family != "ssm":
        qkv = make_linear_plan(s8, S_W8, s8, d)
        ia = iattn.make_iattention(cfg.hd, s8, s8, s8, s8)
        out = make_linear_plan(s8, S_W8, cfg.s_res, cfg.n_heads * cfg.hd,
                               out_bits=14)
        attn = AttnPlan(qkv, ia, out)
    cross = attn if cfg.family in ("encdec", "vlm") else None
    ffn = moe = None
    if cfg.n_experts > 0:
        router = make_linear_plan(s8, S_W8, 0.0, d)
        # router logits int32 at s8 * s_router (per-tensor router weights)
        s_router = calib.get("s_router", S_W8)
        gate_sm = ism.make_isoftmax(s8 * s_router, router.acc_qmax)
        f = cfg.moe_d_ff or cfg.d_ff
        expert = _ffn_plan(cfg, d, f)
        dn_combine = fit_dyadic(s8 * ism.S_PROB / cfg.s_res,
                                cfg.top_k * 127 * 127)
        shared = _ffn_plan(cfg, d, f * cfg.n_shared_experts) \
            if cfg.n_shared_experts else None
        moe = MoePlan(router, gate_sm, expert, dn_combine, shared)
    if cfg.family != "ssm" and not (cfg.n_experts and cfg.moe_every == 1):
        ffn = _ffn_plan(cfg, d, cfg.d_ff)
    mamba = _mamba_plan(cfg, calib) if cfg.family in ("ssm", "hybrid") \
        else None
    return LayerPlans(cfg.name, embed, norm_plan, attn, ffn, moe, mamba,
                      cross, HeadPlan(s8), norm_plan)


def _mamba_plan(cfg: ArchConfig, calib: Optional[dict] = None) -> MambaPlan:
    """The reference's constants, in its order (``s_dtw`` and ``s_conv``
    from ``calib``, else the nominal weight scale)."""
    calib = dict(calib or {})
    s8, s10 = cfg.s_act8, cfg.s_act10
    d = cfg.d_model
    in_proj = make_linear_plan(s8, S_W8, s8, d)
    acc_q = in_proj.acc_qmax
    s_dt_in = 16.0 / 1024.0
    s_dtw = calib.get("s_dtw", S_W8)
    dn_dt_in = fit_dyadic(s8 * s_dtw / s_dt_in, acc_q)
    # the Δt grid: i-softplus clips at out_bits 13
    s_dt = 1.0 / (1 << 12)
    softplus = iact.make_isoftplus(s_dt_in, 1024, s_out=s_dt)
    s_A = 16.0 / 1024.0
    # dt*A onto the shared 2^-14 i-exp grid
    qmax_dtA = (1 << 13) * 1024
    dn_dtA = fit_dyadic(s_dt * s_A / 2.0 ** -14, qmax_dtA)
    iexp_decay = intmath.make_iexp(2.0 ** -14)
    dn_decay16 = fit_dyadic(iexp_decay.s_out / 2.0 ** -15,
                            iexp_decay.q_one + 1)
    # the SSD state at 2^-16, saturating at qmax_h
    s_h = 2.0 ** -16
    qmax_h = 1 << 27
    s_h8 = 4.0 / 127.0
    dn_h8 = fit_dyadic(s_h / s_h8, qmax_h)
    silu_z = iact.make_isilu(s10, 1024, s_out=s8)   # gate on the 10-bit grid
    dn_z10 = fit_dyadic(s8 / s10, 127)
    dn_gate = fit_dyadic(2.0 ** -15, 127 << 15)     # (unused on the BFP path)
    # y enters the RMSNorm over d_inner as a per-row block-floating-point
    # value of <= 12 bits: the norm is scale-invariant, so the row shift
    # cancels
    norm = norms.make_inorm(cfg.ssm_d_inner, 1.0, 1 << 11,
                            s_gamma=2.0 / 127.0, s_out=s8,
                            subtract_mean=False)
    out_proj = make_linear_plan(s8, S_W8, cfg.s_res, cfg.ssm_d_inner,
                                out_bits=14)
    s_conv = calib.get("s_conv", S_W8)
    # conv + SiLU outputs (x / B / C) accumulate at +-32 (10 bit) and are
    # emitted as int8 on a +-16 grid
    s_conv_grid = 32.0 / 1024.0
    s_xbc = 16.0 / 127.0
    dn_conv = fit_dyadic(s8 * s_conv / s_conv_grid,
                         cfg.ssm_conv * 127 * 127)
    silu_conv = iact.make_isilu(s_conv_grid, 1024, s_out=s_xbc)
    # the state path's dyadics on the s_xbc operand grid
    dn_h = fit_dyadic(s_dt * s_xbc * s_xbc / s_h, (1 << 13) * 127 * 127)
    dn_y = fit_dyadic(s_xbc * s_h8 / s8, cfg.ssm_state * 127 * 127)
    return MambaPlan(in_proj, dn_dt_in, s_dt_in, softplus, s_dt, s_A,
                     dn_dtA, iexp_decay, dn_decay16, dn_h, s_h, qmax_h,
                     dn_h8, s_h8, dn_y, silu_z, dn_z10, dn_gate, norm,
                     out_proj, dn_conv, silu_conv, s_xbc)
