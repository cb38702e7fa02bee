"""Design-time quantization plans (SwiftTron §III-A; the dense-decoder,
encoder and mixture-of-experts subset of ``repro.quant.plans``).

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
from repro_torch.core import norms
from repro_torch.core import softmax as ism
from repro_torch.core.dyadic import Dyadic, fit_dyadic
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import require_dense


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


class LayerPlans(NamedTuple):
    """Everything the integer path of one architecture needs (the
    reference's field set; the families not ported yet stay None)."""
    cfg_name: str
    embed: EmbedPlan
    norm: norms.INormPlan
    attn: Optional[AttnPlan]
    ffn: Optional[FfnPlan]
    moe: Optional[MoePlan]
    mamba: Optional[object]
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
    ``s_emb``, and ``s_router`` for a mixture of experts (its router
    logits' scale; the defaults are the design nominals)."""
    require_dense(cfg)
    calib = dict(calib or {})
    s8 = cfg.s_act8
    d = cfg.d_model
    norm_plan = norms.make_inorm(d, cfg.s_res, cfg.qmax_res,
                                 s_gamma=2.0 / 127.0, s_out=s8,
                                 subtract_mean=(cfg.norm == "layernorm"))
    s_emb = calib.get("s_emb", s8)
    embed = EmbedPlan(s_emb, fit_dyadic(s_emb / cfg.s_res, 127))
    qkv = make_linear_plan(s8, S_W8, s8, d)
    ia = iattn.make_iattention(cfg.hd, s8, s8, s8, s8)
    out = make_linear_plan(s8, S_W8, cfg.s_res, cfg.n_heads * cfg.hd,
                           out_bits=14)
    attn = AttnPlan(qkv, ia, out)
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
    if not (cfg.n_experts and cfg.moe_every == 1):
        ffn = _ffn_plan(cfg, d, cfg.d_ff)
    return LayerPlans(cfg.name, embed, norm_plan, attn, ffn, moe, None,
                      None, HeadPlan(s8), norm_plan)
