"""Integer activations (twin of ``repro.core.activations``): the paper's
i-GELU unit (§III-H) with its output requant, i-SiLU for SwiGLU FFNs and
i-softplus (Mamba's Δt).

i-SiLU: sigma(x) = e / (1 + e) with e = i_exp(-|x|), one integer division
per element; SiLU = x * sigma(x), requantized.  Plain tensor code, not a
kernel.  The i-GELU of an FFN runs as kernel K6 (``kernels.int_gelu``);
:func:`i_gelu_act` is the arithmetic it is held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import intmath
from repro_torch.core.dyadic import Dyadic, bits_for, clip_to_bits, fit_dyadic

SIG_FRAC = 15                     # sigmoid as a 16-bit fraction
RECIP_BITS = 30


class IGeluActPlan(NamedTuple):
    gelu: intmath.IGeluPlan
    dn_out: Dyadic
    s_in: float
    s_out: float


def make_igelu_act(s_in: float, qmax_in: int, s_out: float) -> IGeluActPlan:
    g = intmath.make_igelu(s_in, qmax_in)
    dn_out = fit_dyadic(g.s_out / s_out, qmax_in * (2 * g.q_one))
    return IGeluActPlan(g, dn_out, s_in, s_out)


def i_gelu_act(q, plan: IGeluActPlan, out_bits: int = 8):
    out = intmath.i_gelu(q.to(torch.int32), plan.gelu)
    return clip_to_bits(plan.dn_out(out), out_bits)


class ISiluPlan(NamedTuple):
    iexp: intmath.IExpPlan
    dn_e16: Dyadic            # iexp out -> 2^-15 fraction
    s_in: float
    s_out: float              # = s_in * 2^-SIG_FRAC before dn_out
    dn_out: Dyadic
    qmax_in: int


def make_isilu(s_in: float, qmax_in: int, s_out: float) -> ISiluPlan:
    if bits_for(qmax_in) + SIG_FRAC + 1 > 31:
        raise ValueError(f"i-silu qmax_in too large: {qmax_in}")
    iexp = intmath.make_iexp(s_in)
    dn_e16 = fit_dyadic(iexp.s_out / 2.0 ** -SIG_FRAC, iexp.q_one + 1)
    s_mid = s_in * 2.0 ** -SIG_FRAC
    dn_out = fit_dyadic(s_mid / s_out, qmax_in << SIG_FRAC)
    return ISiluPlan(iexp, dn_e16, s_in, s_mid, dn_out, qmax_in)


def i_silu(q, plan: ISiluPlan, out_bits: int = 8):
    q = q.to(torch.int32)
    e = intmath.i_exp(-torch.abs(q), plan.iexp)
    e16 = torch.clamp(plan.dn_e16(e), 0, 1 << SIG_FRAC)
    one16 = torch.full_like(e16, 1 << SIG_FRAC)
    den = one16 + e16
    r = torch.div(torch.full_like(den, 1 << RECIP_BITS), den,
                  rounding_mode="floor")
    num = torch.where(q >= 0, one16, e16)
    sig16 = (num * r) >> (RECIP_BITS - SIG_FRAC)      # sigmoid * 2^15
    out = q * sig16                                    # scale s_in * 2^-15
    return clip_to_bits(plan.dn_out(out), out_bits)


class ISoftplusPlan(NamedTuple):
    iexp: intmath.IExpPlan
    dn_e16: Dyadic
    ln1p: intmath.ILn1pPlan    # emits directly at s_out (fine grid)
    s_in: float
    dn_relu: Dyadic            # s_in -> s_out for the max(x,0) branch
    s_out: float


def make_isoftplus(s_in: float, qmax_in: int, s_out: float) -> ISoftplusPlan:
    """softplus(x) = max(x, 0) + ln1p(exp(-|x|)), emitted at ``s_out``.
    Both branches are computed on the (typically much finer) output grid:
    Mamba's Δt values live in [1e-3, 1], below the input grid's
    resolution."""
    iexp = intmath.make_iexp(s_in)
    dn_e16 = fit_dyadic(iexp.s_out / 2.0 ** -SIG_FRAC, iexp.q_one + 1)
    ln1p = intmath.make_iln1p(2.0 ** -SIG_FRAC, s_out, 1 << SIG_FRAC)
    dn_relu = fit_dyadic(s_in / s_out, qmax_in)
    return ISoftplusPlan(iexp, dn_e16, ln1p, s_in, dn_relu, s_out)


def i_softplus(q, plan: ISoftplusPlan, out_bits: int = 16):
    q = q.to(torch.int32)
    e = intmath.i_exp(-torch.abs(q), plan.iexp)
    e16 = torch.clamp(plan.dn_e16(e), 0, 1 << SIG_FRAC)
    lq = intmath.i_ln1p(e16, plan.ln1p)                # scale s_out
    out = plan.dn_relu(torch.clamp(q, min=0)) + lq
    return clip_to_bits(out, out_bits)
