"""Integer i-SiLU for SwiGLU FFNs (twin of ``repro.core.activations``).

sigma(x) = e / (1 + e) with e = i_exp(-|x|), one integer division per
element; SiLU = x * sigma(x), requantized.  Plain tensor code, not a
kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import intmath
from repro_torch.core.dyadic import Dyadic, bits_for, clip_to_bits, fit_dyadic

SIG_FRAC = 15                     # sigmoid as a 16-bit fraction
RECIP_BITS = 30


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
