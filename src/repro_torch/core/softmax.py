"""Integer-only softmax, "Shiftmax" (SwiftTron §III-F; twin of
``repro.core.softmax``).

Per row: maximum search, i-exp of (x - max) requantized to 2^-15
fractions, one reciprocal ``2^30 // sum`` and int8 probabilities at 2^-7.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.analysis.budgets import INT32_MAX
from repro_torch.core import intmath
from repro_torch.core.dyadic import Dyadic, fit_dyadic, rshift_round

S_SM = 2.0 ** -14        # shared i-exp input scale
S_EXP16 = 2.0 ** -15     # exp values as 16-bit fractions
S_PROB = 2.0 ** -7       # int8 probability scale
PROB_SHIFT = 7
RECIP_BITS = 30
Z_MAX = 30               # exp(-z_max*ln2) == 2^-30 ~ 0
NEG = -(2 ** 30)         # masked-score sentinel


class ISoftmaxPlan(NamedTuple):
    dn_in: Dyadic                 # (score - max) scale -> S_SM
    iexp: intmath.IExpPlan
    dn_e16: Dyadic                # iexp out -> S_EXP16
    s_in: float
    q_band: int                   # clip: q - max >= -q_band (raw units)

    @property
    def s_out(self) -> float:
        return S_PROB


def make_isoftmax(s_score: float, qmax_score: int) -> ISoftmaxPlan:
    if 2 * qmax_score > INT32_MAX:
        raise ValueError(f"score range too wide: {qmax_score}")
    q_band = int(math.ceil(Z_MAX * intmath.LN2 / s_score))
    dn_in = fit_dyadic(s_score / S_SM, q_band)
    iexp = intmath.make_iexp(S_SM, z_max=Z_MAX)
    dn_e16 = fit_dyadic(iexp.s_out / S_EXP16, iexp.q_one + 1)
    return ISoftmaxPlan(dn_in, iexp, dn_e16, s_score, q_band)


def _exp16(q_sub, plan: ISoftmaxPlan):
    """(q - rowmax) in raw scale (<= 0) -> exp as a 2^-15 fraction."""
    q_sub = torch.clamp(q_sub, min=-plan.q_band)
    q_sm = plan.dn_in(q_sub)
    e = intmath.i_exp(q_sm, plan.iexp)
    return plan.dn_e16(e)


def i_softmax(q_scores, plan: ISoftmaxPlan, where=None):
    """int32 scores -> int8 probabilities (scale 2^-7) along the last axis.
    ``where`` (True = attend): masked positions count ``NEG`` in the max
    and 0 in the sum."""
    q = q_scores.to(torch.int32)
    if where is not None:
        q = torch.where(where, q, torch.full_like(q, NEG))
    q_max = q.amax(dim=-1, keepdim=True)
    e16 = _exp16(q - q_max, plan)
    if where is not None:
        e16 = torch.where(where, e16, torch.zeros_like(e16))
    s = e16.sum(dim=-1, keepdim=True, dtype=torch.int32)
    r = torch.div(torch.full_like(s, 1 << RECIP_BITS),
                  torch.clamp(s, min=1), rounding_mode="floor")
    p = rshift_round(e16 * r, RECIP_BITS - PROB_SHIFT)
    return torch.clamp(p, 0, 127).to(torch.int8)


def i_softmax_stats(q_scores, plan: ISoftmaxPlan, where=None):
    """Chunk-local stats for two-pass / online attention: ``(e16,
    chunk_max_raw, chunk_sum)`` along the last axis.  The chunk max stays
    in the exact raw score scale so running maxima combine losslessly;
    sums rescale across chunks with :func:`combine_correction`."""
    q = q_scores.to(torch.int32)
    if where is not None:
        q = torch.where(where, q, torch.full_like(q, NEG))
    q_max = q.amax(dim=-1, keepdim=True)
    e16 = _exp16(q - q_max, plan)
    if where is not None:
        e16 = torch.where(where, e16, torch.zeros_like(e16))
    return e16, q_max, e16.sum(dim=-1, keepdim=True, dtype=torch.int32)


def combine_correction(old_max_raw, new_max_raw, plan: ISoftmaxPlan):
    """int32 multiplier (scale 2^-15) rescaling old-chunk stats to the new
    running max: ``exp(old_max - new_max)``, maxes in the raw scale."""
    return _exp16(old_max_raw - new_max_raw, plan)


def rescale_sum(s, corr16):
    """``(s * corr16) >> 15`` through a hi/lo split so no int32 product
    overflows for ``|s|`` up to 2^30: arithmetic ``>> 15`` of a possibly
    negative ``s``, plus the rounded low 15 bits (the online attention
    kernel's ``_rescale32``)."""
    return (s >> 15) * corr16 + rshift_round((s & 0x7FFF) * corr16, 15)


def finalize_probs(e16, s):
    """Normalise e16 values (against the global max) by the global sum ->
    int8 probabilities."""
    r = torch.div(torch.full_like(s, 1 << RECIP_BITS),
                  torch.clamp(s, min=1), rounding_mode="floor")
    p = rshift_round(e16 * r, RECIP_BITS - PROB_SHIFT)
    return torch.clamp(p, 0, 127).to(torch.int8)
