"""Integer LayerNorm / RMSNorm (SwiftTron §III-I; twin of
``repro.core.norms``).

Mean (dyadic 1/d, LayerNorm only), variance with a design-time
pre-shift, the 16-step integer sqrt, one reciprocal per row, per-channel
gamma (and folded beta), dyadic requant to the int8 output scale.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.analysis.budgets import INT32_MAX
from repro_torch.core import intmath
from repro_torch.core.dyadic import (Dyadic, bits_for, clip_to_bits,
                                     fit_dyadic, rshift_round)


class INormPlan(NamedTuple):
    d: int                  # normalised dimension
    s_in: float             # input scale (int32 values, |q| <= qmax_in)
    qmax_in: int
    dn_mean: Dyadic         # 1/d on the sum
    dn_var: Dyadic          # 1/d on the squared sum
    pre_shift: int          # s: y >> s before squaring
    recip_bits: int         # k: reciprocal precision (n at scale 2^-k)
    s_gamma: float
    s_out: float
    dn_out: Dyadic          # (2^-k * s_gamma) -> s_out  (applied to n*gamma)
    q_beta_scale: float     # scale at which beta is folded in
    subtract_mean: bool


def make_inorm(d: int, s_in: float, qmax_in: int, s_gamma: float,
               s_out: float, subtract_mean: bool = True) -> INormPlan:
    dn_mean = fit_dyadic(1.0 / d, d * qmax_in)
    y_max = 2 * qmax_in
    s = 0
    while d * ((y_max >> s) ** 2) > INT32_MAX:
        s += 1
    dn_var = fit_dyadic(1.0 / d, d * ((y_max >> s) ** 2))
    k = min(15, 31 - bits_for(y_max) - s)
    if k < 8:
        raise ValueError(f"i-norm reciprocal precision too low (k={k}); "
                         f"reduce qmax_in={qmax_in}")
    nmax = min(math.sqrt(d), 128.0)
    n_q_max = int(nmax * (1 << k))
    dn_out = fit_dyadic((2.0 ** -k) * s_gamma / s_out, n_q_max * 127)
    q_beta_scale = (2.0 ** -k) * s_gamma
    return INormPlan(d, s_in, qmax_in, dn_mean, dn_var, s, k, s_gamma,
                     s_out, dn_out, q_beta_scale, subtract_mean)


def quantize_norm_weights(gamma, beta, plan: INormPlan):
    """Float gamma/beta -> integer-side constants (float32 arithmetic and
    round-half-to-even, as the reference)."""
    gamma = gamma.to(torch.float32)
    q_gamma = torch.clamp(torch.round(gamma / plan.s_gamma), -127, 127
                          ).to(torch.int32)
    if beta is None:
        return q_gamma, None
    q_beta = torch.round(beta.to(torch.float32) / plan.q_beta_scale
                         ).to(torch.int32)
    return q_gamma, q_beta


def i_norm(q, q_gamma, q_beta, plan: INormPlan, out_bits: int = 8):
    """LayerNorm/RMSNorm over the last axis.  q: int32 at plan.s_in.
    Returns int32 clipped to the signed ``out_bits`` range."""
    q = q.to(torch.int32)
    if plan.subtract_mean:
        mu = plan.dn_mean(q.sum(dim=-1, keepdim=True, dtype=torch.int32))
        y = q - mu
    else:
        y = q
    ys = rshift_round(y, plan.pre_shift)
    var = plan.dn_var((ys * ys).sum(dim=-1, keepdim=True,
                                    dtype=torch.int32))
    sigma_s = intmath.i_sqrt(var)               # scale s_in * 2^pre_shift
    r = torch.div(torch.full_like(sigma_s,
                                  1 << (plan.recip_bits + plan.pre_shift)),
                  torch.clamp(sigma_s, min=1), rounding_mode="floor")
    n_q = rshift_round(y * r, 2 * plan.pre_shift)
    n_q = torch.where(sigma_s == 0, torch.zeros_like(n_q), n_q)
    out = n_q * q_gamma.to(torch.int32)
    if q_beta is not None:
        out = out + q_beta.to(torch.int32)
    out = plan.dn_out(out)
    return clip_to_bits(out, out_bits)
