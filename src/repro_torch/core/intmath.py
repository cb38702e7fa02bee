"""Integer-only math primitives (SwiftTron §III-F/H/I; twin of
``repro.core.intmath``): i-exp, i-erf / i-GELU, the integer square root,
and the generic 2nd-order polynomial i-poly2 with i-ln1p built on it.

Everything operates on int32 tensors with design-time constants.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.analysis.budgets import static_check
from repro_torch.core.dyadic import Dyadic, bits_for, fit_dyadic, rshift_round

# I-BERT second-order polynomials a(p+b)^2+c: exp(p) on (-ln2, 0], erf(p)
# on [0, -b].
EXP_A, EXP_B, EXP_C = 0.35815147, 1.353, 0.344
ERF_A, ERF_B, ERF_C = -0.2888, -1.769, 1.0
LN2 = math.log(2.0)

# ln(1+e) on e in [0, 1]: design-time least-squares fit (i-softplus).
_e = np.linspace(0.0, 1.0, 4097)
LN1P_COEFS = tuple(np.polyfit(_e, np.log1p(_e), 2).tolist())  # (a2, a1, a0)
del _e


def _static_check(val: int, what: str):
    """Design-time bound check (the central budget's typed
    ``BitBudgetError``, a ``ValueError``)."""
    static_check(val, what)


def int_einsum(eq: str, a, b):
    """Exact int32 ``einsum`` of int8 operands.

    Torch has no integer matmul on CUDA, so the plain contraction runs in
    float64: every product of two int8 values and every partial sum of up
    to 2^38 of them is an integer below 2^53, hence exact in any summation
    order.  The int64 hop truncates to int32 as the reference's int32
    accumulator would."""
    out = torch.einsum(eq, a.to(torch.float64), b.to(torch.float64))
    return out.to(torch.int64).to(torch.int32)


_POW2 = {}


def int_bit_length(n):
    """Vectorised bit length of non-negative int32 ``n`` (integer-only;
    0 for ``n <= 0``, as the reference's five halving steps give): the
    count of powers 2^0 .. 2^30 at or below ``n``, one comparison against
    a cached table and one sum (two launches on the card where the
    halving steps take ~28).  It holds 31 booleans an element for the
    moment: the callers pass row maxima and variances."""
    key = (n.device, n.dtype)
    if key not in _POW2:
        _POW2[key] = torch.ones(31, dtype=n.dtype, device=n.device) << \
            torch.arange(31, dtype=n.dtype, device=n.device)
    return (n[..., None] >= _POW2[key]).sum(dim=-1, dtype=n.dtype)


def i_sqrt(n, iters: int = 16):
    """Integer sqrt via the paper's §III-I Babylonian recursion: a fixed
    ``iters`` Newton steps, the clamp at 46340 = floor(sqrt(2^31-1)) and
    the final +-1 corrections.  Exact floor(sqrt(n)) for 0 <= n < 2^31;
    0 for n <= 0."""
    n = n.to(torch.int32)
    bl = int_bit_length(n)
    x = torch.clamp(torch.ones_like(n) << ((bl + 1) >> 1), min=1)
    for _ in range(iters):
        nx = (x + torch.div(n, x, rounding_mode="floor")) >> 1
        # monotone envelope: once below the true sqrt it oscillates by <=1
        x = torch.minimum(x, torch.clamp(nx, min=1))
    x = torch.clamp(x, max=46340)      # keeps x*x in int32
    for _ in range(2):                 # floor-division oscillation
        x = torch.where(x * x > n, x - 1, x)
    x = torch.where((x < 46340) & ((x + 1) * (x + 1) <= n), x + 1, x)
    return torch.where(n <= 0, torch.zeros_like(x), x)


class IExpPlan(NamedTuple):
    """Design-time constants for i-exp at a fixed input scale."""
    s_in: float
    s_out: float
    q_ln2: int
    q_b: int
    q_c: int
    z_max: int

    @property
    def q_one(self) -> int:
        """Integer representing 1.0 at the output scale (= exp(0))."""
        return int(round(1.0 / self.s_out))


def make_iexp(s_in: float, z_max: int = 30) -> IExpPlan:
    q_ln2 = int(math.floor(LN2 / s_in))
    if q_ln2 < 16:
        raise ValueError(f"i-exp input scale too coarse: {s_in}")
    q_b = int(math.floor(EXP_B / s_in))
    s_out = EXP_A * s_in * s_in
    q_c = int(math.floor(EXP_C / s_out))
    _static_check(q_b * q_b + q_c, "i-exp polynomial")
    _static_check(z_max * q_ln2, "i-exp range clip")
    return IExpPlan(s_in, s_out, q_ln2, q_b, q_c, z_max)


def i_exp(q, plan: IExpPlan):
    """exp(x) for x = q * s_in <= 0, int32 at ``plan.s_out``:
    x = p - z*ln2, exp(x) = exp(p) >> z with exp(p) ~ a(p+b)^2 + c."""
    q = torch.clamp(q, max=0)
    qn = torch.clamp(q, min=-plan.z_max * plan.q_ln2)
    z = torch.div(-qn, plan.q_ln2, rounding_mode="floor")
    q_p = qn + z * plan.q_ln2                      # in (-q_ln2, 0]
    t = q_p + plan.q_b
    q_l = t * t + plan.q_c
    return q_l >> z                                # exp(p) * 2^-z


class IErfPlan(NamedTuple):
    s_in: float
    s_out: float
    q_clip: int
    q_bneg: int
    q_c: int


def make_ierf(s_in: float) -> IErfPlan:
    q_clip = int(math.floor(-ERF_B / s_in))
    q_bneg = int(math.floor(ERF_B / s_in))
    s_poly = ERF_A * s_in * s_in                    # negative
    q_c = int(math.floor(ERF_C / s_poly))           # negative
    _static_check(q_clip * q_clip + abs(q_c), "i-erf polynomial")
    return IErfPlan(s_in, -s_poly, q_clip, q_bneg, q_c)


def i_erf(q, plan: IErfPlan):
    """erf(x) for x = q * s_in, int32 at ``plan.s_out`` (> 0).  ``sign(0)``
    is 0, and ``abs`` wraps at -2^31, as in the reference."""
    sgn = torch.sign(q).to(torch.int32)
    q_abs = torch.clamp(torch.abs(q), max=plan.q_clip)
    t = q_abs + plan.q_bneg                         # in [q_bneg, 0]
    bracket = t * t + plan.q_c                      # <= 0
    return sgn * (-bracket)


class IGeluPlan(NamedTuple):
    s_in: float
    s_out: float
    erf: IErfPlan
    q_one: int
    qmax_in: int


def make_igelu(s_in: float, qmax_in: int) -> IGeluPlan:
    erf = make_ierf(s_in / math.sqrt(2.0))
    q_one = int(math.floor(1.0 / erf.s_out))
    _static_check(qmax_in * (2 * q_one), "i-gelu product")
    s_out = s_in * erf.s_out / 2.0
    return IGeluPlan(s_in, s_out, erf, q_one, qmax_in)


def i_gelu(q, plan: IGeluPlan):
    """GELU(x) = x * 0.5 * (1 + erf(x/sqrt(2))) — paper §III-H / Fig. 14."""
    q_erf = i_erf(q, plan.erf)
    return q * (q_erf + plan.q_one)


class IPoly2Plan(NamedTuple):
    d2: Dyadic
    d1: Dyadic
    sign1: int
    c0: int
    s0: int


def make_ipoly2(coeffs: Tuple[float, float, float], s_in: float,
                s_out: float, qmax_in: int) -> IPoly2Plan:
    """Generic integer 2nd-order polynomial a2 x^2 + a1 x + a0 evaluated at
    x = q*s_in, emitted at scale s_out (used for i-ln1p)."""
    a2, a1, a0 = coeffs
    s0 = max(0, bits_for(qmax_in) - 15)
    q_sq_max = (qmax_in >> s0) ** 2
    d2 = fit_dyadic(abs(a2) * (s_in * (1 << s0)) ** 2 / s_out, q_sq_max) \
        if a2 != 0 else None
    d1 = fit_dyadic(abs(a1) * s_in / s_out, qmax_in) if a1 != 0 else None
    c0 = int(round(a0 / s_out))
    return IPoly2Plan(d2, d1, 1 if a1 >= 0 else -1, c0, s0)


def i_poly2(q, plan: IPoly2Plan, a2_sign: int = 1):
    qs = rshift_round(q, plan.s0)
    out = torch.full_like(q, plan.c0)
    if plan.d2 is not None:
        out = out + a2_sign * plan.d2(qs * qs)
    if plan.d1 is not None:
        out = out + plan.sign1 * plan.d1(q)
    return out


class ILn1pPlan(NamedTuple):
    poly: IPoly2Plan
    a2_sign: int
    s_in: float
    s_out: float


def make_iln1p(s_in: float, s_out: float, qmax_in: int) -> ILn1pPlan:
    a2, a1, a0 = LN1P_COEFS
    poly = make_ipoly2((a2, a1, a0), s_in, s_out, qmax_in)
    return ILn1pPlan(poly, 1 if a2 >= 0 else -1, s_in, s_out)


def i_ln1p(q, plan: ILn1pPlan):
    """ln(1+e) for e = q*s_in in [0, 1]."""
    q = torch.clamp(q, 0, int(round(1.0 / plan.s_in)))
    return i_poly2(q, plan.poly, plan.a2_sign)
