"""Dyadic-number requantization (SwiftTron §III-C; twin of ``repro.core.dyadic``).

A scale ratio ``r = S_in / S_out`` is frozen at design time into ``b /
2**c`` and applied in two int32 stages so the product never overflows:

    q_out = rshift_round(rshift_round(q_in, pre) * b, c - pre)
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.analysis.budgets import INT32_MAX


def bits_for(v: int) -> int:
    """Number of bits needed for magnitude ``v`` (ceil(log2(v+1)))."""
    v = int(v)
    return 0 if v <= 0 else v.bit_length()


def rshift_round(x, s: int):
    """Arithmetic right shift by static ``s`` with round-half-up (int32
    wrap on the rounding add, as in the reference); ``s < 0`` is an exact
    left shift, ``s == 0`` the identity."""
    if s == 0:
        return x
    if s < 0:
        return x << (-s)
    return (x + (1 << (s - 1))) >> s


def rshift_floor(x, s: int):
    """Arithmetic right shift by static ``s`` (floor); ``s < 0`` is an
    exact left shift, ``s == 0`` the identity."""
    if s <= 0:
        return x if s == 0 else x << (-s)
    return x >> s


@dataclasses.dataclass(frozen=True)
class Dyadic:
    """Frozen requant constants: value ~= b / 2**c applied after ``pre``."""

    b: int          # multiplier, fits in ``mult_bits`` bits
    c: int          # total right shift (including ``pre``)
    pre: int        # input pre-shift so (q >> pre) * b fits int32
    qmax_in: int    # design-time bound on |q_in| this dyadic was sized for

    @property
    def value(self) -> float:
        return self.b / (1 << self.c) if self.c >= 0 else self.b * (1 << -self.c)

    def __call__(self, q):
        return apply_dyadic(q, self)


def fit_dyadic(ratio: float, qmax_in: int, mult_bits: int = 15) -> Dyadic:
    """Design-time fit of ``ratio`` (> 0) to a dyadic pair whose staged
    int32 product cannot overflow for ``|q_in| <= qmax_in``."""
    if not ratio > 0.0 or not math.isfinite(ratio):
        raise ValueError(f"dyadic ratio must be positive finite, got {ratio}")
    mb = mult_bits
    m, e = math.frexp(ratio)          # ratio = m * 2**e, m in [0.5, 1)
    b = int(round(m * (1 << mb)))
    c = mb - e
    if b == (1 << mb):                # rounding spilled over
        b >>= 1
        c -= 1
    while b and b % 2 == 0 and c > 0:  # exact power-of-two folding
        b >>= 1
        c -= 1

    def prod_max(pre_):
        half = 1 << max(0, c - pre_ - 1)
        return ((qmax_in >> pre_) + 1) * b + half   # +1: pre-shift rounding

    pre = 0
    while pre < c and prod_max(pre) > INT32_MAX:
        pre += 1
    if prod_max(pre) > INT32_MAX:
        raise ValueError(
            f"dyadic overflow: ratio={ratio} qmax_in={qmax_in} "
            f"(b={b}, c={c}, pre={pre})")
    return Dyadic(b=b, c=c, pre=pre, qmax_in=int(qmax_in))


def apply_dyadic(q, dn: Dyadic):
    """q_out = round(q * b / 2**c), staged in int32.  q: int32 tensor."""
    y = rshift_round(q, dn.pre)
    y = y * dn.b
    return rshift_round(y, dn.c - dn.pre)


def apply_dyadic_exact_np(q: np.ndarray, dn: Dyadic) -> np.ndarray:
    """int64 numpy oracle of the ideal (single-stage) dyadic requant."""
    q = q.astype(np.int64)
    half = 1 << (dn.c - 1) if dn.c > 0 else 0
    return (q * dn.b + half) >> dn.c


def requantize(q, ratio: float, qmax_in: int, out_bits: int = 8,
               mult_bits: int = 15):
    """One-shot: fit + apply + clip to the signed ``out_bits`` range.
    Returns int32 values (the consumer casts: matmul inputs to int8)."""
    dn = fit_dyadic(ratio, qmax_in, mult_bits)
    return clip_to_bits(apply_dyadic(q, dn), out_bits)


def clip_to_bits(q, out_bits: int):
    lo, hi = -(1 << (out_bits - 1)), (1 << (out_bits - 1)) - 1
    return torch.clamp(q, lo, hi)


def apply_dyadic_perchannel(q, b_vec, c: int, pre: int, axis: int = -1):
    """Per-channel dyadic requant: int32 ``b_vec`` broadcast on ``axis``
    with shared static shifts ``(c, pre)``."""
    shape = [1] * q.ndim
    shape[axis] = -1
    b = b_vec.to(torch.int32).reshape(shape)
    y = rshift_round(q, pre)
    y = y * b
    return rshift_round(y, c - pre)
