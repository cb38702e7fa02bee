"""The ``IntRange`` abstract domain + sound transfer functions (twin of
``repro.analysis.ranges``).

Abstract interpretation over the integer datapath: a value is abstracted
to the closed interval ``[lo, hi]`` of the int32 quantities it can take,
and every transfer function maps worst-case input intervals to a sound
worst-case output interval, raising :class:`~repro_torch.analysis.budgets.
BitBudgetError` the moment any intermediate of the *exact* integer
computation could leave int32.

Soundness contract (tested by ``tests/test_torch_analysis_props.py``
against the port's own torch integer ops): for any
concrete input within the declared input range, the value the real
integer op computes lies inside the transferred ``IntRange``.  All
transfer endpoints are computed with exact Python integers through the
same staged arithmetic the kernels run (``rshift_round`` two-stage
dyadic, round-half-up), so the bounds are tight, not just safe — every
primitive here is monotone in its argument, which is what makes interval
endpoints exact.

Design grid: int8 *operands* are modeled at ±127 (``INT8``), matching
the repo-wide design contract (weights and activations are clipped to
±127 by ``quant.convert``; every ``acc_qmax`` is sized as ``k·127·127``).
The int8 container's ``-128`` corner is reachable only by feeding raw
int8 tensors built outside the quantizer; see docs/ANALYSIS.md ("The
−128 corner") for why it is excluded from certification.

The port's plans (``quant.plans``, ``core.*``) are NamedTuples of Python
ints and floats, as the reference's are, so every endpoint here is an
exact Python integer.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.budgets import (BitBudgetError, INT32_MAX,
                                          MAX_ROWSUM_LEN, bits_for,
                                          static_check)

# per-channel multipliers are bounded by the fit's mult_bits=15 contract:
# fit_dyadic folds any rounding spill, so b <= 2^15 - 1, and
# quant.convert derives channel multipliers from the worst-channel fit —
# never larger
PER_CHANNEL_B_MAX = (1 << 15) - 1


def rshift_round_int(x: int, s: int) -> int:
    """Exact Python twin of ``core.dyadic.rshift_round`` (round-half-up
    arithmetic shift; Python's ``>>`` floors, as torch's does)."""
    if s == 0:
        return int(x)
    if s < 0:
        return int(x) << (-s)
    return (int(x) + (1 << (s - 1))) >> s


@dataclasses.dataclass(frozen=True)
class IntRange:
    """Closed interval of int32 values: ``lo <= q <= hi``."""

    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty IntRange [{self.lo}, {self.hi}]")

    # ------------------------------------------------------ constructors --

    @classmethod
    def const(cls, v: int) -> "IntRange":
        return cls(int(v), int(v))

    @classmethod
    def symmetric(cls, qmax: int) -> "IntRange":
        return cls(-int(qmax), int(qmax))

    # ------------------------------------------------------- properties --

    @property
    def qmax(self) -> int:
        """Worst-case magnitude |q|."""
        return max(abs(self.lo), abs(self.hi))

    @property
    def bits(self) -> int:
        """Signed bits needed to hold the range (sign bit included)."""
        return bits_for(self.qmax) + 1

    @property
    def headroom_bits(self) -> int:
        """How many doublings until the range leaves int32."""
        return 32 - self.bits

    # ------------------------------------------------------- arithmetic --

    def add(self, other: "IntRange") -> "IntRange":
        return IntRange(self.lo + other.lo, self.hi + other.hi)

    def scale(self, m: int) -> "IntRange":
        """Multiply by a non-negative constant."""
        assert m >= 0, m
        return IntRange(self.lo * m, self.hi * m)

    def neg_abs(self) -> "IntRange":
        """Range of ``-|q|``."""
        return IntRange(-self.qmax, 0 if self.lo <= 0 <= self.hi
                        else -min(abs(self.lo), abs(self.hi)))

    def clamp(self, lo: int, hi: int) -> "IntRange":
        return IntRange(min(max(self.lo, lo), hi), min(max(self.hi, lo), hi))


#: the design-grid int8 operand range (see module docstring)
INT8 = IntRange.symmetric(127)

#: the packed-nibble operand grid: sub-8-bit weights and int4 KV codes
#: store two's-complement nibbles clipped to ±7 (never −8) by
#: ``quant.pack`` / ``ops.packed.quantize_kv``
INT4 = IntRange.symmetric(7)

#: msr4 outlier-lane delta bound on the ±127 design grid:
#: ``delta = w − clip(w, −7, 7)`` so ``|delta| <= 127 − 7``; each lane
#: row is distinct within its group, and element-wise
#: ``|nib| + |delta| == |w| <= 127``, which is why the split accumulator
#: pieces never exceed the dense ``k·127·127`` budget
MSR4_DELTA_MAX = 127 - 7

#: static per-page requant shift of the int4 KV tier — the import-cycle-
#: free twin of ``repro_torch.ops.packed.KV_SHIFT`` (equality is asserted
#: by ``tests/test_torch_analysis.py``)
KV4_SHIFT = 4

#: the dequantized int4 KV operand range: pages store
#: ``clip(rshift_round(v, KV4_SHIFT), −7, 7)`` and the kernels unpack to
#: ``q4 << KV4_SHIFT`` — magnitude ≤ 7·2⁴ = 112, inside the int8 grid
INT4_KV = IntRange.symmetric(7 << KV4_SHIFT)


def _tag(what, op, layer):
    return dict(op=op, layer=layer) if (op or layer) else {}


# ======================================================================
# primitive transfer functions
# ======================================================================

def t_rshift_round(r: IntRange, s: int, what: str = "rshift_round",
                   op=None, layer=None) -> IntRange:
    """``rshift_round`` is monotone; the rounding addend itself must fit."""
    if s > 0:
        static_check(r.hi + (1 << (s - 1)), f"{what} rounding addend",
                     op=op, layer=layer)
    return IntRange(rshift_round_int(r.lo, s), rshift_round_int(r.hi, s))


def t_clip(r: IntRange, out_bits: int, design_grid: bool = True) -> IntRange:
    """``clip_to_bits``.  ``design_grid=True`` returns the symmetric
    ±(2^(b-1)−1) operand grid (the repo's matmul-operand contract);
    ``False`` keeps the exact container range including −2^(b-1)."""
    hi = (1 << (out_bits - 1)) - 1
    lo = -hi if design_grid else -(1 << (out_bits - 1))
    return r.clamp(lo, hi)


def t_dyadic(r: IntRange, dn, what: str = "dyadic requant",
             op=None, layer=None) -> IntRange:
    """Two-stage dyadic requant ``rr(rr(q, pre) · b, c−pre)``.

    The certifying check is *actual staging safety at the incoming
    worst-case range* — the product of the pre-shifted input with ``b``
    plus the rounding addend must fit int32 (``fit_dyadic``'s
    ``prod_max`` invariant, re-proved here against the analyzer's range
    rather than the constructor's declared ``qmax_in``, which may be
    smaller than the true reachable range; see docs/ANALYSIS.md)."""
    q = r.qmax
    half2 = 1 << max(0, dn.c - dn.pre - 1)
    static_check(((q >> dn.pre) + 1) * dn.b + half2,
                 f"{what} staging product (b={dn.b}, c={dn.c}, "
                 f"pre={dn.pre}, qmax={q})", op=op, layer=layer)
    if dn.pre > 0:
        static_check(q + (1 << (dn.pre - 1)), f"{what} pre-shift addend",
                     op=op, layer=layer)

    def f(v):
        return rshift_round_int(rshift_round_int(v, dn.pre) * dn.b,
                                dn.c - dn.pre)

    return IntRange(f(r.lo), f(r.hi))


def t_dyadic_perchannel(r: IntRange, c: int, pre: int,
                        b_max: int = PER_CHANNEL_B_MAX,
                        what: str = "per-channel requant",
                        op=None, layer=None) -> IntRange:
    """Per-channel staging with the worst-case multiplier ``b_max``."""
    q = r.qmax
    half2 = 1 << max(0, c - pre - 1)
    static_check(((q >> pre) + 1) * b_max + half2,
                 f"{what} staging product (b_max={b_max}, c={c}, "
                 f"pre={pre}, qmax={q})", op=op, layer=layer)
    if pre > 0:
        static_check(q + (1 << (pre - 1)), f"{what} pre-shift addend",
                     op=op, layer=layer)

    def f(v):
        return rshift_round_int(rshift_round_int(v, pre) * b_max, c - pre)

    return IntRange(f(r.lo), f(r.hi))


def t_requant_spec(r: IntRange, spec, b_max: int = PER_CHANNEL_B_MAX,
                   what: str = "requant epilogue", op=None,
                   layer=None) -> IntRange:
    """Transfer through a :class:`repro_torch.ops.RequantSpec` epilogue."""
    if spec.is_raw:
        return r
    if spec.dn is not None:          # per-tensor
        out = t_dyadic(r, spec.dn, what=what, op=op, layer=layer)
    else:                            # per-channel
        out = t_dyadic_perchannel(r, spec.c, spec.pre, b_max=b_max,
                                  what=what, op=op, layer=layer)
    return t_clip(out, spec.out_bits, design_grid=False)


def t_matmul_acc(k_dim: int, x: IntRange = INT8, w_qmax: int = 127,
                 bias: IntRange | None = None,
                 what: str = "matmul accumulator", op=None,
                 layer=None) -> IntRange:
    """int8·int8 → int32 accumulation over ``k_dim`` plus optional bias."""
    acc = IntRange.symmetric(
        static_check(k_dim * x.qmax * w_qmax, what, op=op, layer=layer))
    if bias is not None:
        acc = acc.add(bias)
        static_check(acc.qmax, f"{what} + bias", op=op, layer=layer)
    return acc


# ======================================================================
# composite transfer functions (the core integer pipelines)
# ======================================================================

def t_iexp(plan, what: str = "i-exp", op=None, layer=None) -> IntRange:
    """Output range of ``intmath.i_exp`` for any admissible input.

    The polynomial peak sits at p = 0: ``t = q_b``, ``q_l = q_b² + q_c``
    — the same product ``make_iexp`` statically checks; z-shifts only
    shrink it, and ``q_l >= q_c > 0`` throughout the band."""
    peak = static_check(plan.q_b * plan.q_b + plan.q_c,
                        f"{what} polynomial", op=op, layer=layer)
    static_check(plan.z_max * plan.q_ln2, f"{what} range clip",
                 op=op, layer=layer)
    return IntRange(0, peak)


def t_softmax(sm, score: IntRange, rowlen: int, exact_rowsum: bool = True,
              op=None, layer=None) -> IntRange:
    """``core.softmax.i_softmax`` over rows of ``rowlen`` int32 scores.

    Proves, in pipeline order: the exact max-subtract has headroom
    (``2·qmax_score`` fits); the requantized e16 values fit; the exact
    row sum fits (and, when ``exact_rowsum``, that ``rowlen`` is within
    the ``MAX_ROWSUM_LEN`` kernel budget); and the normalisation product
    ``e16·r`` fits (``e16 <= sum`` elementwise and ``r = 2^30 // sum``,
    so the product is ≤ 2^30 + the rounding addend).  Returns the int8
    probability range [0, 127]."""
    static_check(2 * score.qmax, "softmax max-subtract headroom",
                 op=op, layer=layer)
    # (q - max) clipped to the i-exp band, requantized to S_SM
    sub = IntRange(-sm.q_band, 0)
    q_sm = t_dyadic(sub, sm.dn_in, what="softmax score dyadic",
                    op=op, layer=layer)
    assert q_sm.hi <= 0, q_sm
    e_raw = t_iexp(sm.iexp, what="softmax i-exp", op=op, layer=layer)
    e16 = t_dyadic(e_raw, sm.dn_e16, what="softmax e16 dyadic",
                   op=op, layer=layer)
    if exact_rowsum:
        static_check(rowlen, "softmax row length", budget=MAX_ROWSUM_LEN,
                     op=op, layer=layer)
        static_check(rowlen * e16.hi, "softmax row sum", op=op, layer=layer)
    # p = rr(e16 * r, 23): e16 <= s and r = 2^30 // s, so e16*r <= 2^30;
    # the rounding addend rides on top
    from repro_torch.core.softmax import PROB_SHIFT, RECIP_BITS
    static_check((1 << RECIP_BITS) + (1 << (RECIP_BITS - PROB_SHIFT - 1)),
                 "softmax normalisation product", op=op, layer=layer)
    return IntRange(0, 127)


def prob_rowsum_max(rowlen: int) -> int:
    """Worst-case Σ p8 over a row: the probabilities sum to ≤ 2^7 before
    rounding, and each of the ``rowlen`` round-half-up requants adds at
    most 1/2 — the P·V accumulator bound ``(2^7 + rowlen/2)·127``."""
    from repro_torch.core.softmax import PROB_SHIFT
    return (1 << PROB_SHIFT) + (rowlen + 1) // 2


def t_attention_acc(rowlen: int, v_qmax: int = 127,
                    op=None, layer=None) -> IntRange:
    """The int32 P·V accumulator range (scale ``2^-7 · s_v``)."""
    return IntRange.symmetric(
        static_check(prob_rowsum_max(rowlen) * v_qmax,
                     "attention P*V accumulator", op=op, layer=layer))


def t_gelu(plan, r: IntRange, op=None, layer=None) -> IntRange:
    """``activations.i_gelu_act``: erf polynomial + x·(erf+1) product +
    output dyadic, clipped to int8."""
    static_check(r.qmax, "i-gelu input range", budget=plan.gelu.qmax_in,
                 op=op, layer=layer)
    erf = plan.gelu.erf
    static_check(erf.q_clip * erf.q_clip + abs(erf.q_c),
                 "i-erf polynomial", op=op, layer=layer)
    prod = IntRange.symmetric(
        static_check(r.qmax * 2 * plan.gelu.q_one, "i-gelu product",
                     op=op, layer=layer))
    out = t_dyadic(prod, plan.dn_out, what="i-gelu output dyadic",
                   op=op, layer=layer)
    return t_clip(out, 8)


def t_silu(plan, r: IntRange, op=None, layer=None) -> IntRange:
    """``activations.i_silu``: q·sig16 needs bits(q) + 16 ≤ 31."""
    from repro_torch.core.activations import SIG_FRAC
    static_check(r.qmax, "i-silu input range", budget=plan.qmax_in,
                 op=op, layer=layer)
    static_check(r.qmax << (SIG_FRAC + 1), "i-silu gate product",
                 op=op, layer=layer)
    prod = IntRange.symmetric(r.qmax << SIG_FRAC)
    out = t_dyadic(prod, plan.dn_out, what="i-silu output dyadic",
                   op=op, layer=layer)
    return t_clip(out, 8)


def t_layernorm(plan, r: IntRange, out_bits: int = 8, beta_abs: float = 2.0,
                op=None, layer=None) -> IntRange:
    """``norms.i_norm``: re-proves every phase budget of ``make_inorm``
    against the analyzer's input range (not the declared ``qmax_in``).

    ``beta_abs``: design bound on |beta| in real units (folded bias)."""
    q = static_check(r.qmax, "i-norm input range", budget=plan.qmax_in,
                     op=op, layer=layer)
    d, s, k = plan.d, plan.pre_shift, plan.recip_bits
    if plan.subtract_mean:
        static_check(d * q, "i-norm mean sum", op=op, layer=layer)
        mu = t_dyadic(IntRange.symmetric(d * q), plan.dn_mean,
                      what="i-norm mean dyadic", op=op, layer=layer)
        y_max = q + mu.qmax                      # centred values
    else:
        y_max = q                                # RMSNorm: y = q
    static_check(d * ((y_max >> s) ** 2), "i-norm variance sum",
                 op=op, layer=layer)
    t_dyadic(IntRange(0, d * ((y_max >> s) ** 2)), plan.dn_var,
             what="i-norm variance dyadic", op=op, layer=layer)
    # r = 2^(k+s) // sigma_s with sigma_s >= 1 -> r <= 2^(k+s); the
    # normalisation product y*r plus its 2s rounding addend must fit
    static_check((y_max << (k + s)) + (1 << max(0, 2 * s - 1)),
                 "i-norm normalisation product", op=op, layer=layer)
    # |n| <= sqrt(d) mathematically (sigma^2 >= y_i^2/d); make_inorm
    # declares that design bound as dn_out.qmax_in = n_q_max * 127 —
    # certified at the declared bound (an assumption the walk records)
    n_q = plan.dn_out.qmax_in // 127
    q_beta = int(beta_abs / plan.q_beta_scale) if plan.subtract_mean else 0
    scaled = static_check(n_q * 127 + q_beta, "i-norm gamma/beta product",
                          op=op, layer=layer)
    out = t_dyadic(IntRange.symmetric(scaled), plan.dn_out,
                   what="i-norm output dyadic", op=op, layer=layer)
    return t_clip(out, out_bits)


# ======================================================================
# plan-tree audit
# ======================================================================

def iter_dyadics(obj, prefix: str = ""):
    """Yield ``(path, Dyadic)`` for every dyadic in a plan tree
    (NamedTuples / dataclasses / sequences), e.g. the whole
    ``quant.plans.LayerPlans`` including the Mamba branch."""
    from repro_torch.core.dyadic import Dyadic
    if obj is None:
        return
    if isinstance(obj, Dyadic):
        yield prefix or "dyadic", obj
        return
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        for name in obj._fields:
            yield from iter_dyadics(getattr(obj, name),
                                    f"{prefix}.{name}" if prefix else name)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from iter_dyadics(getattr(obj, f.name),
                                    f"{prefix}.{f.name}" if prefix else f.name)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from iter_dyadics(v, f"{prefix}[{i}]")


def audit_dyadics(obj, prefix: str = "", op=None, layer=None) -> int:
    """Re-prove the staging invariant of every dyadic in a plan tree at
    its declared ``qmax_in`` — catches hand-built ``Dyadic`` constants
    that drifted from the ``fit_dyadic`` contract.  Returns the count."""
    n = 0
    for path, dn in iter_dyadics(obj, prefix):
        t_dyadic(IntRange.symmetric(dn.qmax_in), dn, what=path,
                 op=op, layer=layer or path)
        n += 1
    return n


__all__ = [
    "INT4", "INT4_KV", "INT8", "IntRange", "KV4_SHIFT",
    "MSR4_DELTA_MAX", "PER_CHANNEL_B_MAX", "BitBudgetError",
    "INT32_MAX", "audit_dyadics", "iter_dyadics", "prob_rowsum_max",
    "rshift_round_int", "t_attention_acc", "t_clip", "t_dyadic",
    "t_dyadic_perchannel", "t_gelu", "t_iexp", "t_layernorm",
    "t_matmul_acc", "t_requant_spec", "t_rshift_round", "t_silu",
    "t_softmax",
]
