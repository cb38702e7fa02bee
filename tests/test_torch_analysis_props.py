"""Soundness of the port's bit-budget abstract interpreter against the
port's own integer ops (``core.dyadic``, ``core.intmath.i_exp``,
``core.softmax``, ``core.activations``, ``core.norms``), as
``tests/test_analysis_props.py`` holds the reference's against JAX.

For any design constants the fitters produce and any concrete input
inside the declared range — endpoints forced — the value the torch op
computes lies inside the ``IntRange`` the transfer function predicts, and
no intermediate the transfer certified is exceeded by the concrete run
(checked in int64, where the op's int32 would wrap silently).  Hypothesis
settings are the reference file's or smaller.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis",
                    reason="property tests need hypothesis "
                           "(pip install -r requirements-dev.txt)")
from hypothesis import assume, given, settings, strategies as st

import numpy as np

from repro_torch.analysis.interpret import check_requant_spec
from repro_torch.analysis.ranges import (INT8, IntRange, rshift_round_int,
                                         t_dyadic, t_gelu, t_iexp,
                                         t_layernorm, t_matmul_acc, t_silu,
                                         t_softmax)
from repro_torch.core import intmath
from repro_torch.core.activations import (i_gelu_act, i_silu,
                                          make_igelu_act, make_isilu)
from repro_torch.core.dyadic import apply_dyadic, fit_dyadic, rshift_round
from repro_torch.core.norms import i_norm, make_inorm
from repro_torch.core.softmax import i_softmax, make_isoftmax
from repro_torch.ops.spec import RequantSpec


def _fitted(make, *args, **kw):
    """A plan the design-time fitter accepts (it refuses constants whose
    own static checks fail: those are no design the datapath runs)."""
    try:
        return make(*args, **kw)
    except ValueError:
        assume(False)


def _sample(qmax: int, picks):
    """Concrete int32 inputs: forced extremes + hypothesis-drawn interior."""
    return torch.tensor([-qmax, qmax, 0] + [max(-qmax, min(qmax, p))
                                            for p in picks],
                        dtype=torch.int32)


@given(ratio=st.floats(1e-6, 0.9), qmax=st.integers(2 ** 8, 2 ** 26),
       picks=st.lists(st.integers(-(2 ** 26), 2 ** 26), min_size=1,
                      max_size=32))
@settings(max_examples=200, deadline=None)
def test_fitted_dyadic_stays_in_predicted_range(ratio, qmax, picks):
    dn = fit_dyadic(ratio, qmax)
    r = t_dyadic(IntRange.symmetric(qmax), dn)
    q = _sample(qmax, picks)
    out = dn(q)                                   # the port's integer op
    assert int(out.min()) >= r.lo and int(out.max()) <= r.hi, (dn, r)
    for v in q.tolist():
        assert abs(rshift_round_int(v, dn.pre) * dn.b) <= 2 ** 31 - 1


@given(ratio=st.floats(1e-6, 0.9), qmax=st.integers(2 ** 8, 2 ** 24),
       out_bits=st.sampled_from([8, 16, 32]),
       picks=st.lists(st.integers(-(2 ** 24), 2 ** 24), min_size=1,
                      max_size=16))
@settings(max_examples=100, deadline=None)
def test_requant_spec_epilogue_soundness(ratio, qmax, out_bits, picks):
    dn = fit_dyadic(ratio, qmax)
    spec = RequantSpec.per_tensor(dn, out_bits=out_bits)
    r = check_requant_spec(spec, IntRange.symmetric(qmax),
                           op="int8_matmul", layer="prop")
    lo, hi = -(1 << (out_bits - 1)), (1 << (out_bits - 1)) - 1
    out = torch.clamp(apply_dyadic(_sample(qmax, picks), dn), lo, hi)
    assert int(out.min()) >= r.lo and int(out.max()) <= r.hi


@given(k=st.integers(1, 4096), picks=st.lists(st.integers(-127, 127),
                                              min_size=1, max_size=64))
@settings(max_examples=100, deadline=None)
def test_matmul_accumulator_soundness(k, picks):
    r = t_matmul_acc(k, INT8)
    x = _sample(127, picks).to(torch.int64)
    w = -x.flip(0)                                # adversarial signs
    n = min(k, len(x))
    acc = int(intmath.int_einsum("k,k->", x[:n].to(torch.int8),
                                 w[:n].to(torch.int8)))
    assert r.lo <= acc <= r.hi


# make_iexp's own static check rejects s_in finer than 2^-14 (q_b^2
# leaves int32): the admissible design band is [2^-14, 2^-10]
@given(exp=st.integers(10, 14), picks=st.lists(st.integers(-(2 ** 20), 0),
                                               min_size=1, max_size=32))
@settings(max_examples=100, deadline=None)
def test_iexp_output_within_predicted_range(exp, picks):
    plan = intmath.make_iexp(2.0 ** -exp)
    r = t_iexp(plan)
    q = torch.clamp(_sample(plan.z_max * plan.q_ln2, picks), max=0)
    out = intmath.i_exp(q, plan)
    assert int(out.min()) >= r.lo and int(out.max()) <= r.hi, (plan, r)


@given(scale_exp=st.integers(8, 14), qmax=st.integers(2 ** 10, 2 ** 22),
       rowlen=st.integers(1, 64), seed=st.integers(0, 2 ** 31 - 1))
@settings(max_examples=50, deadline=None)
def test_softmax_probs_within_predicted_range(scale_exp, qmax, rowlen,
                                              seed):
    plan = make_isoftmax(2.0 ** -scale_exp, qmax)
    r = t_softmax(plan, IntRange.symmetric(qmax), rowlen)
    rng = np.random.default_rng(seed)
    scores = rng.integers(-qmax, qmax + 1, size=(4, rowlen))
    scores[0, 0], scores[1, 0] = qmax, -qmax      # force the extremes
    p = i_softmax(torch.tensor(scores, dtype=torch.int32), plan)
    assert int(p.min()) >= r.lo and int(p.max()) <= r.hi
    assert rowlen * (1 << 15) <= 2 ** 31 - 1


@given(s_exp=st.integers(5, 9), qmax=st.integers(2 ** 6, 2 ** 12),
       picks=st.lists(st.integers(-(2 ** 12), 2 ** 12), min_size=1,
                      max_size=32))
@settings(max_examples=50, deadline=None)
def test_activations_within_predicted_range(s_exp, qmax, picks):
    """i-GELU and i-SiLU over their declared input range, to int8 at
    the FFN's output scale."""
    s_in, s_out = 2.0 ** -s_exp, 8 / 127
    q = _sample(qmax, picks)
    gelu = _fitted(make_igelu_act, s_in, qmax, s_out)
    r = t_gelu(gelu, IntRange.symmetric(qmax))
    out = i_gelu_act(q, gelu)
    assert int(out.min()) >= r.lo and int(out.max()) <= r.hi, (gelu, r)
    silu = _fitted(make_isilu, s_in, qmax, s_out)
    r = t_silu(silu, IntRange.symmetric(qmax))
    out = i_silu(q, silu)
    assert int(out.min()) >= r.lo and int(out.max()) <= r.hi, (silu, r)


@given(d=st.integers(8, 256), qmax_exp=st.integers(10, 18),
       mean=st.booleans(), seed=st.integers(0, 2 ** 31 - 1))
@settings(max_examples=50, deadline=None)
def test_norm_intermediates_within_certified_bounds(d, qmax_exp, mean,
                                                    seed):
    """The mean, the centred values and the variance sum that
    ``t_layernorm`` bounds, taken exactly (int64) through the port's own
    dyadic and shift ops on rows at the input range's extremes, stay
    within what it certified; the op's int8 output lies in the clip."""
    qmax = 1 << qmax_exp
    plan = _fitted(make_inorm, d, 2.0 ** -9, qmax, 2 / 127, 8 / 127,
                   subtract_mean=mean)
    out_r = t_layernorm(plan, IntRange.symmetric(qmax))
    rng = np.random.default_rng(seed)
    rows = rng.integers(-qmax, qmax + 1, size=(4, d))
    rows[0], rows[1, ::2] = qmax, -qmax           # force the extremes
    q = torch.tensor(rows, dtype=torch.int64)
    y_max = qmax
    y = q
    if mean:
        mu_r = t_dyadic(IntRange.symmetric(d * qmax), plan.dn_mean)
        mu = apply_dyadic(q.sum(dim=-1, keepdim=True), plan.dn_mean)
        assert int(mu.abs().max()) <= mu_r.qmax
        y = q - mu
        y_max = qmax + mu_r.qmax
    assert int(y.abs().max()) <= y_max
    ys = rshift_round(y, plan.pre_shift)
    var_sum = (ys * ys).sum(dim=-1)
    assert int(var_sum.max()) <= d * ((y_max >> plan.pre_shift) ** 2) \
        <= 2 ** 31 - 1
    gamma = torch.tensor(rng.integers(-127, 128, size=d), dtype=torch.int32)
    out = i_norm(q.to(torch.int32), gamma, None, plan)
    assert -128 <= int(out.min()) and int(out.max()) <= out_r.hi
