"""Port core numerics == the JAX reference, bit for bit.

Dyadic requant, i-exp, the integer sqrt, Shiftmax, the integer norms and
i-SiLU of ``repro_torch.core`` against ``repro.core`` on the same int32
inputs (numpy seeds), random and extreme (-128, 127, int32 edges).
Tolerance: 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import activations as j_act
from repro.core import attention as j_attn
from repro.core import dyadic as j_dy
from repro.core import intmath as j_im
from repro.core import norms as j_norms
from repro.core import softmax as j_sm
from repro_torch.core import activations as t_act
from repro_torch.core import attention as t_attn
from repro_torch.core import dyadic as t_dy
from repro_torch.core import intmath as t_im
from repro_torch.core import norms as t_norms
from repro_torch.core import softmax as t_sm
from repro_torch.interop import plan_from_reference

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
EDGES = np.array([0, 1, -1, 127, -127, -128, 128, 255, -255, 46340, 46341,
                  2 ** 15, -2 ** 15, 2 ** 30, -2 ** 30, I32_MAX, I32_MIN,
                  I32_MAX - 1, I32_MIN + 1], np.int32)


def _ints(seed, n, lo=I32_MIN, hi=I32_MAX):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(lo, hi, n, dtype=np.int64)
                           .astype(np.int32)])


def _j(fn, a):
    return np.asarray(fn(jnp.asarray(a)))


def _t(fn, a):
    return fn(torch.as_tensor(a)).numpy()


def test_int32_semantics_match_jax():
    """The three int32 semantics every port module relies on: wrapping
    add/multiply, arithmetic right shift, floor division."""
    a = _ints(0, 2000)
    b = np.roll(a, 7)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal((ta + tb).numpy(), np.asarray(ja + jb))
    assert np.array_equal((ta * tb).numpy(), np.asarray(ja * jb))
    for s in (1, 7, 23, 31):
        assert np.array_equal((ta >> s).numpy(), np.asarray(ja >> s))
    nz = np.where(b == 0, 3, b)
    got = torch.div(ta, torch.as_tensor(nz), rounding_mode="floor").numpy()
    assert np.array_equal(got[a != I32_MIN], np.asarray(
        ja // jnp.asarray(nz))[a != I32_MIN])


@pytest.mark.parametrize("s", [-3, 0, 1, 5, 15, 23, 30])
def test_rshift_round(s):
    a = _ints(1, 3000)
    assert np.array_equal(_t(lambda x: t_dy.rshift_round(x, s), a),
                          _j(lambda x: j_dy.rshift_round(x, s), a))


@pytest.mark.parametrize("ratio,qmax", [(1 / 3000.0, 4096 * 127 * 127),
                                        (0.0157, 1 << 20), (2.5, 1 << 10),
                                        (1.0 / 128, 128 * 8192),
                                        (3.0e-6, 1 << 30)])
def test_fit_and_apply_dyadic(ratio, qmax):
    jd = j_dy.fit_dyadic(ratio, qmax)
    td = t_dy.fit_dyadic(ratio, qmax)
    assert plan_from_reference(jd) == td
    a = _ints(2, 3000, -qmax, qmax)
    assert np.array_equal(_t(td, a), _j(jd, a))
    bits = 11
    assert np.array_equal(
        _t(lambda x: t_dy.clip_to_bits(td(x), bits), a),
        _j(lambda x: j_dy.clip_to_bits(jd(x), bits), a))


def test_apply_dyadic_perchannel():
    rng = np.random.default_rng(3)
    q = rng.integers(-2 ** 26, 2 ** 26, (8, 64)).astype(np.int32)
    b = rng.integers(1, 2 ** 15, (64,)).astype(np.int32)
    got = t_dy.apply_dyadic_perchannel(torch.as_tensor(q),
                                       torch.as_tensor(b), 24, 9).numpy()
    want = np.asarray(j_dy.apply_dyadic_perchannel(jnp.asarray(q),
                                                   jnp.asarray(b), 24, 9))
    assert np.array_equal(got, want)


def test_i_sqrt_exact_and_equal():
    a = _ints(4, 20000)
    sq = np.arange(0, 46341, 97, dtype=np.int64)
    a = np.concatenate([a, (sq * sq).astype(np.int32),
                        (sq * sq - 1).clip(0).astype(np.int32),
                        (sq * sq + 1).clip(0, I32_MAX).astype(np.int32)])
    got = _t(t_im.i_sqrt, a)
    assert np.array_equal(got, _j(j_im.i_sqrt, a))
    pos = a > 0
    ref = np.floor(np.sqrt(a[pos].astype(np.float64))).astype(np.int64)
    assert np.array_equal(got[pos], ref)


def test_int_bit_length():
    a = _ints(5, 3000, 0, I32_MAX)
    assert np.array_equal(_t(t_im.int_bit_length, a),
                          _j(j_im.int_bit_length, a))


@pytest.mark.parametrize("s_in", [2.0 ** -14, 16.0 / 1024.0, 0.001])
def test_i_exp(s_in):
    jp, tp = j_im.make_iexp(s_in), t_im.make_iexp(s_in)
    assert plan_from_reference(jp) == tp
    a = _ints(6, 5000, -40 * jp.q_ln2, 10)
    assert np.array_equal(_t(lambda x: t_im.i_exp(x, tp), a),
                          _j(lambda x: j_im.i_exp(x, jp), a))


@pytest.mark.parametrize("hd", [32, 128])
def test_shiftmax_and_attention_plans(hd):
    s8 = 8 / 127
    jp = j_attn.make_iattention(hd, s8, s8, s8, s8)
    tp = t_attn.make_iattention(hd, s8, s8, s8, s8)
    assert plan_from_reference(jp) == tp
    rng = np.random.default_rng(7)
    scores = rng.integers(-hd * 127 * 127, hd * 127 * 127,
                          (4, 3, 50)).astype(np.int32)
    scores[0, 0] = hd * 127 * 127                    # saturated row
    mask = rng.random((4, 3, 50)) < 0.7
    mask[1, 2] = False                               # fully masked row
    got = t_sm.i_softmax(torch.as_tensor(scores), tp.sm,
                         where=torch.as_tensor(mask)).numpy()
    want = np.asarray(j_sm.i_softmax(jnp.asarray(scores), jp.sm,
                                     where=jnp.asarray(mask)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("layernorm", [False, True])
def test_int_norm(layernorm):
    d, qmax = 128, 1 << 13
    jp = j_norms.make_inorm(d, 2.0 ** -9, qmax, 2 / 127, 8 / 127,
                            subtract_mean=layernorm)
    tp = t_norms.make_inorm(d, 2.0 ** -9, qmax, 2 / 127, 8 / 127,
                            subtract_mean=layernorm)
    assert plan_from_reference(jp) == tp
    rng = np.random.default_rng(8)
    q = rng.integers(-qmax, qmax + 1, (12, d)).astype(np.int32)
    q[0] = qmax                                      # constant row
    q[1] = -qmax
    q[2, ::2], q[2, 1::2] = qmax, -qmax              # extreme spread
    q[3] = 0
    gamma = rng.normal(1.0, 0.3, d).astype(np.float32)
    beta = rng.normal(0.0, 0.1, d).astype(np.float32) if layernorm else None
    jg, jb = j_norms.quantize_norm_weights(
        jnp.asarray(gamma), None if beta is None else jnp.asarray(beta), jp)
    tg, tb = t_norms.quantize_norm_weights(
        torch.as_tensor(gamma), None if beta is None
        else torch.as_tensor(beta), tp)
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    if layernorm:
        assert np.array_equal(tb.numpy(), np.asarray(jb))
    got = t_norms.i_norm(torch.as_tensor(q), tg, tb, tp).numpy()
    want = np.asarray(j_norms.i_norm(jnp.asarray(q), jg, jb, jp))
    assert np.array_equal(got, want)


def test_i_silu():
    jp = j_act.make_isilu(16 / 1024, 1024, s_out=8 / 127)
    tp = t_act.make_isilu(16 / 1024, 1024, s_out=8 / 127)
    assert plan_from_reference(jp) == tp
    a = np.concatenate([np.arange(-1024, 1025, dtype=np.int32),
                        np.array([-128, 127, 2 ** 14, -2 ** 14], np.int32)])
    assert np.array_equal(_t(lambda x: t_act.i_silu(x, tp), a),
                          _j(lambda x: j_act.i_silu(x, jp), a))


def test_int_einsum_is_exact():
    """The float64 plain contraction equals an int64 one at K = 14336."""
    rng = np.random.default_rng(9)
    x = rng.integers(-128, 128, (3, 14336)).astype(np.int8)
    w = rng.integers(-128, 128, (14336, 5)).astype(np.int8)
    got = t_im.int_einsum("mk,kn->mn", torch.as_tensor(x),
                          torch.as_tensor(w)).numpy()
    want = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.int32)
    assert np.array_equal(got, want)
