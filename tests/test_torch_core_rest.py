"""The rest of ``core``, ``analysis.budgets.bits_for`` and the ops
registry's protocol in the port == the JAX package.

  * ``intmath.i_poly2`` (several coefficient signs, a zero term),
    ``i_ln1p`` and ``activations.i_softplus`` (Mamba's Δt plan and the
    reference test's) over their whole input domains, plans equal;
  * ``dyadic.rshift_floor``, ``requantize`` and ``apply_dyadic_exact_np``
    on seeded int32 over the whole range, every shift and out_bits;
  * ``core.quant`` (``qrange``, ``scale_from_absmax``, ``quantize``,
    ``dequantize``, ``fake_quant`` with its straight-through gradient,
    ``per_channel_absmax``, ``CalibStats``, ``ema_absmax``) on seeded
    floats, with the device given;
  * ``bits_for`` (both homes);
  * the registry: ``REQUIRED_OPS``, the runtime-checkable ``Backend``
    protocol, ``register_backend`` refusing a non-backend and a taken
    name unless ``overwrite``, lazy factories, ``unregister_backend``.

Inputs are numpy draws from fixed seeds.  Tolerance: 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import ops as jops
from repro.analysis import budgets as j_budgets
from repro.core import activations as j_act
from repro.core import dyadic as j_dy
from repro.core import intmath as j_im
from repro.core import quant as j_quant
from repro_torch import ops as tops
from repro_torch.analysis import budgets as t_budgets
from repro_torch.core import activations as t_act
from repro_torch.core import dyadic as t_dy
from repro_torch.core import intmath as t_im
from repro_torch.core import quant as t_quant
from repro_torch.interop import plan_from_reference

T = torch.as_tensor


def _same(got, want):
    assert np.array_equal(np.asarray(got), np.asarray(want))


# ----------------------------------------------------- poly / ln1p -------

@pytest.mark.parametrize("coeffs,s_in,s_out,qmax", [
    (t_im.LN1P_COEFS, 2.0 ** -15, 2.0 ** -12, 1 << 15),
    ((0.5, -1.25, 0.75), 1 / 256, 1 / 1024, 4096),
    ((-0.3, 0.0, 2.0), 1 / 512, 1 / 2048, 40000),
    ((0.0, 1.5, -0.25), 1 / 128, 1 / 512, 1000),
])
def test_i_poly2_matches_reference(coeffs, s_in, s_out, qmax):
    assert t_im.LN1P_COEFS == j_im.LN1P_COEFS
    jp = j_im.make_ipoly2(coeffs, s_in, s_out, qmax)
    tp = t_im.make_ipoly2(coeffs, s_in, s_out, qmax)
    assert plan_from_reference(jp) == tp
    q = np.arange(-qmax, qmax + 1, dtype=np.int32)
    for sign in (1, -1):
        _same(t_im.i_poly2(T(q), tp, sign).numpy(),
              j_im.i_poly2(jnp.asarray(q), jp, sign))


@pytest.mark.parametrize("s_out", [2.0 ** -12, 16 / 2 ** 13])
def test_i_ln1p_matches_reference(s_out):
    jp = j_im.make_iln1p(2.0 ** -15, s_out, 1 << 15)
    tp = t_im.make_iln1p(2.0 ** -15, s_out, 1 << 15)
    assert plan_from_reference(jp) == tp
    q = np.arange(-300, (1 << 15) + 300, dtype=np.int32)   # clips both ends
    got = t_im.i_ln1p(T(q), tp)
    assert got.dtype == torch.int32
    _same(got.numpy(), j_im.i_ln1p(jnp.asarray(q), jp))


@pytest.mark.parametrize("s_in,qmax,s_out,out_bits", [
    (16.0 / 1024.0, 1024, 1.0 / (1 << 12), 13),     # Mamba's Δt plan
    (16 / 1024, 1024, 16 / 2 ** 13, 16),
])
def test_i_softplus_matches_reference(s_in, qmax, s_out, out_bits):
    jp = j_act.make_isoftplus(s_in, qmax, s_out=s_out)
    tp = t_act.make_isoftplus(s_in, qmax, s_out=s_out)
    assert plan_from_reference(jp) == tp
    q = np.arange(-(1 << 16), 1 << 16, dtype=np.int32)     # past qmax too
    got = t_act.i_softplus(T(q), tp, out_bits)
    assert got.dtype == torch.int32
    _same(got.numpy(), j_act.i_softplus(jnp.asarray(q), jp, out_bits))


# ---------------------------------------------------------- dyadic -------

def _int32(seed, n=200_000):
    rng = np.random.default_rng(seed)
    q = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    return np.concatenate([q, [-2 ** 31, 2 ** 31 - 1, -1, 0, 1]]
                          ).astype(np.int32)


@pytest.mark.parametrize("s", [-3, 0, 1, 7, 15, 31])
def test_rshift_floor_matches_reference(s):
    q = _int32(s + 40)
    if s < 0:
        q = q >> 4                        # an exact left shift: no overflow
    _same(t_dy.rshift_floor(T(q), s).numpy(),
          j_dy.rshift_floor(jnp.asarray(q), s))


@pytest.mark.parametrize("ratio,qmax,out_bits", [
    (1 / 3000.0, 4096 * 127 * 127, 8), (0.37, 1 << 20, 16),
    (2.5, 1 << 13, 8), (1 / 7.0, 2 ** 31 - 1, 4)])
def test_requantize_matches_reference(ratio, qmax, out_bits):
    rng = np.random.default_rng(int(qmax % 1000))
    q = rng.integers(-qmax, qmax + 1, 100_000).astype(np.int32)
    got = t_dy.requantize(T(q), ratio, qmax, out_bits)
    assert got.dtype == torch.int32
    _same(got.numpy(), j_dy.requantize(jnp.asarray(q), ratio, qmax,
                                       out_bits))


@pytest.mark.parametrize("ratio,qmax", [(1 / 3000.0, 4096 * 127 * 127),
                                        (0.37, 1 << 20), (3.0, 1 << 12)])
def test_apply_dyadic_exact_np_matches_reference(ratio, qmax):
    jd, td = j_dy.fit_dyadic(ratio, qmax), t_dy.fit_dyadic(ratio, qmax)
    assert plan_from_reference(jd) == td
    q = np.random.default_rng(3).integers(-qmax, qmax + 1, 100_000
                                          ).astype(np.int32)
    got = t_dy.apply_dyadic_exact_np(q, td)
    assert got.dtype == np.int64
    _same(got, j_dy.apply_dyadic_exact_np(q, jd))


def test_bits_for_matches_reference():
    for v in list(range(-3, 70)) + [2 ** k + d for k in range(8, 40)
                                    for d in (-1, 0, 1)]:
        want = j_budgets.bits_for(v)
        assert want == j_dy.bits_for(v)
        assert t_budgets.bits_for(v) == t_dy.bits_for(v) == want


# ----------------------------------------------------------- quant -------

def test_qrange_and_scales_match_reference():
    for bits in (2, 4, 8, 16):
        assert t_quant.qrange(bits) == j_quant.qrange(bits)
        for a in (0.0, 1e-9, 0.5, 3.75, 1e4):
            assert t_quant.scale_from_absmax(a, bits) == \
                j_quant.scale_from_absmax(a, bits)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_dequantize_fake_quant_match_reference(bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((64, 48)) * 3).astype(np.float32)
    x[0, :8] = [0.5, 1.5, -0.5, -2.5, 100.0, -100.0, 0.0, 2.5]
    scale = 0.0625 if bits == 8 else 0.37
    q = t_quant.quantize(x, scale, bits, device="cpu")
    assert q.dtype == torch.int32 and q.device.type == "cpu"
    _same(q.numpy(), j_quant.quantize(jnp.asarray(x), scale, bits))
    _same(t_quant.dequantize(q, scale).numpy(),
          j_quant.dequantize(jnp.asarray(q.numpy()), scale))
    want = j_quant.fake_quant(jnp.asarray(x), scale, bits)
    xt = T(x).clone().requires_grad_(True)
    got = t_quant.fake_quant(xt, scale, bits)
    _same(got.detach().numpy(), want)
    got.sum().backward()
    jgrad = jax.grad(lambda a: j_quant.fake_quant(a, scale, bits).sum())(
        jnp.asarray(x))
    _same(xt.grad.numpy(), jgrad)
    # a per-channel scale tensor
    sc = (np.abs(x).max(axis=0) / 127 + 1e-3).astype(np.float32)
    _same(t_quant.fake_quant(T(x), T(sc), bits).numpy(),
          j_quant.fake_quant(jnp.asarray(x), jnp.asarray(sc), bits))


def test_calibration_helpers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 9)).astype(np.float32)
    for axis in (0, 1, -1):
        _same(t_quant.per_channel_absmax(x, axis, device="cpu").numpy(),
              j_quant.per_channel_absmax(jnp.asarray(x), axis))
    js, ts = j_quant.CalibStats(), t_quant.CalibStats()
    prev_j = prev_t = 0.0
    for i in range(4):
        xi = x[i] * (i + 1)
        js, ts = js.update(jnp.asarray(xi)), ts.update(T(xi))
        prev_j = j_quant.ema_absmax(prev_j, jnp.asarray(xi))
        prev_t = t_quant.ema_absmax(prev_t, T(xi))
        assert (ts.absmax, ts.n) == (js.absmax, js.n)
        assert prev_t == prev_j
    assert ts.scale(8, 1.1) == js.scale(8, 1.1)


# -------------------------------------------------------- registry -------

class _Toy:
    """The ``cuda`` backend's ops under another name."""
    fused_attention = True

    def __init__(self, name="toy"):
        self.name = name
        self._be = tops.get_backend("cuda")

    def __getattr__(self, op):
        return getattr(self._be, op)


def test_required_ops_and_protocol_match_reference():
    assert tops.REQUIRED_OPS == jops.REQUIRED_OPS
    assert tops.OP_NAMES == jops.OP_NAMES
    for name in tops.available_backends():
        be = tops.get_backend(name)
        assert isinstance(be, tops.Backend), name
    assert not isinstance(object(), tops.Backend)


def test_register_overwrite_and_unregister():
    from repro_torch.ops.registry import _is_backend
    toy = _Toy()
    assert _is_backend(toy) and not _is_backend(_Toy)
    with pytest.raises(TypeError, match="neither the Backend"):
        tops.register_backend("toy_bad", 42)
    tops.register_backend("toy", toy)
    try:
        assert tops.get_backend("toy") is toy
        assert "toy" in tops.available_backends()
        with pytest.raises(ValueError, match="already registered"):
            tops.register_backend("toy", _Toy())
        other = _Toy()
        tops.register_backend("toy", other, overwrite=True)
        assert tops.get_backend("toy") is other
        assert tops.OpSet("toy").name == "toy"
        with pytest.raises(ValueError, match="already registered"):
            tops.register_backend("cuda", _Toy("cuda"))
    finally:
        tops.unregister_backend("toy")
    assert "toy" not in tops.available_backends()
    with pytest.raises(KeyError, match="unknown backend"):
        tops.get_backend("toy")
    tops.unregister_backend("toy")            # absent: a no-op
    with pytest.raises(TypeError, match="cannot interpret"):
        tops.OpSet(3.5)


def test_lazy_factory_is_instantiated_once():
    made = []

    def factory():
        made.append(_Toy("lazy"))
        return made[-1]

    tops.register_backend("lazy", factory)
    try:
        assert not made
        a, b = tops.get_backend("lazy"), tops.get_backend("lazy")
        assert a is b is made[0] and len(made) == 1
        tops.register_backend("lazy_bad", lambda: object())
        with pytest.raises(TypeError, match="non-Backend"):
            tops.get_backend("lazy_bad")
    finally:
        tops.unregister_backend("lazy")
        tops.unregister_backend("lazy_bad")
