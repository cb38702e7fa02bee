"""K2's launch plan and the schedule of its Hopper kernel
(``csrc/int_layernorm.cu``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
Here: the plan the wrapper launches (warp route up to d = 1024, a CTA a
row past it; int4 vectors where the operands allow; the values a lane
holds, a template argument), checked for every width of the port's and
the reference's configs at 1 to 16 384 rows; the constants the plan
mirrors from the source; a numpy emulation of the kernel's schedule --
each thread's columns, the masked vector tail, the warp butterflies and
the block's sum of per-warp partials, the persistent grid's rows -- held
equal to :func:`int_layernorm_plain` on random and extreme rows; the
O(1) integer sqrt emulated in float32 and held equal to both packages'
``i_sqrt``; and the host's cache of the packed plan.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import intmath as j_intmath
from repro_torch.configs.registry import get_config
from repro_torch.core import intmath as t_intmath
from repro_torch.core import norms as inorms
from repro_torch.kernels import _abi
from repro_torch.kernels import int_layernorm as K2
from repro_torch.quant.plans import build_layer_plans

SRC = (Path(K2.__file__).resolve().parent.parent / "csrc"
       / "int_layernorm.cu").read_text()
SMS = 132
WIDTHS = (384, 768, 1024, 2048, 3840, 4096, 8192)


# ------------------------------------------------------------ the plan ----

def lane_columns(d, kp):
    """Each thread's columns ``(threads of a row, vpl)`` and which of them
    lie in the row: thread t's vector j is the row's vector j * stride +
    t, stride 32 on the warp route (a warp a row) and the CTA's threads
    on the block route."""
    lanes = 32 if kp.route == "warp" else kp.threads
    n = kp.values_per_lane // kp.vec
    v = (np.arange(n)[None, :, None] * lanes
         + np.arange(lanes)[:, None, None])
    col = v * kp.vec + np.arange(kp.vec)[None, None, :]
    valid = np.broadcast_to(v < d // kp.vec, col.shape)
    return (col.reshape(lanes, -1),
            valid.reshape(lanes, -1).copy())


def row_schedule(rows, kp):
    """The rows in the order the grid's warps (or CTAs) take them."""
    if kp.route == "block":
        return list(range(kp.grid))
    rpc = kp.rows_per_cta
    out = []
    for cta in range(kp.grid):
        for w in range(rpc):
            out.extend(range(cta * rpc + w, rows, kp.grid * rpc))
    return out


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", [1, 4, 128, 1024, 16384])
def test_k2_launch_plan(d, rows):
    """Every width of the configs, aligned or not: the warp route exactly
    up to d = 1024 with an instantiated VPL (the least that holds the
    row), the block route past it with 8 values a thread on the fewest
    whole warps; int4 vectors exactly where the operands are aligned and
    d % 4 == 0; every column of a row held by exactly one thread; every
    row taken exactly once by the grid, the warp route's within about one
    wave."""
    for aligned in (True, False):
        kp = K2.launch_plan(rows, d, SMS, aligned)
        assert kp.vec == (4 if aligned and d % 4 == 0 else 1)
        assert kp.values_per_lane % kp.vec == 0
        cols, valid = lane_columns(d, kp)
        assert np.array_equal(np.sort(cols[valid]), np.arange(d))
        assert sorted(row_schedule(rows, kp)) == list(range(rows))
        per = kp.values_per_lane // kp.vec
        if d <= K2.WARP_MAX_D:
            assert kp.route == "warp" and kp.threads == K2.WARP_THREADS
            assert kp.values_per_lane in K2.WARP_VPL
            assert kp.rows_per_cta == K2.WARP_THREADS // 32
            assert 32 * per * kp.vec >= d
            assert all(32 * (v // kp.vec) < d // kp.vec
                       for v in K2.WARP_VPL if v < kp.values_per_lane)
            wave = SMS * K2.WARP_CTAS_PER_SM[kp.values_per_lane]
            assert kp.grid == min(-(-rows // kp.rows_per_cta), wave)
        else:
            assert kp.route == "block" and kp.rows_per_cta == 1
            assert kp.values_per_lane == K2.BLOCK_VPL
            assert kp.grid == rows
            assert kp.threads % 32 == 0
            assert kp.threads <= K2.MAX_D // K2.BLOCK_VPL
            assert kp.threads * per >= d // kp.vec
            assert (kp.threads - 32) * per < d // kp.vec


def test_k2_plan_at_the_path_shapes():
    """The encoder's 16 384 x 768: a warp a row, 6 int4 a lane (24
    values), 2 CTAs an SM (264 CTAs of 8 warps); llama's 4 x 4096 and
    h2o's 1024 x 3840: 512 and 480 threads of 2 int4; a misaligned view
    takes one int a load; d % 4 != 0 (1002, 8191) one int on either
    route."""
    assert K2.launch_plan(16384, 768, SMS, True) == K2.K2Plan(
        "warp", 4, 24, 256, 8, 264)
    assert K2.launch_plan(128, 768, SMS, True).grid == 16
    assert K2.launch_plan(4, 4096, SMS, True) == K2.K2Plan(
        "block", 4, 8, 512, 1, 4)
    assert K2.launch_plan(1024, 3840, SMS, True) == K2.K2Plan(
        "block", 4, 8, 480, 1, 1024)
    assert K2.launch_plan(4, 4096, SMS, False).vec == 1
    assert K2.launch_plan(5, 1002, SMS, True)[:3] == ("warp", 1, 32)
    assert K2.launch_plan(5, 8191, SMS, True)[:4] == ("block", 1, 8, 1024)
    assert "warp vec=4 vpl=24" in K2.launch_plan(4, 768, SMS,
                                                  True).describe()


def test_k2_plan_refusals():
    """A row longer than MAX_D, an empty row or no rows raise, naming
    the shape."""
    for rows, d in ((4, 8193), (4, 0), (0, 768), (2 ** 31, 768)):
        with pytest.raises(ValueError, match="int_layernorm"):
            K2.launch_plan(rows, d, SMS, True)


def test_k2_constants_match_the_source():
    """The constants and instantiations the plan mirrors are the
    kernel's: MAX_D, the warp route's width and CTA, the block route's
    values a thread, the warp route's VPL cases and its CTAs an SM."""
    for name, value in (("MAX_D", K2.MAX_D), ("WARP_MAX_D", K2.WARP_MAX_D),
                        ("WARP_THREADS", K2.WARP_THREADS),
                        ("BLOCK_VPL", K2.BLOCK_VPL)):
        assert re.search(rf"constexpr int {name} = {value};", SRC), name
    warp = SRC[SRC.index("int launch_warp("):]
    warp = warp[:warp.index("default:")]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", warp)) \
        == K2.WARP_VPL
    m = re.search(r"return vpl <= (\d+) \? (\d+) : vpl <= (\d+) \? (\d+) :"
                  r" vpl <= (\d+) \? (\d+) : (\d+);", SRC)
    a, x, b, y, c, z, w = map(int, m.groups())
    for vpl, ctas in K2.WARP_CTAS_PER_SM.items():
        assert ctas == (x if vpl <= a else y if vpl <= b else
                        z if vpl <= c else w)


# ------------------------------------------- the kernel's arithmetic ----

def wrap(x):
    """int64 -> the int32 it wraps to."""
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32) - 2 ** 31


def rshift_round(x, s):
    if s == 0:
        return x
    if s < 0:
        return wrap(x << -s)
    return wrap(x + (1 << (s - 1))) >> s


def dyadic(x, dn):
    return rshift_round(wrap(rshift_round(x, dn.pre) * dn.b), dn.c - dn.pre)


def isqrt_fast(n):
    """The kernel's sqrt: float32 of n, its float32 root truncated, the
    clamp at 46340 and the +-1 corrections; 0 for n <= 0."""
    n = np.asarray(n, np.int64)
    f = np.maximum(n, 0).astype(np.int32).astype(np.float32)
    x = np.minimum(np.sqrt(f).astype(np.int64), 46340)
    for _ in range(2):
        x = np.where(x * x > n, x - 1, x)
    x = np.where((x < 46340) & ((x + 1) * (x + 1) <= n), x + 1, x)
    return np.where(n <= 0, 0, x)


def butterfly(u):
    """__shfl_xor_sync over 32 lanes, offsets 16..1, wrapping adds: every
    lane ends with the sum."""
    u = wrap(u)
    for off in (16, 8, 4, 2, 1):
        u = wrap(u + u[np.arange(32) ^ off])
    assert (u == u[0]).all()
    return u


def row_sum(part, kp):
    """A row's sum from each thread's partial: one warp's butterfly, or
    (block route) each warp's, then a butterfly over lanes holding the
    per-warp partials (0 past the CTA's warps)."""
    if kp.route == "warp":
        return butterfly(part)[0]
    partials = [butterfly(w)[0] for w in part.reshape(-1, 32)]
    lanes = np.zeros(32, np.int64)
    lanes[:len(partials)] = partials
    return butterfly(lanes)[0]


def emulate(q, g, b, p, out_bits, kp):
    """The kernel's schedule in numpy: each row in the grid's order, each
    thread's registers (0 past the row), the sums, the sqrt, one
    reciprocal, the per-element output of each thread's valid vectors."""
    rows, d = q.shape
    cols, valid = lane_columns(d, kp)
    safe = np.where(valid, cols, 0)
    gl = np.where(valid, g[safe], 0)
    bl = np.where(valid, b[safe], 0) if b is not None else 0
    lo, hi = -(1 << (out_bits - 1)), (1 << (out_bits - 1)) - 1
    out = np.full((rows, d), 1 << 40, np.int64)
    for row in row_schedule(rows, kp):
        y = np.where(valid, q[row][safe], 0).astype(np.int64)
        if p.subtract_mean:
            mu = dyadic(row_sum(wrap(y.sum(axis=1)), kp), p.dn_mean)
            y = wrap(y - mu)
        ys = rshift_round(y, p.pre_shift)
        ss = row_sum(wrap(np.where(valid, wrap(ys * ys), 0).sum(axis=1)),
                     kp)
        sigma = int(isqrt_fast(dyadic(ss, p.dn_var)))
        r = 0 if sigma == 0 else (1 << (p.recip_bits + p.pre_shift)) // sigma
        w = wrap(rshift_round(wrap(y * r), 2 * p.pre_shift) * gl)
        w = wrap(w + bl)
        o = np.clip(dyadic(w, p.dn_out), lo, hi)
        assert (out[row][cols[valid]] == 1 << 40).all()
        out[row][cols[valid]] = o[valid]
    assert (out != 1 << 40).all()
    return out


def _rows(rng, d, qmax):
    """Random rows, rows at +-qmax_in, a constant row (sigma 0), rows
    alternating +-qmax_in (the largest variance), small values, values
    just under qmax_in (a large mean)."""
    q = rng.integers(-qmax, qmax + 1, (7, d)).astype(np.int64)
    q[1] = qmax
    q[2] = -qmax
    q[3] = 77
    q[4] = np.where(np.arange(d) % 2 == 0, qmax, -qmax)
    q[5] = rng.integers(-3, 4, d)
    q[6] = qmax - rng.integers(0, 200, d)
    return q.astype(np.int32)


def _gamma_beta(rng, d, beta):
    g = rng.integers(-127, 128, d).astype(np.int32)
    g[:4] = (-127, 127, 0, -1)
    if not beta:
        return g, None
    b = rng.integers(-2 ** 30, 2 ** 30, d).astype(np.int32)
    b[:2] = (-2 ** 31, 2 ** 31 - 1)
    return g, b


@pytest.mark.parametrize("d", [64, 384, 768, 1002, 1024, 2048, 3840, 4095,
                               4096, 8192])
@pytest.mark.parametrize("mean,beta", [(True, True), (False, False),
                                       (True, False), (False, True)])
def test_k2_schedule_matches_plain(d, mean, beta):
    """The emulated kernel == the plain version on both vector widths (the
    unaligned plan takes one int a load), at widths on either side of
    the warp route's end and with a ragged vector tail."""
    rng = np.random.default_rng(d * 4 + 2 * mean + beta)
    qmax = 1 << 13
    p = inorms.make_inorm(d, 2.0 ** -9, qmax, 2 / 127, 8 / 127, mean)
    q = _rows(rng, d, qmax)
    g, b = _gamma_beta(rng, d, beta)
    want = K2.int_layernorm_plain(
        torch.as_tensor(q), torch.as_tensor(g),
        None if b is None else torch.as_tensor(b), p).numpy()
    for aligned in (True, False):
        kp = K2.launch_plan(q.shape[0], d, SMS, aligned)
        assert np.array_equal(emulate(q, g, b, p, 8, kp), want), kp


@pytest.mark.parametrize("arch", ["roberta-base", "h2o-danube-3-4b",
                                  "llama3-8b"])
def test_k2_schedule_at_the_configs(arch):
    """At the configs' own plans and widths (roberta-base's LayerNorm with
    beta at 768, h2o-danube-3-4b's and llama3-8b's RMSNorm at 3840 and
    4096) over 21 rows, so the warp route's persistent grid wraps."""
    cfg = get_config(arch)
    p = build_layer_plans(cfg).norm
    rng = np.random.default_rng(len(arch))
    q = np.concatenate([_rows(rng, cfg.d_model, cfg.qmax_res)] * 3)
    g, b = _gamma_beta(rng, cfg.d_model, p.subtract_mean)
    want = K2.int_layernorm_plain(
        torch.as_tensor(q), torch.as_tensor(g),
        None if b is None else torch.as_tensor(b), p).numpy()
    kp = K2.launch_plan(q.shape[0], cfg.d_model, SMS, True)
    if kp.route == "warp":          # 2 CTAs: a warp takes rows r, r + 16
        kp = kp._replace(grid=2)
    assert np.array_equal(emulate(q, g, b, p, 8, kp), want)


def test_isqrt_fast_matches_both_i_sqrt():
    """isqrt_fast (float32, as on the card) == the port's and the JAX
    package's 16-step i_sqrt on every n < 2^20, k^2 - 1, k^2, k^2 + 1 for
    every k <= 46 341, the top 2^16 of int32 and n <= 0.  The whole int32
    range is checked on the card (``isqrt_mismatches``)."""
    k = np.arange(46342, dtype=np.int64)
    n = np.concatenate([np.arange(1 << 20), k * k - 1, k * k, k * k + 1,
                        np.arange(2 ** 31 - 2 ** 16, 2 ** 31),
                        [0, -1, -2, -46340, -2 ** 31]])
    n = n[(n >= -2 ** 31) & (n < 2 ** 31)].astype(np.int32)
    fast = isqrt_fast(n)
    port = t_intmath.i_sqrt(torch.as_tensor(n)).numpy()
    ref = np.asarray(j_intmath.i_sqrt(jnp.asarray(n)))
    assert np.array_equal(fast, port)
    assert np.array_equal(fast, ref)
    pos = n.astype(np.int64)
    exact = np.where(pos > 0, np.floor(np.sqrt(np.maximum(pos, 0))), 0)
    assert np.array_equal(fast, exact.astype(np.int64))


# ------------------------------------------------------ the host half ----

def test_norm_consts_packed_once(monkeypatch):
    """The wrapper's host half packs a plan once per (plan, out_bits): a
    second call, or an equal plan built anew, returns the same struct and
    packs nothing; another out_bits packs once more."""
    made = []
    real = _abi.NormConsts

    def counting(*args):
        made.append(args)
        return real(*args)

    _abi.norm_consts.cache_clear()
    monkeypatch.setattr(_abi, "NormConsts", counting)
    try:
        p = inorms.make_inorm(768, 2.0 ** -9, 8192, 2 / 127, 8 / 127)
        first = _abi.norm_consts(p, 8)
        assert _abi.norm_consts(p, 8) is first
        again = inorms.make_inorm(768, 2.0 ** -9, 8192, 2 / 127, 8 / 127)
        assert _abi.norm_consts(again, 8) is first
        assert len(made) == 1
        other = _abi.norm_consts(p, 10)
        assert len(made) == 2 and other is not first
        assert (first.d, first.subtract_mean, first.pre_shift,
                first.recip_bits, first.lo, first.hi) == (
            768, 1, p.pre_shift, p.recip_bits, -128, 127)
        assert (other.lo, other.hi) == (-512, 511)
    finally:
        _abi.norm_consts.cache_clear()
