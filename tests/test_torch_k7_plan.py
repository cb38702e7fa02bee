"""K7's launch plan and the schedule of its Hopper kernel
(``csrc/int_softmax.cu``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
Here: the plan the wrapper launches (a warp a row up to L = 1024, a CTA a
row past it; 16-byte loads and 4-byte stores where L % 4 == 0 and the
pointers allow; the values a thread holds, a template argument), checked
for every L up to 1024 and a sweep to 2^15 at 1 to 196 608 rows; the
constants and instantiations the plan mirrors from the source; a numpy
emulation of the kernel's schedule -- each thread's columns, the vector
tail and the ``valid_len`` predicate, the warp butterflies and the
block's reduction of per-warp partials, exp16 with the multiply-high and
the per-launch shifts -- held equal to
:func:`int_softmax_plain` and to the JAX package's ``int_softmax_pallas``
in interpret mode; the branch-free exp16 against both packages'
``core.softmax._exp16`` on the whole clipped domain of each config's
attention plan; that every plan ``make_iexp`` builds has the exact
multiply-high; and the launch the wrapper hands to the library.

Tolerance: equality.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs.registry import get_config as j_get_config
from repro.core import attention as j_attn
from repro.core import softmax as j_softmax
from repro.kernels.int_softmax import int_softmax_pallas
from repro.quant.plans import build_layer_plans as j_build_layer_plans
from repro_torch import kernels
from repro_torch.configs.registry import get_config
from repro_torch.core import attention as iattn
from repro_torch.core import softmax as t_softmax
from repro_torch.interop import plan_from_reference
from repro_torch.kernels import _abi, _build
from repro_torch.kernels import int_attention_fused as F
from repro_torch.kernels import int_softmax as K7
from repro_torch.quant.plans import build_layer_plans

SRC = (Path(K7.__file__).resolve().parent.parent / "csrc"
       / "int_softmax.cu").read_text()
NEG = -(1 << 30)
ROWS = (1, 4, 37, 196608)
CONFIGS = ("roberta-base", "llama3-8b", "h2o-danube-3-4b")


def _plan(d=64):
    jp = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    return jp.sm


# ------------------------------------------------------------ the plan ----

def thread_vectors(L, kp):
    """Each thread's columns ``(threads of a row, vectors, vec)`` and
    which of its vectors lie in the row: thread t's vector j is the row's
    vector j * stride + t, stride 32 on the warp route (a warp a row) and
    the CTA's threads on the block route."""
    lanes = 32 if kp.route == "warp" else kp.threads
    nv = kp.vpt // kp.vec
    v = np.arange(nv)[None, :] * lanes + np.arange(lanes)[:, None]
    cols = v[..., None] * kp.vec + np.arange(kp.vec)
    return cols, v < L // kp.vec


def _check_plan(rows, L, aligned):
    kp = K7.launch_plan(rows, L, -1, aligned)
    assert kp.vec == (4 if aligned and L % 4 == 0 else 1)
    assert kp.vpt % kp.vec == 0 and kp.valid == L
    cols, in_row = thread_vectors(L, kp)
    held = cols[in_row]
    assert np.array_equal(np.sort(held.ravel()), np.arange(L))
    per = kp.vpt // kp.vec
    nvec = L // kp.vec
    if L <= K7.WARP_MAX_L:
        assert kp.route == "warp" and kp.vpt in K7.WARP_VPT
        assert kp.rows_per_block == 8 and kp.threads == 256
        assert kp.grid == -(-rows // 8)
        assert 32 * per >= nvec
        assert all(32 * (v // kp.vec) < nvec for v in K7.WARP_VPT
                   if v < kp.vpt and v % kp.vec == 0)
    else:
        assert kp.route == "block" and kp.vpt in K7.BLOCK_VPT
        assert kp.rows_per_block == 1 and kp.grid == rows
        assert kp.threads % 32 == 0
        assert kp.threads <= K7.BLOCK_MAX_THREADS
        assert kp.threads * per >= nvec
        if kp.vpt == K7.BLOCK_FULL_VPT:
            assert kp.threads == K7.BLOCK_MAX_THREADS
        else:
            assert nvec > (kp.threads - 32) * per
        assert all(-(-nvec // (v // kp.vec)) > K7.BLOCK_MAX_THREADS
                   for v in K7.BLOCK_VPT if v < kp.vpt)
    return kp


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("aligned", [True, False])
def test_k7_launch_plan_every_warp_length(rows, aligned):
    """Every L in 1..1024, aligned or not: the warp route with the least
    instantiated VPT that holds the row, 8 rows a CTA, every column held
    by exactly one lane, 16-byte vectors exactly where aligned and L % 4
    == 0."""
    for L in range(1, K7.WARP_MAX_L + 1):
        _check_plan(rows, L, aligned)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("aligned", [True, False])
def test_k7_launch_plan_long_rows(rows, aligned):
    """A sweep from 1025 to 2^15 (each 1024 + k * 97, the powers of two,
    their neighbours and 4100): a CTA a row with the least VPT whose
    warps fit 1024 threads; 1024 threads of 32 values at 2^15."""
    lengths = set(range(1025, K7.MAX_L + 1, 97)) | {4100, K7.MAX_L}
    lengths |= {(1 << p) + d for p in range(11, 16) for d in (-1, 0, 1)}
    for L in sorted(x for x in lengths if 1024 < x <= K7.MAX_L):
        _check_plan(rows, L, aligned)
    big = K7.launch_plan(rows, K7.MAX_L, -1, aligned)
    assert (big.vpt, big.threads) == (32, 1024)


def test_k7_plan_at_the_path_shapes():
    """The encoder's full score matrix (196 608 rows of 512): a warp a
    row, 4 int4 a lane, 8 rows a CTA; masked at 300 the plan says so;
    256 x 1024; 4 x 2^15; a misaligned view and L % 4 != 0 take one int;
    block_rows sets the CTA and is capped at 16."""
    assert K7.launch_plan(196608, 512, -1, True) == K7.K7Plan(
        "warp", 4, 16, 256, 8, 24576, 512)
    assert K7.launch_plan(196608, 512, 300, True).valid == 300
    assert K7.launch_plan(256, 1024, -1, True)[:4] == ("warp", 4, 32, 256)
    assert K7.launch_plan(4, 1 << 15, -1, True) == K7.K7Plan(
        "block", 4, 32, 1024, 1, 4, 1 << 15)
    assert K7.launch_plan(196608, 512, -1, False)[:3] == ("warp", 1, 16)
    assert K7.launch_plan(1000, 37, -1, True)[:3] == ("warp", 1, 2)
    assert K7.launch_plan(4, 4100, -1, True)[:4] == ("block", 4, 8, 544)
    assert K7.launch_plan(4, 1025, -1, True)[:4] == ("block", 1, 8, 160)
    assert K7.launch_plan(37, 40, 7, True, 16)[3:6] == (512, 16, 3)
    assert K7.launch_plan(37, 40, 7, True, 64)[3:6] == (512, 16, 3)
    assert K7.launch_plan(37, 40, 7, True, 1)[3:6] == (32, 1, 37)
    for vl, valid in ((-1, 40), (0, 0), (40, 40), (45, 40), (7, 7)):
        assert K7.launch_plan(3, 40, vl, True).valid == valid
    assert "warp vec=4 vpt=16" in K7.launch_plan(4, 512, -1,
                                                  True).describe()


def test_k7_plan_refusals():
    """An empty row, a row past 2^15, no rows, too many rows or no rows a
    CTA raise, naming the kernel."""
    for rows, L, br in ((4, 0, 8), (4, (1 << 15) + 1, 8), (0, 512, 8),
                        (2 ** 31, 512, 8), (4, 512, 0)):
        with pytest.raises(ValueError, match="int_softmax"):
            K7.launch_plan(rows, L, -1, True, br)


def test_k7_constants_match_the_source():
    """The constants and instantiations the plan mirrors are the
    kernel's: the row limits, the rows a CTA, the CTA limit, the VPT of
    each route; the switch instantiates VPT 1 and 2 only for one-int
    vectors on the warp route, 4 only on the warp route."""
    for name, value in (("MAX_L", "1 << 15"), ("WARP_MAX_L", "1024"),
                        ("MAX_BLOCK_ROWS", "16"),
                        ("BLOCK_MAX_THREADS", "1024"),
                        ("BLOCK_FULL_VPT", "32")):
        assert re.search(rf"constexpr int {name} = {value};", SRC), name
    assert K7.MAX_L == 1 << 15 and K7.WARP_MAX_L == 1024
    assert K7.MAX_BLOCK_ROWS == 16 and K7.BLOCK_MAX_THREADS == 1024
    assert K7.BLOCK_FULL_VPT == K7.BLOCK_VPT[-1] == 32
    for name, value in (("WARP_VPT", K7.WARP_VPT),
                        ("BLOCK_VPT", K7.BLOCK_VPT)):
        m = re.search(rf"constexpr int {name}\[\] = \{{([0-9, ]+)\}};", SRC)
        assert tuple(int(v) for v in m.group(1).split(",")) == value
    sw = SRC[SRC.index("int launch_vpt("):]
    sw = sw[:sw.index("default:")]
    cases = re.findall(r"case (\d+):\s*(if constexpr \(([^)]*)\))?", sw)
    assert [(int(c), cond) for c, _, cond in cases] == [
        (1, "WARP && VEC == 1"), (2, "WARP && VEC == 1"), (4, "WARP"),
        (8, ""), (16, ""), (32, "")]
    assert "rshift_round(wmul(e16, recip), 23)" in SRC


# ------------------------------------------- the kernel's arithmetic ----

def wrap(x):
    """int64 -> the int32 it wraps to."""
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32) - 2 ** 31


def _rshift(x, sh):
    return wrap(x * sh.mul + sh.half) >> sh.rs


def exp16_k7(q_sub, ex):
    """The kernel's exp16 on the constants the wrapper packs: every shift
    ``(x * mul + half) >> rs`` wrapping as uint32, the division by q_ln2
    the multiply-high ``(n * magic) >> (32 + z_shift)``."""
    q = np.maximum(np.asarray(q_sub, np.int64), -ex.q_band)
    q = np.minimum(_rshift(wrap(_rshift(q, ex.in_pre) * ex.in_b),
                           ex.in_post), 0)
    qn = np.maximum(q, ex.neg_zq)
    z = ((-qn).astype(np.uint64) * np.uint64(ex.magic)) \
        >> np.uint64(32 + ex.z_shift)
    z = z.astype(np.int64)
    t = wrap(wrap(qn + wrap(z * ex.q_ln2)) + ex.q_b)
    e = wrap(wrap(t * t) + ex.q_c) >> z
    return _rshift(wrap(_rshift(e, ex.e_pre) * ex.e_b), ex.e_post)


def butterfly(u, op):
    """__shfl_xor_sync over the last axis of 32 lanes, offsets 16..1:
    every lane ends with the reduction."""
    for off in (16, 8, 4, 2, 1):
        u = op(u, u[..., np.arange(32) ^ off])
    assert (u == u[..., :1]).all()
    return u[..., 0]


def _max(a, b):
    return np.maximum(a, b)


def _sum(a, b):
    return wrap(a + b)


def reduce(part, kp, op, neutral):
    """A row's reduction from each thread's partial (rows, threads): one
    warp's butterfly, or (block route) each warp's, then a butterfly
    over lanes holding the per-warp partials (``neutral`` past the CTA's
    warps)."""
    if kp.route == "warp":
        return butterfly(part, op)
    rows, threads = part.shape
    partials = butterfly(part.reshape(rows, threads // 32, 32), op)
    lanes = np.full((rows, 32), neutral, np.int64)
    lanes[:, :threads // 32] = partials
    return butterfly(lanes, op)


def emulate(x, valid_len, kp, ex):
    """The kernel's schedule in numpy, every row at once: each thread's
    registers (-2^30 where not read or masked), the max, exp16 of the
    live positions, the modular sum, one reciprocal a row, and the int8
    probabilities of each thread's vectors in the row, each column
    written exactly once."""
    rows, L = x.shape
    vl = kp.valid
    assert vl == (L if valid_len < 0 else min(valid_len, L))
    masked = vl < L
    cols, in_row = thread_vectors(L, kp)          # (T, NV, VEC), (T, NV)
    read = cols[..., 0] < vl if masked else in_row
    safe = np.where(read[..., None], cols, 0)
    v = np.where(read[..., None], x[:, safe].astype(np.int64), NEG)
    live = cols < vl if masked else np.broadcast_to(in_row[..., None],
                                                    cols.shape)
    if masked:
        v = np.where(live, v, NEG)
    m = reduce(v.max(axis=(2, 3)), kp, _max, NEG)
    e = np.where(live, exp16_k7(wrap(v - m[:, None, None, None]), ex), 0)
    s = reduce(wrap(e.sum(axis=(2, 3))), kp, _sum, 0)
    r = (1 << 30) // np.maximum(s, 1)
    p = np.clip(wrap(wrap(e * r[:, None, None, None]) + (1 << 22)) >> 23,
                0, 127)
    out = np.full((rows, L), 1 << 10, np.int64)
    held = cols[in_row]                             # (vectors in row, VEC)
    assert len(np.unique(held)) == held.size == L
    out[:, held] = p[:, in_row]
    assert (out != 1 << 10).all()
    return out.astype(np.int8)


def _rows(rng, L):
    """Random rows, an all-equal row, one dominant score, scores at
    +-2^30 (alone and mixed), the int32 extremes (the subtraction
    wraps)."""
    x = rng.integers(-100000, 100000, (7, L)).astype(np.int64)
    x[1] = 12345
    x[2] = rng.integers(-3000, 0, L)
    x[2, rng.integers(0, L)] = 90000
    x[3] = 1 << 30
    x[4] = np.where(rng.integers(0, 2, L) == 1, 1 << 30, -(1 << 30))
    x[5] = -(1 << 30)
    x[6] = np.where(np.arange(L) % 3 == 0, 2 ** 31 - 1, -2 ** 31)
    return x.astype(np.int32)


@pytest.mark.parametrize("L", [1, 3, 31, 32, 33, 100, 512, 1000, 1025,
                               4100, 16388])
def test_k7_schedule_matches_plain_and_pallas(L):
    """The emulated kernel == the plain version == the JAX package's
    Pallas kernel (interpret mode) for valid_len -1, 0, 1, L // 3, L and
    L + 2, on both vector widths where L % 4 == 0, over random,
    all-equal, dominant and extreme rows."""
    rng = np.random.default_rng(L)
    sm = _plan()
    jsm = j_attn.make_iattention(64, 8 / 127, 8 / 127, 4 / 127,
                                 4 / 127).sm
    assert plan_from_reference(jsm) == sm
    x = _rows(rng, L)
    ex = F.exp16_args(sm)
    for vl in (-1, 0, 1, L // 3, L, L + 2):
        want = K7.int_softmax_plain(torch.as_tensor(x), sm, vl).numpy()
        ref = np.asarray(int_softmax_pallas(jnp.asarray(x), jsm,
                                            valid_len=vl, interpret=True))
        assert np.array_equal(want, ref), vl
        for aligned in (True, False) if L % 4 == 0 else (True,):
            kp = K7.launch_plan(x.shape[0], L, vl, aligned)
            assert np.array_equal(emulate(x, vl, kp, ex), want), (vl, kp)
        if vl == 0:
            assert not want.any()


def test_k7_schedule_across_block_rows():
    """block_rows 1, 3 and 16 on 37 rows of 40 give the same integers
    (the rows of a CTA never meet)."""
    rng = np.random.default_rng(40)
    sm = _plan()
    x = rng.integers(-90000, 90000, (37, 40)).astype(np.int32)
    ex = F.exp16_args(sm)
    want = K7.int_softmax_plain(torch.as_tensor(x), sm, 7).numpy()
    for br in (1, 3, 16):
        kp = K7.launch_plan(37, 40, 7, True, br)
        assert np.array_equal(emulate(x, 7, kp, ex), want)


@pytest.mark.parametrize("arch", CONFIGS)
def test_exp16_k7_on_the_whole_domain(arch):
    """At each config's attention plan (the port's, equal to the JAX
    package's), the kernel's exp16 -- its division the multiply-high --
    equals both packages' core.softmax._exp16 on every q in [-q_band, 0]
    (and a little past the clip)."""
    sm = build_layer_plans(get_config(arch)).attn.attn.sm
    jsm = j_build_layer_plans(j_get_config(arch)).attn.attn.sm
    assert plan_from_reference(jsm) == sm
    q = np.arange(-sm.q_band - 64, 1, dtype=np.int64)
    port = t_softmax._exp16(torch.as_tensor(q, dtype=torch.int32),
                            sm).numpy()
    ref = np.asarray(j_softmax._exp16(jnp.asarray(q, dtype=jnp.int32), jsm))
    assert np.array_equal(port, ref)
    assert np.array_equal(exp16_k7(q, F.exp16_args(sm)), port)


# ------------------------------------------------------ the host half ----

def _first_divisor(q_ln2):
    """``exp16_divisor``'s first candidate: the largest shift k - 32 whose
    rounded-up reciprocal ``ceil(2^k / q_ln2)`` fits 32 bits."""
    for k in range(63, 31, -1):
        magic = -(-(1 << k) // q_ln2)
        if magic < 1 << 32:
            return magic, k
    return None


def test_every_iexp_plan_has_a_multiply_high():
    """make_iexp builds only plans with 16 <= q_ln2 < 2^16 (it refuses a
    coarser scale, and at q_ln2 = 2^16 the polynomial's q_b^2 + q_c
    overflows int32; a finer scale has a larger q_b) and z_max * q_ln2 <=
    2^31 - 1.  For each such q_ln2 the largest shift whose magic fits 32
    bits is exact on [0, 2^31 - 1]: magic * q_ln2 - 2^k < q_ln2, and
    (2^31 - 1) times that stays below 2^k.  So K7, like K3, K4, K5 and K8,
    needs no true division."""
    from repro_torch.core import intmath
    with pytest.raises(ValueError):
        intmath.make_iexp(intmath.LN2 / 15.5)
    with pytest.raises(ValueError):
        intmath.make_iexp(intmath.LN2 / (1 << 16))
    with pytest.raises(ValueError):
        intmath.make_iexp(intmath.LN2 / 100, z_max=(1 << 31) // 100 + 1)
    n_max = (1 << 31) - 1
    for q_ln2 in range(16, 1 << 16):
        magic, k = _first_divisor(q_ln2)
        err = magic * q_ln2 - (1 << k)
        assert 0 <= err < q_ln2 and n_max * err < 1 << k, q_ln2


@pytest.mark.parametrize("arch", CONFIGS)
def test_exp16_divisor_takes_the_first_shift(arch):
    """At each config's attention plan the kernels' constants hold the
    first candidate, packed once a plan (an equal plan built anew hits
    the cache)."""
    sm = build_layer_plans(get_config(arch)).attn.attn.sm
    ie = sm.iexp
    magic, k = _first_divisor(ie.q_ln2)
    assert F.exp16_divisor(ie.q_ln2, ie.z_max * ie.q_ln2) == (magic, k - 32)
    ex = F.exp16_args(sm)
    assert (ex.magic, ex.z_shift) == (magic, k - 32)
    assert F.exp16_args(build_layer_plans(get_config(arch)).attn.attn.sm) \
        is ex


class _Lib:
    """A stand-in kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("shape,vl", [((3, 5, 512), -1), ((3, 5, 512), 300),
                                      ((37, 1023), 1), ((4, 4100), 4200)])
def test_k7_launch_hands_the_plan_to_the_library(monkeypatch, shape, vl):
    """``_launch`` (the wrapper's launch, driven here with a stand-in
    library) calls one entry point with the plan's route, vector width,
    VPT, CTA, grid and live positions, the rows, L and exp16's constants,
    and counts one launch."""
    lib = _Lib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_abi, "stream_of", lambda t: 0)
    sm = _plan()
    x = torch.zeros(shape, dtype=torch.int32)
    out = torch.empty(shape, dtype=torch.int8)
    L = shape[-1]
    rows = x.numel() // L
    kp = K7.launch_plan(rows, L, vl, True)
    consts = F.exp16_args(sm)
    before = kernels.LAUNCHES["int_softmax"]
    assert K7._launch(x, out, kp, consts) is out
    assert kernels.LAUNCHES["int_softmax"] == before + 1
    (name, args), = lib.calls
    assert name == "r8_int_softmax"
    assert args[2:10] == (rows, L, kp.valid, int(kp.route == "warp"),
                          kp.vec, kp.vpt, kp.threads, kp.grid)
    assert args[10]._obj is consts and args[11] == 0
