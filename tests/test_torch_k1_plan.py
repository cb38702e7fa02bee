"""K1's decode tile (M <= 16), modelled in numpy on the CPU.

``csrc/int8_matmul_decode.cu`` cannot run here, so its plan and its index
arithmetic are modelled from ``kernels/int8_matmul.py::decode_plan``:

  * the plan: the route rule (TMA where a tensor map can describe both
    operands, else the producer warp's copies), BN and the cluster size of
    every llama3-8b and h2o-danube-3-4b decode shape, K ranges of whole
    ring stages covering K once, and a launch that allocates no workspace
    and calls one kernel (the wrapper driven with a stand-in library);
  * the schedule: the ring's stage images (weight tiles in the 128- or
    64-byte swizzle, x boxes in the 128-byte one, zero past M, K, K / 2
    and N) as the TMA writes them and as the copy route writes them, the
    lanes' 16- or 8-byte loads of 4-row units, their B words (4 x 4 byte
    transpose, or the nibble expansion), the A words in the same K
    permutation, ``mma.sync.m16n8k32``'s fragments, the warps' k32 steps,
    the cluster reduction and the column relabelling the epilogue undoes;
    held with ``torch.equal`` against ``int8_matmul_plain`` and
    ``int8_matmul_nibbles_plain``;
  * the shared-memory banks of the fragment loads.

Tolerance: 0.
"""
import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.core.dyadic import fit_dyadic
from repro_torch.kernels import _abi, _build
from repro_torch.kernels import int8_matmul as k1
from repro_torch.ops.spec import RequantSpec

T = torch.as_tensor
ROWS = k1.DECODE_ROWS
XBOX = k1.DECODE_XBOX
BASE = np.array(k1.DECODE_ROW_BASE)


def _wswz(bn, row, col):
    """Byte offset of (row, col) in a weight tile (``dec::wswz``): the
    TMA's 128-byte swizzle for BN = 128, its 64-byte one for BN = 64."""
    if bn == 128:
        return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15)
    return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15)


def _xswz(m, col):
    """Byte offset of (row m, K byte col) in an x box (``dec::xswz``)."""
    return m * 128 + ((((col >> 4) ^ m) & 7) << 4) + (col & 15)


def _wrap(a):
    return ((np.asarray(a, np.int64) + 2**31) % 2**32) - 2**31


def _padded(x, wb, packed, plan, n):
    """x and the weight bytes zero-padded to the stages and tiles."""
    m, k = x.shape
    ks = k1.decode_k_step(packed)
    stages = -(-k // ks)
    nt = plan.grid[0]
    wp = np.zeros((stages * ROWS, nt * plan.bn), np.uint8)
    wp[:wb.shape[0], :n] = wb.view(np.uint8)
    xp = np.zeros((16, stages * ks), np.uint8)
    xp[:m, :k] = x.view(np.uint8)
    return xp, wp, stages


def _tma_images(x, wb, packed, plan, n):
    """The stage images the TMA writes: (n tiles, stages, ROWS * BN)
    weight tiles and (stages, boxes * XBOX) x boxes."""
    xp, wp, stages = _padded(x, wb, packed, plan, n)
    bn, nt, nb = plan.bn, plan.grid[0], k1.decode_k_step(packed) // 128
    tiles = wp.reshape(stages, ROWS, nt, bn).transpose(2, 0, 1, 3)
    rr, cc = np.meshgrid(np.arange(ROWS), np.arange(bn), indexing="ij")
    wimg = np.zeros((nt, stages, ROWS * bn), np.uint8)
    wimg[..., _wswz(bn, rr, cc).ravel()] = tiles.reshape(nt, stages, -1)
    boxes = xp.reshape(16, stages, nb, 128).transpose(1, 2, 0, 3)
    mm, cc = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    ximg = np.zeros((stages, nb, XBOX), np.uint8)
    ximg[..., _xswz(mm, cc).ravel()] = boxes.reshape(stages, nb, -1)
    return wimg, ximg.reshape(stages, nb * XBOX)


def _copy_images(x, wb, packed, plan, n):
    """The same images as ``copy_stage`` writes them: 4-byte words u of a
    stage, weight word (u / (BN / 4), 4 (u % (BN / 4))) at wswz of its
    first byte, x word (u / (KS / 4), c = 4 (u % (KS / 4))) in box c / 128
    at xswz(m, c % 128); zero past K (K / 2 byte rows), N and M."""
    xp, wp, stages = _padded(x, wb, packed, plan, n)
    m_, k = x.shape
    bn, nt, ks = plan.bn, plan.grid[0], k1.decode_k_step(packed)
    rows, j4 = wb.shape[0], np.arange(4)
    u = np.arange(ROWS * (bn // 4))
    r, c = u // (bn // 4), 4 * (u % (bn // 4))
    wimg = np.zeros((nt, stages, ROWS * bn), np.uint8)
    for bx in range(nt):
        for s in range(stages):
            row = s * ROWS + r
            cols = bx * bn + c[:, None] + j4
            keep = (row[:, None] < rows) & (cols < n)
            wimg[bx, s, _wswz(bn, r, c)[:, None] + j4] = np.where(
                keep, wp[row[:, None], cols], 0)
    u = np.arange(16 * (ks // 4))
    m, c = u // (ks // 4), 4 * (u % (ks // 4))
    ximg = np.zeros((stages, (ks // 128) * XBOX), np.uint8)
    for s in range(stages):
        kk = s * ks + c[:, None] + j4
        keep = (m[:, None] < m_) & (kk < k)
        ximg[s, ((c // 128) * XBOX + _xswz(m, c % 128))[:, None] + j4] = \
            np.where(keep, xp[m[:, None], kk], 0)
    return wimg, ximg


def _lane_b_words(wimg, bn, packed):
    """Each lane's B words of every k32 step: (n tiles, stages, steps, 32
    lanes, 2 (b0, b1), NT tiles, 4 K values) as int8 values; tile T's
    word of lane (g, t) is weight column NT g + T."""
    nt_, ks = bn // 8, k1.decode_k_step(packed)
    steps, nr = ks // 32, 2 if packed else 4
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    j, r, u = np.arange(steps), np.arange(nr), np.arange(nt_)
    out = []
    for base in (BASE[t], BASE[t] ^ 1):
        # the kernel's address: step base + wswz(8 r + b(t), NT g) + byte u
        addr = (j[:, None, None, None] * (16 if packed else 32) * bn
                + _wswz(bn, 8 * r[None, None, :, None]
                        + base[None, :, None, None],
                        (nt_ * g)[None, :, None, None])
                + u[None, None, None, :])
        raw = wimg[:, :, addr]         # (nt, S, steps, 32, nr, NT) bytes
        if packed:                     # expand_w4: byte rows b, b + 8
            lo = ((raw & 15).astype(np.int16) ^ 8) - 8
            hi = ((raw >> 4).astype(np.int16) ^ 8) - 8
            word = np.stack([lo[..., 0, :], hi[..., 0, :], lo[..., 1, :],
                             hi[..., 1, :]], axis=-1)
        else:                          # transpose4: rows r of column T
            word = np.swapaxes(raw.view(np.int8), -1, -2)
        out.append(word.astype(np.int64))
    return np.stack(out, axis=4)


def _lane_a_words(ximg, packed):
    """Each lane's A registers a0..a3 of every k32 step: (stages, steps,
    32, 4 registers, 4 K values), built as ``a_frags`` does."""
    ks = k1.decode_k_step(packed)
    steps = ks // 32
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    j = np.arange(steps)[:, None]
    regs = np.zeros((ximg.shape[0], steps, 32, 4, 4), np.int64)
    sx = ximg.view(np.int8)
    for h in range(2):
        m = g + 8 * h
        if packed:
            box = (j >> 2) * XBOX
            u = 8 * (j & 3) + (((t & 1) << 1) | (t >> 1))
            o0 = np.where(t >> 1, 2, 0)
            for reg, o in ((h, o0), (2 + h, o0 ^ 2)):
                lo = box + _xswz(m, 4 * u) + o
                hi = box + _xswz(m, 4 * (u + 4)) + o
                regs[:, :, :, reg] = sx[:, np.stack(
                    [lo, lo + 1, hi, hi + 1], axis=-1)]
        else:
            s0, s1 = np.where(t >> 1, 3, 0), np.where(t >> 1, 2, 1)
            for reg, sel in ((h, s0), (2 + h, s1)):
                addr = np.stack([_xswz(m, 4 * (8 * j + (t & 1) + 2 * r))
                                 + sel for r in range(4)], axis=-1)
                regs[:, :, :, reg] = sx[:, addr]
    return regs


def _mma(a_regs, b_words):
    """``mma.sync.m16n8k32``: A (16 x 32) and B (32 x 8) decoded from the
    lanes' registers by the PTX fragment layout, C's lane registers (c0
    C[g][2t], c1 C[g][2t+1], c2 / c3 row g + 8) of every step and tile:
    (n tiles, stages, steps, NT, 32, 4)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    i = np.arange(4)
    a = np.zeros(a_regs.shape[:2] + (16, 32))
    for reg, (ro, ko) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        a[:, :, (g + ro)[:, None], (ko + 4 * t)[:, None] + i] = \
            a_regs[:, :, :, reg]
    nt_ = b_words.shape[5]
    b = np.zeros(b_words.shape[:3] + (nt_, 32, 8))
    for half in range(2):
        w = np.moveaxis(b_words[:, :, :, :, half], 4, 3)  # (.., NT, 32, 4)
        b[..., (16 * half + 4 * t)[:, None] + i, g[:, None]] = w
    c = np.matmul(a[None, :, :, None], b).astype(np.int64)
    return np.stack([c[..., g, 2 * t], c[..., g, 2 * t + 1],
                     c[..., g + 8, 2 * t], c[..., g + 8, 2 * t + 1]],
                    axis=-1)


def _epilogue_map(bn):
    """(m, column) of every (fragment f, element e) as the epilogue reads
    them: f = tid + 128 q, T = f / 32, lane (g, t) = f % 32, m = g + 8 (e /
    2), column NT (2 t + e % 2) + T."""
    nt_ = bn // 8
    f = np.arange(128)[:, None] + 128 * np.arange(nt_ // 4)[None, :]
    f = f.ravel()
    tt, ln = f // 32, f % 32
    g, t = ln // 4, ln % 4
    e = np.arange(4)
    m = g[:, None] + 8 * (e // 2)
    col = nt_ * (2 * t[:, None] + e % 2) + tt[:, None]
    return f, m, col


def _emulate(x, wb, packed, plan, n):
    """The decode kernel's raw int32 accumulator (M, N) from its
    schedule, block by block and rank by rank."""
    m_, k = x.shape
    bn, c, ks = plan.bn, plan.cluster, k1.decode_k_step(packed)
    nt_ = bn // 8
    wimg, ximg = _tma_images(x, wb, packed, plan, n)
    cw, cx = _copy_images(x, wb, packed, plan, n)
    assert np.array_equal(wimg, cw) and np.array_equal(ximg, cx)
    creg = _mma(_lane_a_words(ximg, packed), _lane_b_words(wimg, bn, packed))
    stages, steps = wimg.shape[1], ks // 32
    per = plan.k_per_split // ks
    assert per * ks == plan.k_per_split and c * per >= stages
    # warp w takes steps w, w + 4 of every stage of its rank; a block's
    # partial is its warps' sum; rank 0 adds the ranks' (mod 2^32)
    total = np.zeros((plan.grid[0], nt_, 32, 4), np.int64)
    for rank in range(c):
        mine = creg[:, rank * per:(rank + 1) * per]
        block = np.zeros_like(total)
        for w in range(4):
            block = _wrap(block + mine[:, :, w::4].sum(axis=(1, 2)))
        total = _wrap(total + block)
    f, m, col = _epilogue_map(bn)
    acc = np.zeros((16, plan.grid[0] * bn), np.int64)
    for bx in range(plan.grid[0]):
        vals = total[bx].reshape(nt_ * 32, 4)[f]
        acc[m, bx * bn + col] = vals
    return acc[:m_, :n]


def _operands(rng, m, k, n, packed):
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wb = rng.integers(-128, 128, (k // 2 if packed else k, n)).astype(np.int8)
    return x, wb


_SPECS = (RequantSpec.raw(), RequantSpec.per_channel(24, 10, 11),
          RequantSpec.per_tensor(fit_dyadic(1 / 3000.0, 1 << 26)))


@pytest.mark.parametrize("m,k,n", [
    (1, 7, 7), (4, 200, 48), (5, 300, 260), (15, 4096, 48),
    (16, 14336, 7), (16, 200, 960), (4, 4096, 1024), (1, 300, 4096),
    (5, 14336, 48), (15, 200, 260), (16, 4096, 260), (4, 7, 960),
    (5, 1024, 1024), (16, 7, 4096)])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("packed", [False, True])
def test_decode_schedule_matches_plain(m, k, n, sms, packed):
    """The emulated schedule (both routes' stage images, lane loads, B and
    A words, fragments, warps, ranks, relabelling) gives the plain
    version's integers in every epilogue (dense: ``int8_matmul_plain``;
    packed: ``int8_matmul_nibbles_plain``, K rounded up to even)."""
    if packed:
        k += k % 2
    rng = np.random.default_rng(m * 1000 + k + n + sms)
    x, wb = _operands(rng, m, k, n, packed)
    plan = k1.decode_plan(m, n, k, sms, packed)
    raw = _emulate(x, wb, packed, plan, n)
    bias = rng.integers(-5000, 5000, n).astype(np.int32)
    bvec = rng.integers(256, 4096, n).astype(np.int32)
    plain = k1.int8_matmul_nibbles_plain if packed else k1.int8_matmul_plain
    assert torch.equal(T(raw.astype(np.int32)),
                       plain(T(x), T(wb), RequantSpec.raw()))
    acc = T(_wrap(raw + bias[None, :]).astype(np.int32))
    for spec in _SPECS:
        got = k1._epilogue_plain(acc, spec, T(bvec))
        assert torch.equal(got, plain(T(x), T(wb), spec, T(bias), T(bvec)))


@pytest.mark.parametrize("bn", [128, 64])
@pytest.mark.parametrize("packed", [False, True])
def test_fragment_loads_are_free_of_bank_conflicts(bn, packed):
    """Every load of B rows (16 bytes a lane, served 8 lanes at a time;
    8 bytes, 16 at a time) hits 32 distinct 4-byte banks in each phase;
    every A word load touches each bank at one address at most; the
    swizzles are bijections of their tiles."""
    nt_ = bn // 8
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rr, cc = np.meshgrid(np.arange(ROWS), np.arange(bn), indexing="ij")
    assert np.array_equal(np.sort(_wswz(bn, rr, cc).ravel()),
                          np.arange(ROWS * bn))
    mm, cc = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    assert np.array_equal(np.sort(_xswz(mm, cc).ravel()), np.arange(XBOX))
    ks = k1.decode_k_step(packed)
    phase = 8 if nt_ == 16 else 16
    for j in range(ks // 32):
        for base in (BASE[t], BASE[t] ^ 1):
            for r in range(2 if packed else 4):
                addr = (j * (16 if packed else 32) * bn
                        + _wswz(bn, 8 * r + base, nt_ * g))
                assert np.all(addr % nt_ == 0)
                for p0 in range(0, 32, phase):
                    banks = ((addr[p0:p0 + phase, None]
                              + 4 * np.arange(nt_ // 4)) // 4) % 32
                    assert len(set(banks.ravel().tolist())) == 32
    for j in range(ks // 32):
        for h in range(2):
            m = g + 8 * h
            if packed:
                u = 8 * (j & 3) + (((t & 1) << 1) | (t >> 1))
                loads = [(j >> 2) * XBOX + _xswz(m, 4 * (u + d))
                         for d in (0, 4)]
            else:
                loads = [_xswz(m, 4 * (8 * j + (t & 1) + 2 * r))
                         for r in range(4)]
            for addr in loads:
                seen = {}
                for a in addr.tolist():
                    assert seen.setdefault((a // 4) % 32, a) == a


@pytest.mark.parametrize("bn", [128, 64])
def test_epilogue_relabelling_is_a_bijection(bn):
    """The 128 consumer threads' fragments (f = tid + 128 q) cover a
    block's partial once, and their elements map onto the 16 x BN tile
    once: tile T's column q is weight column NT q + T."""
    f, m, col = _epilogue_map(bn)
    assert np.array_equal(np.sort(f), np.arange(bn // 8 * 32))
    cells = (m * bn + col).ravel()
    assert np.array_equal(np.sort(cells), np.arange(16 * bn))


# (k, n) of every decode projection -> (BN, cluster) on 132 SMs
_DECODE_SHAPES = {
    "llama3-8b wq / wo": (4096, 4096, 128, 4),
    "llama3-8b wk / wv": (4096, 1024, 64, 8),
    "llama3-8b w1 / w3": (4096, 14336, 128, 1),
    "llama3-8b w2": (14336, 4096, 128, 4),
    "llama3-8b head": (4096, 128256, 128, 1),
    "h2o wq / wo": (3840, 3840, 128, 4),
    "h2o wk / wv": (3840, 960, 64, 8),
    "h2o w1 / w3": (3840, 10240, 128, 1),
    "h2o w2": (10240, 3840, 128, 4),
    "h2o head": (3840, 32000, 128, 1),
}


@pytest.mark.parametrize("name", sorted(_DECODE_SHAPES))
@pytest.mark.parametrize("packed", [False, True])
def test_decode_plan_of_every_decode_shape(name, packed):
    """BN and the cluster size of each decode projection (the table in
    ``decode_plan``'s docstring), the TMA route at aligned addresses, the
    grid and the shared memory; M 1..16 plan alike."""
    k, n, bn, c = _DECODE_SHAPES[name]
    for m in (1, 4, 16):
        p = k1.launch_plan(m, n, k, 132, packed, 1 << 20, 1 << 21)
        assert (p.tile, p.route, p.bn, p.cluster) == (0, "tma", bn, c)
        assert p.grid == (-(-n // bn), 1, c)
        assert p.smem == k1.decode_smem(bn, packed) <= 232448 // 2


@pytest.mark.parametrize("n,k,x_off,w_off,route", [
    (4096, 4096, 0, 0, "tma"), (100, 4096, 0, 0, "copy"),
    (4096, 300, 0, 0, "copy"), (96, 4096, 1, 0, "copy"),
    (96, 4096, 0, 8, "copy"), (960, 3840, 16, 32, "tma"),
    (7, 7, 0, 0, "copy"), (48, 208, 0, 0, "tma")])
def test_decode_route_rule(n, k, x_off, w_off, route):
    """TMA exactly where N and K are multiples of 16 and both operands
    16-byte aligned, from the shape and the addresses alone."""
    for packed in (False, True):
        p = k1.decode_plan(4, n, k, 132, packed, 4096 + x_off, 8192 + w_off)
        assert p.route == route


@pytest.mark.parametrize("k", [7, 200, 300, 4096, 14336])
@pytest.mark.parametrize("n", [7, 48, 260, 960, 1024, 4096])
def test_decode_k_ranges_are_whole_stages(k, n):
    """Each rank's K range is a whole number of ring stages; the ranks
    cover [0, K) once (ranks past K have none); the cluster never exceeds
    the stages or 8; the blocks fill at most one wave unless the N tiles
    alone do."""
    for sms in (132, 114):
        for packed in (False, True):
            p = k1.decode_plan(16, n, k, sms, packed)
            ks = k1.decode_k_step(packed)
            stages = -(-k // ks)
            assert p.k_per_split % ks == 0 and p.k_per_split > 0
            assert p.cluster in k1.DECODE_CLUSTERS and p.cluster <= stages
            covered = np.zeros(k, np.int64)
            for r in range(p.cluster):
                covered[r * p.k_per_split:(r + 1) * p.k_per_split] += 1
            assert np.all(covered == 1)
            blocks = p.grid[0] * p.cluster
            assert blocks <= sms or (p.cluster == 1 and p.bn == 128
                                     and -(-n // 128) >= sms)


class _Lib:
    """A stand-in kernel library: records the entry points called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,n,route", [
    (4, 4096, 1024, "tma"), (16, 14336, 256, "tma"), (5, 300, 260, "copy")])
def test_decode_launch_has_no_workspace(monkeypatch, packed, m, k, n,
                                        route):
    """A decode launch (driven here through the wrapper with a stand-in
    library) allocates no workspace (``torch.zeros`` raises), calls one
    kernel entry point and counts one launch; the TMA route encodes its
    two tensor maps once and reuses them.  A split M > 16 launch does
    zero its workspace and tile counter."""
    lib = _Lib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_abi, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(k1, "_TMAPS", {})
    zeros = torch.zeros

    def no_zeros(*a, **kw):
        raise AssertionError("a decode launch allocated a workspace")

    monkeypatch.setattr(torch, "zeros", no_zeros)
    name = "int8_matmul_packed" if packed else "int8_matmul"
    rng = np.random.default_rng(m + k + n)
    x, wb = _operands(rng, m, k, n, packed)
    x8, w = T(x), T(wb)
    if route == "copy":
        assert k % 16 or n % 16
    for rep in range(2):
        before = kernels.LAUNCHES[name]
        out = k1._launch(name, x8, w, RequantSpec.raw(), None, None, packed)
        assert out.shape == (m, n) and out.dtype == torch.int32
        assert kernels.LAUNCHES[name] == before + 1
        maps = 2 if route == "tma" and rep == 0 else 0
        assert lib.calls == ["r8_tensor_map_2d"] * maps + [
            "r8_int8_matmul_decode"]
        lib.calls.clear()
    monkeypatch.setattr(torch, "zeros", zeros)
    made = []
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, **kw: made.append(a) or zeros(*a, **kw))
    x17 = T(rng.integers(-128, 128, (17, k)).astype(np.int8))
    k1._launch(name, x17, w, RequantSpec.raw(), None, None, packed)
    assert lib.calls == ["r8_int8_matmul"]
    assert len(made) == (2 if k1.launch_plan(17, n, k, 132).grid[2] > 1
                         else 0)


def test_decode_args_mirror_the_c_struct():
    """``_abi.DecodeArgs``: five pointers, the Requant, eight ints (the
    layout of ``dec::Args``)."""
    names = [f[0] for f in _abi.DecodeArgs._fields_]
    assert names == ["x", "w", "bias", "bvec", "out", "rq", "out_is_int8",
                     "M", "N", "K", "k_per_split", "use_tma", "vec_x",
                     "vec_w"]
    assert ctypes.sizeof(_abi.DecodeArgs) == 5 * 8 + 6 * 4 + 8 * 4
