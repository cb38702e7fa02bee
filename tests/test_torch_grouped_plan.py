"""K1's grouped instantiation (the MoE expert products), modelled in numpy
on the CPU.

``csrc/int8_matmul_grouped.cu`` cannot run here, so its plan and its
index arithmetic are modelled from ``kernels/int8_matmul.py``'s
``grouped_plan`` / ``grouped_split``:

  * the plan of every expert product of qwen2-moe-a2.7b, qwen3-moe-235b-
    a22b and jamba-v0.1-52b at a decode step and at a 4 x 512 pass: route,
    row tile, cluster, grid, threads, shared memory; the split each block
    chooses on the card from the live items, its K ranges covering K once;
    the compaction of the live experts and the workers' striding over the
    items for the row patterns "spread", "empty", "one", "full" and "all
    zero";
  * the stage images: the 3-D TMA boxes of w (E, K, N) and x (E, R, K),
    zero past K, N and R inside an expert (never a byte of the next one),
    in the 128-byte swizzle, and the copy route's masked words, equal;
  * the lanes' 8-byte weight loads, their 4 x 4 byte transposes into the B
    words of eight n8 tiles, the A words of one ldmatrix.x4 a tile (K in
    the plain order),
    ``mma.sync.m16n8k32``'s fragments, the warps' m16 tiles, the split's
    exchange between the ranks of a group and the epilogue's relabelling
    (16 consecutive columns a lane), held with ``torch.equal`` against
    ``int8_matmul_grouped_plain``;
  * the banks of the fragment loads; one launch and no workspace through
    the wrapper with a stand-in library.

Tolerance: 0.
"""
import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _abi, _build
from repro_torch.kernels import int8_matmul as k1
from repro_torch.models.intlayers import moe_capacity
from repro_torch.ops.spec import RequantSpec

T = torch.as_tensor
BN, KS = k1.GROUPED_BN, k1.GROUPED_KS
LANE = np.arange(32)
G, TT = LANE // 4, LANE % 4


def _wswz(row, col):
    """Byte offset of (row, col) in a 128 x 128 weight tile
    (``dec::wswz<128>``: the TMA's 128-byte swizzle)."""
    return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15)


def _xswz(m, col):
    """Byte offset of (row m, K byte col) in an x box (``dec::xswz``)."""
    return m * 128 + ((((col >> 4) ^ m) & 7) << 4) + (col & 15)


def _wrap(a):
    return ((np.asarray(a, np.int64) + 2**31) % 2**32) - 2**31


def _tma_images(x, w, e, n0, k0, m0, rt):
    """A stage as the two 3-D TMA boxes write it: w's (128 K rows x 128
    columns) at (n0, k0, e) and x's (rt rows x 128 K) at (k0, m0, e), zero
    where the box leaves the expert's (K, N) or (R, K)."""
    _, r_, k = x.shape
    n = w.shape[2]
    kk, nn = k0 + np.arange(KS), n0 + np.arange(BN)
    tile = np.zeros((KS, BN), np.uint8)
    ok = (kk[:, None] < k) & (nn[None, :] < n)
    tile[ok] = w[e].view(np.uint8)[np.minimum(kk, k - 1)[:, None],
                                   np.minimum(nn, n - 1)[None, :]][ok]
    rr, cc = np.meshgrid(np.arange(KS), np.arange(BN), indexing="ij")
    wimg = np.zeros(KS * BN, np.uint8)
    wimg[_wswz(rr, cc).ravel()] = tile.ravel()
    mm, kc = m0 + np.arange(rt), k0 + np.arange(128)
    box = np.zeros((rt, 128), np.uint8)
    ok = (mm[:, None] < r_) & (kc[None, :] < k)
    box[ok] = x[e].view(np.uint8)[np.minimum(mm, r_ - 1)[:, None],
                                  np.minimum(kc, k - 1)[None, :]][ok]
    mr, cc = np.meshgrid(np.arange(rt), np.arange(128), indexing="ij")
    ximg = np.zeros(rt * 128, np.uint8)
    ximg[_xswz(mr, cc).ravel()] = box.ravel()
    return wimg, ximg


def _copy_images(x, w, e, n0, k0, m0, rt):
    """The same stage as ``copy_stage`` writes it: word u of the weight
    tile (row u / 32, bytes 4 (u % 32)..) and of the x box, each byte kept
    where ``load4``'s limit (N - n, K - k) and the row bound (K, R) allow,
    stored at the swizzled offset of its first byte."""
    _, r_, k = x.shape
    n = w.shape[2]
    wb, xb = w[e].view(np.uint8), x[e].view(np.uint8)
    j4 = np.arange(4)
    u = np.arange(KS * (BN // 4))
    r, c = u // (BN // 4), 4 * (u % (BN // 4))
    kk, nn = k0 + r[:, None], n0 + c[:, None] + j4
    keep = (kk < k) & (nn < n)
    wimg = np.zeros(KS * BN, np.uint8)
    wimg[_wswz(r, c)[:, None] + j4] = np.where(
        keep, wb[np.minimum(kk, k - 1), np.minimum(nn, n - 1)], 0)
    u = np.arange(rt * 32)
    r, c = u // 32, 4 * (u % 32)
    mm, kc = m0 + r[:, None], k0 + c[:, None] + j4
    keep = (mm < r_) & (kc < k)
    ximg = np.zeros(rt * 128, np.uint8)
    ximg[_xswz(r, c)[:, None] + j4] = np.where(
        keep, xb[np.minimum(mm, r_ - 1), np.minimum(kc, k - 1)], 0)
    return wimg, ximg


def _b_words(wimg, j, wn):
    """Lane (g, t)'s B words of k32 step j for warp column wn: (32 lanes,
    8 tiles T, 2 (b0, b1), 4 K values); its 8-byte loads from rows
    16 h + 4 t + r at column 64 wn + 8 g, transposed (``transpose4``):
    tile T is weight column 64 wn + 8 g + T, K in the plain order."""
    col = 64 * wn + 8 * G
    out = np.zeros((32, 8, 2, 4), np.int64)
    sw = wimg.view(np.int8)
    for h in range(2):
        for r in range(4):
            addr = j * 32 * BN + _wswz(16 * h + 4 * TT + r, col)
            assert np.all(addr % 8 == 0)
            out[:, :, h, r] = sw[addr[:, None] + np.arange(8)]
    return out


def _ldmatrix_addrs(j, row0):
    """The 32 lanes' row addresses of ``a_tile``'s ldmatrix.x4: lane L
    gives row L % 8 of matrix L / 8 (rows 8 (q & 1).., 16-byte K chunk
    2 j + (q >> 1))."""
    row = row0 + (LANE & 7) + 8 * ((LANE >> 3) & 1)
    return _xswz(row, 16 * (2 * j + (LANE >> 4)))


def _a_words(ximg, j, row0):
    """Lane (g, t)'s A registers a0..a3 of k32 step j for the m16 tile at
    box row row0, as ldmatrix.x4 delivers them: register q is word t of
    row g of matrix q: (32, 4 registers, 4 K values)."""
    sx = ximg.view(np.int8)
    addr = _ldmatrix_addrs(j, row0)
    regs = np.zeros((32, 4, 4), np.int64)
    for q in range(4):
        rows = addr[8 * q:8 * q + 8]             # matrix q's 8 row addresses
        regs[:, q] = sx[rows[G][:, None] + 4 * TT[:, None] + np.arange(4)]
    return regs


def _mma(a_regs, b_words):
    """``mma.sync.m16n8k32``: A (16 x 32) and each tile's B (32 x 8) from
    the lanes' registers by the PTX fragment layout; C's lane registers
    (c0 C[g][2t], c1 C[g][2t+1], c2 / c3 row g + 8): (8 tiles, 32, 4)."""
    i = np.arange(4)
    a = np.zeros((16, 32), np.int64)
    for reg, (ro, ko) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        a[(G + ro)[:, None], (ko + 4 * TT)[:, None] + i] = a_regs[:, reg]
    b = np.zeros((8, 32, 8), np.int64)
    for h in range(2):
        b[:, (16 * h + 4 * TT)[:, None] + i, G[:, None]] = np.moveaxis(
            b_words[:, :, h], 1, 0)
    c = np.matmul(a[None], b)
    return np.stack([c[:, G, 2 * TT], c[:, G, 2 * TT + 1],
                     c[:, G + 8, 2 * TT], c[:, G + 8, 2 * TT + 1]], axis=-1)


def _shape(rt):
    """(WM, MT) of the instantiation of row tile rt."""
    return (1, 1) if rt == 16 else (3, rt // 48)


def _card_split(plan, k, items):
    """The split as every block computes it (the kernel's loop)."""
    stages = -(-k // KS)
    split = 1
    c2 = 2
    while _shape(plan.rt)[0] == 1 and c2 <= plan.cluster:
        if (items * c2 <= plan.grid[0] and 2 * c2 <= stages
                and (c2 - 1) * -(-stages // c2) < stages):
            split = c2
        c2 *= 2
    return split


def _emulate(x, w, rows, plan):
    """The kernel's raw int32 accumulators, block by block: the live list,
    each worker's items, each rank's stages (TMA image == copy image),
    the warps' fragments, the exchange to each pair's owner and the
    epilogue's (row, column) of every element.  Returns (out (E, R, N)
    with unwritten entries None-marked as -2^40, items done per
    worker)."""
    e_, r_, k = x.shape
    n = w.shape[2]
    cnt = np.clip(np.asarray(rows), 0, r_)
    live = [i for i in range(e_) if cnt[i] > 0]
    ntiles = -(-n // BN)
    items = len(live) * ntiles
    c, wm_n, mt = plan.cluster, *_shape(plan.rt)
    split = _card_split(plan, k, items)
    assert (split, ) == k1.grouped_split(plan, k, items)[:1]
    groups = c // split
    workers = plan.grid[0] // c * groups
    stages = -(-k // KS)
    kper = -(-stages // split) * KS
    out = np.full((e_, r_, n), -2**40, np.int64)
    done = np.zeros(workers, np.int64)
    for worker in range(workers):
        for item in range(worker, items, workers):
            done[worker] += 1
            ex, n0 = live[item // ntiles], item % ntiles * BN
            for m0 in range(0, int(cnt[ex]), plan.rt):
                # each rank's partial: lanes (warp wm, wn; tile i) x 8 x 4
                part = np.zeros((split, wm_n, 2, mt, 8, 32, 4), np.int64)
                for sub in range(split):
                    kbeg = sub * kper
                    for s in range(-(-(min(k, kbeg + kper) - kbeg) // KS)):
                        k0 = kbeg + s * KS
                        wimg, ximg = _tma_images(x, w, ex, n0, k0, m0,
                                                 plan.rt)
                        cw, cx = _copy_images(x, w, ex, n0, k0, m0, plan.rt)
                        assert np.array_equal(wimg, cw)
                        assert np.array_equal(ximg, cx)
                        for j in range(KS // 32):
                            for wn in range(2):
                                bw = _b_words(wimg, j, wn)
                                for wm in range(wm_n):
                                    for i in range(mt):
                                        row0 = 16 * (wm + wm_n * i)
                                        part[sub, wm, wn, i] += _mma(
                                            _a_words(ximg, j, row0), bw)
                total = _wrap(part.sum(axis=0))
                # the epilogue: element q of tile T at lane (g, t) is row
                # m0 + 16 (wm + WM i) + g + 8 (q / 2), column n0 + 64 wn +
                # 16 t + 8 (q % 2) + T
                for wm in range(wm_n):
                    for wn in range(2):
                        for i in range(mt):
                            for q in range(4):
                                m = m0 + 16 * (wm + wm_n * i) + G + 8 * (q // 2)
                                for tt in range(8):
                                    col = (n0 + 64 * wn + 16 * TT
                                           + 8 * (q % 2) + tt)
                                    keep = (m < cnt[ex]) & (col < n)
                                    out[ex, m[keep], col[keep]] = \
                                        total[wm, wn, i, tt][keep, q]
    return out, done


def _operands(rng, e, r, k, n):
    x = rng.integers(-128, 128, (e, r, k)).astype(np.int8)
    w = rng.integers(-128, 128, (e, k, n)).astype(np.int8)
    return x, w


def _rows(case, e, r):
    if case == "one":
        return [r] + [0] * (e - 1)
    if case == "full":
        return [r] * e
    if case == "zero":
        return [0] * e
    rows = [min(r, 1 + (3 * i) % (r + 1)) for i in range(e)]
    if case == "empty":
        rows[1] = 0
    return rows


@pytest.mark.parametrize("e,r,k,n,sms,case", [
    (3, 16, 1024, 160, 4, "spread"),   # 6 items, 4 blocks: 2 rounds
    (3, 16, 1024, 160, 8, "empty"),    # 4 items x 2 ranks on 8 blocks
    (4, 16, 1024, 100, 16, "one"),     # one item: 2 ranks, ragged N
    (3, 4, 208, 96, 4, "full"),        # no split (2 stages), R < 16
    (3, 16, 512, 130, 4, "zero"),      # no item at all
    (2, 40, 208, 130, 4, "spread"),    # 48-row tile, ragged N
    (2, 90, 96, 64, 1, "full"),        # 96-row tile, K < one stage
    (1, 200, 64, 48, 2, "one"),        # 192-row tile: two chunks
])
def test_grouped_schedule_matches_plain(e, r, k, n, sms, case):
    """The emulated launch (live list, workers' items, the split and its
    ranks, both routes' stage images, lane loads, B and A words,
    fragments, warps and tiles, the exchange, the relabelled epilogue)
    gives ``int8_matmul_grouped_plain``'s raw integers on every row below
    rows[e], writes no other row, and does every live item once."""
    rng = np.random.default_rng(e * 1000 + r + k + n + sms)
    x, w = _operands(rng, e, r, k, n)
    rows = _rows(case, e, r)
    plan = k1.grouped_plan(e, r, n, k, sms)
    out, done = _emulate(x, w, rows, plan)
    assert done.sum() == k1.grouped_items(n, rows)
    want = k1.int8_matmul_grouped_plain(T(x), T(w), T(np.int32(rows)),
                                        RequantSpec.raw()).numpy()
    for ex, c in enumerate(rows):
        c = min(c, r)
        assert torch.equal(T(out[ex, :c].astype(np.int32)),
                           T(want[ex, :c]))
        assert (out[ex, c:] == -2**40).all()


# every expert product of the three MoE configs: (arch, linear) ->
# (E, K, N), and the plans on 132 SMs at a decode step (R = 4 tokens x
# capacity 4) and at a 4 x 512 pass (R = 4 x capacity(512))
_MOE = {
    "qwen2-moe-a2.7b": dict(decode=16, passr=160),
    "qwen3-moe-235b-a22b": dict(decode=16, passr=160),
    "jamba-v0.1-52b": dict(decode=16, passr=320),
}


def _moe_shapes():
    for arch in sorted(_MOE):
        cfg = get_config(arch)
        e, f, d = cfg.padded_experts(), cfg.moe_d_ff or cfg.d_ff, cfg.d_model
        for lin, k, n in (("w1", d, f), ("w3", d, f), ("w2", f, d)):
            yield arch, lin, e, k, n


@pytest.mark.parametrize("arch,lin,e,k,n", list(_moe_shapes()))
def test_grouped_plan_of_every_moe_shape(arch, lin, e, k, n):
    """Decode (R 16): the TMA route, 16-row tiles, clusters of 2 on 66
    clusters (one block an SM), 96 threads, shared memory within one SM's
    share; the 4 x 512 pass: no cluster, the smallest row tile holding R
    (192 beyond), 224 threads.  R comes from the configs' own capacity."""
    cfg = get_config(arch)
    r_dec = 4 * moe_capacity(cfg, 1)
    r_pass = 4 * moe_capacity(cfg, 512)
    assert (r_dec, r_pass) == (_MOE[arch]["decode"], _MOE[arch]["passr"])
    p = k1.grouped_plan(e, r_dec, n, k, 132, 1 << 20, 1 << 21)
    assert (p.route, p.rt, p.cluster, p.grid, p.threads) == (
        "tma", 16, 2, (132, 1, 1), 96)
    assert p.smem == k1.grouped_smem(16, e) <= 232448 // 2
    q = k1.grouped_plan(e, r_pass, n, k, 132, 1 << 20, 1 << 21)
    assert q.rt == next(t for t in (48, 96, 192, 192) if t >= min(r_pass,
                                                                  192))
    assert q.cluster == 1
    assert q.threads == 224 and q.route == "tma"
    assert q.grid[0] == min(132, e * -(-n // 128))
    assert q.smem <= 232448


@pytest.mark.parametrize("arch,lin,e,k,n", list(_moe_shapes()))
@pytest.mark.parametrize("case", ["spread", "empty", "one", "full", "zero"])
def test_grouped_split_and_striding(arch, lin, e, k, n, case):
    """For each rows pattern at a decode step: the live list is the
    experts with rows in order; the split's K ranges cover [0, K) once,
    none empty, two stages a rank on average; the workers take every item
    once (the cluster's groups distinct items), and a split never spreads
    items over more ranks than the grid's blocks."""
    cfg = get_config(arch)
    p = k1.grouped_plan(e, 16, n, k, 132)
    rng = np.random.default_rng(e + k + n)
    rows = _rows(case, e, 16)
    if case == "spread":
        rows = [int(v) for v in rng.permutation(
            [1] * min(e, 16) + [0] * (e - min(e, 16)))]
    live = [i for i, c in enumerate(rows) if c > 0]
    items = len(live) * -(-n // 128)
    assert items == k1.grouped_items(n, rows)
    split, kper, rounds = k1.grouped_split(p, k, items)
    assert split == _card_split(p, k, items)
    assert split == 1 or items * split <= p.grid[0]
    stages = -(-k // 128)
    covered = np.zeros(k, np.int64)
    for sub in range(split):
        covered[sub * kper:(sub + 1) * kper] += 1
        assert min(k, (sub + 1) * kper) - sub * kper > 0
    assert np.all(covered == 1) and kper % 128 == 0
    assert 2 * split <= stages or split == 1
    workers = p.grid[0] // split
    seen = np.zeros(items, np.int64)
    for wk in range(workers):
        mine = list(range(wk, items, workers))
        assert len(mine) <= rounds
        seen[mine] += 1
    assert np.all(seen == 1)
    assert cfg.n_experts <= e


def test_exchange_offsets_are_a_bijection():
    """For every split S of a cluster: the senders' int4 offsets into an
    owner's buffer ((sub (8 / S) + idx) 8 + g) 8 + T, over every rank of
    the group but the owner and every lane pair it owns, are distinct and
    within the 8 KB buffer; each (wn, t) pair has one owner."""
    for split in (2, 4, 8):
        for owner in range(split):
            offs = []
            for sub in range(split):
                if sub == owner:
                    continue
                for pair in range(8):
                    if pair % split != owner:
                        continue
                    idx = pair // split
                    for g in range(8):
                        base = ((sub * (8 // split) + idx) * 8 + g) * 8
                        offs += [base + tt for tt in range(8)]
            assert len(set(offs)) == len(offs)
            assert max(offs) < 8 * 8 * 8
        owners = [pair % split for pair in range(8)]
        assert sorted(set(owners)) == list(range(split))


def test_fragment_loads_and_their_banks():
    """The 8-byte weight loads (served 16 lanes at a time) of either warp
    column touch each 4-byte bank at two addresses at most (lanes t and
    t + 2 share a swizzle row); ldmatrix's eight row addresses of each
    matrix of every m16 tile of a 192-row box lie in 8 distinct 16-byte
    chunks (no conflict) and are 16-byte aligned; the swizzles are
    bijections."""
    rr, cc = np.meshgrid(np.arange(KS), np.arange(BN), indexing="ij")
    assert np.array_equal(np.sort(_wswz(rr, cc).ravel()),
                          np.arange(KS * BN))
    mm, cc = np.meshgrid(np.arange(192), np.arange(128), indexing="ij")
    assert np.array_equal(np.sort(_xswz(mm, cc).ravel()),
                          np.arange(192 * 128))
    for j in range(4):
        for wn in range(2):
            for h in range(2):
                for r in range(4):
                    addr = j * 32 * BN + _wswz(16 * h + 4 * TT + r,
                                               64 * wn + 8 * G)
                    for p0 in (0, 16):
                        words = (addr[p0:p0 + 16, None]
                                 + 4 * np.arange(2)).ravel() // 4
                        per_bank = {}
                        for wd in words.tolist():
                            per_bank.setdefault(wd % 32, set()).add(wd)
                        assert max(len(v) for v in per_bank.values()) <= 2
        for row0 in range(0, 192, 16):
            addr = _ldmatrix_addrs(j, row0)
            assert np.all(addr % 16 == 0)
            for q in range(4):
                chunks = (addr[8 * q:8 * q + 8] // 16) % 8
                assert len(set(chunks.tolist())) == 8


class _Lib:
    """A stand-in kernel library: records the entry points called."""

    def __init__(self):
        self.calls, self.args = [], []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            self.args.append(args)
            return 0
        return entry


@pytest.mark.parametrize("e,r,k,n,route", [
    (8, 16, 2048, 1408, "tma"), (8, 160, 1408, 2048, "tma"),
    (4, 16, 301, 96, "copy"), (4, 40, 200, 1410, "copy")])
def test_grouped_launch_is_one_kernel_without_workspace(monkeypatch, e, r,
                                                        k, n, route):
    """The launch (driven with a stand-in library) allocates no
    workspace (``torch.zeros`` raises), reads nothing of ``rows`` on the
    host, calls one kernel entry point with the plan's row tile, grid and
    shared memory, and counts one launch; the TMA route encodes its two
    3-D tensor maps once and reuses them."""
    lib = _Lib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_abi, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(k1, "_TMAPS", {})

    def no_zeros(*a, **kw):
        raise AssertionError("a grouped launch allocated a workspace")

    monkeypatch.setattr(torch, "zeros", no_zeros)
    rng = np.random.default_rng(e + r + k + n)
    x, w = _operands(rng, e, r, k, n)

    class Rows(torch.Tensor):
        """``rows`` whose host reads fail."""

        def tolist(self):
            raise AssertionError("rows read on the host")

        def item(self):
            raise AssertionError("rows read on the host")

    rows = T(np.int32(_rows("spread", e, r))).as_subclass(Rows)
    x8, w8 = T(x), T(w)
    plan = k1.grouped_plan(e, r, n, k, 132, x8.data_ptr(), w8.data_ptr())
    assert plan.route == route
    for rep in range(2):
        before = kernels.LAUNCHES["int8_matmul_grouped"]
        out = k1._grouped_launch(x8, w8, rows, RequantSpec.raw(), None,
                                 None)
        assert out.shape == (e, r, n) and out.dtype == torch.int32
        assert kernels.LAUNCHES["int8_matmul_grouped"] == before + 1
        maps = 2 if route == "tma" and rep == 0 else 0
        assert lib.calls == ["r8_tensor_map_3d"] * maps + [
            "r8_int8_matmul_grouped"]
        args, wmap, xmap, rt, blocks, smem, _ = lib.args[-1]
        assert (rt, blocks, smem) == (plan.rt, plan.grid[0], plan.smem)
        assert (wmap is None) == (route == "copy") == (xmap is None)
        st = args._obj
        assert (st.cluster, st.use_tma) == (plan.cluster,
                                            int(route == "tma"))
        if maps:
            assert lib.args[0][2:] == (n, k, e, BN, KS, 128)
            assert lib.args[1][2:] == (k, r, e, 128, plan.rt, 128)
        lib.calls.clear()
        lib.args.clear()


def test_grouped_args_mirror_the_c_struct():
    """``_abi.GroupedArgs``: six pointers, the Requant, nine ints (the
    layout of ``grp::Args``, padded to the pointers' 8 bytes)."""
    names = [f[0] for f in _abi.GroupedArgs._fields_]
    assert names == ["x", "w", "rows", "bias", "bvec", "out", "rq",
                     "out_is_int8", "E", "R", "N", "K", "cluster",
                     "use_tma", "vec_x", "vec_w"]
    assert ctypes.sizeof(_abi.GroupedArgs) == 6 * 8 + 6 * 4 + 9 * 4 + 4
