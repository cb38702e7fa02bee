"""K4's launch plan and the schedule of its tensor-core kernel
(``csrc/int_paged_prefill.cu`` over the K5 body of
``csrc/int_attention_mma.cuh``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
Here: the plan the wrapper launches (grid, key tiles, shared memory, the
e16 store, 16-byte or word copies), built from shapes alone and never from
``pos_end``; and a numpy emulation of the kernel's schedule -- the rows of
a block's warps, the paged row address of each key of a tile, the stepped live range of every row, the
block's tile range and each warp's tile skip -- held equal to
:func:`int_paged_prefill_plain` with permuted page tables, null-page lanes
and lanes whose ``pos_end`` is below the chunk; and the plain version held
equal to the Pallas kernel (interpret mode).
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from test_torch_k5_plan import _exp16_mma

from repro.core import attention as j_attn
from repro.kernels.int_attention_fused import \
    int_paged_prefill_fused as j_prefill
from repro_torch.interop import plan_from_reference
from repro_torch.kernels import int_attention_fused as F
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._abi import exp16_consts
from repro_torch.ops.spec import RequantSpec

SMEM_LIMIT = 232448          # dynamic shared memory a block may have (H100)
ROWS, KEYS, NEG = 64, 64, -(1 << 30)

# ------------------------------------------------------------ the plan ----

_CS = (1, 7, 32, 64, 96)
_PAGES = ((1, 300), (8, 40), (16, 32), (64, 8))      # (page_size, max_pages)


@pytest.mark.parametrize("d", [32, 64, 120, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("c", _CS)
def test_k4_launch_plan(d, group, c):
    """Every chunk, page geometry and KV group gets a plan within the
    card's shared memory: K5's 64-row blocks cover every (row, head,
    lane) once, the tiles cover the page table's whole span, the e16
    store is taken exactly where it fits, word copies exactly off 16-byte
    alignment -- K5's own plan for a chunk over the span without a
    mask."""
    hkv = 2
    h = group * hkv
    for ps, maxp in _PAGES:
        p = F.k4_launch_plan(3, c, h, hkv, d, maxp, ps, 1 << 20)
        assert p.grid == (-(-c // ROWS), h, 3)
        assert p == F.k5_launch_plan(3, c, maxp * ps, h, hkv, d, False, 0,
                                     1 << 20)
        assert p.tiles == -(-(maxp * ps) // KEYS)
        assert p.smem <= SMEM_LIMIT
        assert p.store_e16 == (F.k5_smem_bytes(d, p.tiles, True)
                               <= SMEM_LIMIT)
        assert p.smem == F.k5_smem_bytes(d, p.tiles, p.store_e16)
        assert p.vec_k
        off = F.k4_launch_plan(3, c, h, hkv, d, maxp, ps, (1 << 20) + 4)
        assert off == p._replace(vec_k=False)


def test_k4_plan_at_the_serve_shape():
    """The serve path's chunk (C 32, 32 heads over 8 KV heads, 512
    positions in 16-row pages): a (1, 32, 4) grid, 8 tiles and the e16
    store in 94 208 bytes; the longest table the row sum allows
    recomputes."""
    p = F.k4_launch_plan(4, 32, 32, 8, 128, 32, 16, 0)
    assert p == F.K5Plan((1, 32, 4), 8, 94208, True, True)
    long = F.k4_launch_plan(4, 32, 32, 8, 128, 2048, 16, 0)
    assert (long.tiles, long.store_e16, long.smem) == (512, False, 28672)
    assert not F.k4_launch_plan(4, 32, 32, 8, 128, 32, 16, 0,
                                e16_fits=False).store_e16


def test_k4_plan_refusals():
    """Head dims the kernel is not compiled for and ragged GQA raise;
    C above 64 tiles over query blocks."""
    assert F.k4_launch_plan(4, 96, 32, 8, 128, 32, 16, 0).grid == (2, 32, 4)
    with pytest.raises(ValueError, match="head dim"):
        F.k4_launch_plan(4, 32, 32, 8, 96, 32, 16, 0)
    with pytest.raises(ValueError, match="Hkv"):
        F.k4_launch_plan(4, 32, 6, 4, 128, 32, 16, 0)


class _DeviceOnly(torch.Tensor):
    """A tensor whose values must stay where they are: every way of
    reading them on the host raises."""

    def _refuse(self, *a, **k):
        raise AssertionError("pos_end / pages read on the host")

    item = tolist = numpy = cpu = _refuse
    __int__ = __index__ = __bool__ = __float__ = __iter__ = _refuse


def test_k4_plan_never_reads_pos_end():
    """The plan takes shapes only, and packing a launch hands ``pos_end``,
    the page table and the shifts of packed int4 pools over as pointers
    without reading a value."""
    params = list(inspect.signature(F.k4_launch_plan).parameters)
    assert params == ["b", "c", "h", "hkv", "d", "max_pages", "page_size",
                      "k_addr", "e16_fits", "packed"]
    jp = j_attn.make_iattention(64, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    plan = plan_from_reference(jp)
    F.e16_fits_16_bits(plan.sm)                    # warm the plan caches
    q8 = torch.zeros((2, 32, 8, 64), dtype=torch.int8)
    pool = torch.zeros((9, 16, 2, 64), dtype=torch.int8)
    pos_end = torch.tensor([40, 64], dtype=torch.int32).as_subclass(
        _DeviceOnly)
    pages = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4).as_subclass(
        _DeviceOnly)
    args, out, kp = F.k4_args(q8, pool, pool, plan, pos_end, pages, 16,
                              RequantSpec.per_tensor(plan.dn_out), None)
    assert args.pos_end == pos_end.data_ptr()
    assert args.pages == pages.data_ptr()
    assert (args.Sq, args.Skv, args.tiles) == (32, 64, 1)
    assert kp.grid == (1, 8, 2) and tuple(out.shape) == (2, 32, 8, 64)
    assert not args.k_shift and not args.v_shift
    packed = torch.zeros((9, 16, 2, 32), dtype=torch.int8)
    shifts = tuple(torch.full((9,), 4, dtype=torch.int32).as_subclass(
        _DeviceOnly) for _ in range(2))
    args, out, kp = F.k4_args(q8, packed, packed, plan, pos_end, pages, 16,
                              RequantSpec.per_tensor(plan.dn_out), None,
                              kv_shifts=shifts)
    assert (args.k_shift, args.v_shift) == tuple(x.data_ptr()
                                                 for x in shifts)
    assert not args.vec_k and not kp.vec_k
    assert kp.smem == F.k4_launch_plan(2, 32, 8, 2, 64, 4, 16, 0).smem


# --------------------------------------------------- the kernel's order --

def _wrap(x):
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def _hi(c, span, vl, i):
    """The stepped mask's end of row ``i`` (``k5::row_range<true>``)."""
    if i >= c:
        return 0
    return min(max(vl - (c - 1 - i), 0), span)


def emulate_k4(q8, k_pool, v_pool, plan, pos_end, pages, ps, requant,
               b_vec=None, stats=None):
    """numpy, in the kernel's order: per block (query block, head, lane)
    the key range [0, hi of its last row), per warp its 16 rows, the tiles it skips (outside its rows' range), each
    tile's keys gathered row by row through the page table (keys past the
    block's range zero), then the three sweeps and the epilogue."""
    b, c, h, d = q8.shape
    hkv = k_pool.shape[2]
    maxp = pages.shape[1]
    span, group = maxp * ps, h // hkv
    kp = F.k4_launch_plan(b, c, h, hkv, d, maxp, ps, 0, True)
    ie = plan.sm.iexp
    ex = exp16_consts(plan.sm, *F.exp16_divisor(ie.q_ln2,
                                                ie.z_max * ie.q_ln2))
    kflat = k_pool.reshape(-1, hkv, d).astype(np.int64)
    vflat = v_pool.reshape(-1, hkv, d).astype(np.int64)
    acc_all = np.zeros((b, c, h, d), dtype=np.int64)
    written = np.zeros((b, c, h), dtype=np.int64)
    st_ = stats if stats is not None else {}
    for key in ("tiles", "warp_tiles_skipped"):
        st_.setdefault(key, 0)
    gx, gy, gz = kp.grid
    for lane in range(gz):
        vl = int(pos_end[lane])
        for head in range(gy):
            hk = head // group
            for bx in range(gx):
                q0 = bx * ROWS
                t_hi = _hi(c, span, vl, min(q0 + ROWS, c) - 1)
                nt = -(-t_hi // KEYS)
                kt = np.zeros((nt, KEYS, d), dtype=np.int64)
                vt = np.zeros((nt, KEYS, d), dtype=np.int64)
                for key in range(t_hi):                # live tiles' keys
                    row = pages[lane, key // ps] * ps + key % ps
                    kt[key // KEYS, key % KEYS] = kflat[row, hk]
                    vt[key // KEYS, key % KEYS] = vflat[row, hk]
                st_["tiles"] += nt
                for w in range(ROWS // 16):
                    wr0 = q0 + 16 * w
                    rows = wr0 + np.arange(16)
                    valid = rows < c
                    hi = np.array([_hi(c, span, vl, int(r)) for r in rows])
                    w_hi = hi[valid].max() if valid.any() else 0
                    q = np.where(valid[:, None],
                                 q8[lane, np.minimum(rows, c - 1), head], 0)
                    q = q.astype(np.int64)
                    mine = [ti for ti in range(nt) if ti * KEYS < w_hi]
                    st_["warp_tiles_skipped"] += nt - len(mine)
                    m = np.full(16, NEG, dtype=np.int64)
                    s = np.zeros(16, dtype=np.int64)
                    acc = np.zeros((16, d), dtype=np.int64)
                    e16s = {}
                    for ti in mine:                     # sweep 0: max
                        sc = q @ kt[ti].T
                        live = ti * KEYS + np.arange(KEYS)[None] < hi[:, None]
                        m = np.maximum(m, np.where(live, sc, NEG).max(-1))
                    for ti in mine:                     # sweep 1: sum, e16
                        sc = q @ kt[ti].T
                        live = ti * KEYS + np.arange(KEYS)[None] < hi[:, None]
                        e16 = np.where(live, _exp16_mma(
                            _wrap(sc - m[:, None]), ex), 0)
                        e16s[ti] = e16
                        s = s + e16.sum(-1)
                    rcp = (1 << 30) // np.maximum(s, 1)
                    for ti in mine:                     # sweep 2: P·V
                        p8 = np.clip(_wrap(_wrap(e16s[ti] * rcp[:, None])
                                           + (1 << 22)) >> 23, 0, 127)
                        acc = acc + p8 @ vt[ti]
                    for j in np.flatnonzero(valid):
                        acc_all[lane, rows[j], head] = acc[j]
                        written[lane, rows[j], head] += 1
    assert (written == 1).all()                # every output row once
    out = _ref.apply_attn_requant(
        torch.as_tensor(_wrap(acc_all).astype(np.int32)), requant,
        None if b_vec is None else torch.as_tensor(b_vec))
    return out


def _operands(seed, b, c, h, hkv, d, ps, maxp, pos_end):
    """Pools with a spare null page 0 and a permuted page table; lanes in
    ``pos_end`` order.  Lane 1's table is all the null page."""
    rng = np.random.default_rng(seed)
    num = b * maxp + 1
    kp = rng.integers(-128, 128, (num, ps, hkv, d)).astype(np.int8)
    vp = rng.integers(-128, 128, (num, ps, hkv, d)).astype(np.int8)
    pages = rng.permutation(np.arange(1, num)).reshape(b, maxp)
    pages = pages.astype(np.int32)
    if b > 1:
        pages[1] = 0
    q8 = rng.integers(-128, 128, (b, c, h, d)).astype(np.int8)
    return q8, kp, vp, pages, np.array(pos_end, dtype=np.int32)


def _plan(d):
    jp = j_attn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    return jp, plan_from_reference(jp)


# (C, page_size, max_pages, group, D): every chunk, page size, group and
# head dim of the plan test, each at least once
_SCHEDULES = [(1, 8, 12, 4, 32), (7, 1, 90, 2, 64), (32, 16, 8, 4, 128),
              (32, 64, 2, 1, 32), (64, 8, 20, 8, 64), (96, 16, 9, 2, 32),
              (7, 64, 3, 8, 128), (96, 1, 200, 1, 64)]


@pytest.mark.parametrize("c,ps,maxp,group,d", _SCHEDULES)
def test_schedule_emulation_matches_plain(c, ps, maxp, group, d):
    """The emulated kernel equals the plain version on four lanes: one
    whose pos_end is below the chunk (its first rows see no key), one on
    the null page, one with no live key at all and one at the table's
    full span; per-tensor and raw epilogues."""
    span = maxp * ps
    hkv = 2
    h = group * hkv
    pos_end = [max(c // 2, 1), c, 0, span]
    q8, kp, vp, pages, pe = _operands(c + ps + d, 4, c, h, hkv, d, ps, maxp,
                                      pos_end)
    _, plan = _plan(d)
    T = torch.as_tensor
    for rq in (RequantSpec.per_tensor(plan.dn_out), RequantSpec.raw()):
        want = F.int_paged_prefill_plain(T(q8), T(kp), T(vp), plan, T(pe),
                                         T(pages), ps, requant=rq)
        stats = {}
        got = emulate_k4(q8, kp, vp, plan, pe, pages, ps, rq, stats=stats)
        assert np.array_equal(got.numpy().astype(np.int64),
                              want.numpy().astype(np.int64))
        assert stats["tiles"] > 0


def test_schedule_skips_tiles_past_each_warps_rows():
    """At C = 96 the first block (rows 0..63)
    walks tiles [0, 4) (row 63 sees 224 keys) while its first warp's rows
    end at 176 keys: that warp skips the fourth tile, and the integers
    are still the plain version's."""
    c, ps, maxp, d = 96, 16, 16, 32
    q8, kp, vp, pages, pe = _operands(5, 2, c, 2, 1, d, ps, maxp,
                                      [256, 256])
    _, plan = _plan(d)
    stats = {}
    rq = RequantSpec.per_tensor(plan.dn_out)
    got = emulate_k4(q8, kp, vp, plan, pe, pages, ps, rq, stats=stats)
    T = torch.as_tensor
    want = F.int_paged_prefill_plain(T(q8), T(kp), T(vp), plan, T(pe),
                                     T(pages), ps, requant=rq)
    assert np.array_equal(got.numpy(), want.numpy())
    assert stats["warp_tiles_skipped"] > 0


@pytest.mark.parametrize("c,ps,maxp,d", [(7, 8, 6, 32), (32, 16, 4, 64)])
def test_plain_matches_pallas(c, ps, maxp, d):
    """The plain version equals the Pallas kernel (interpret mode) at two
    of the emulated shapes: GQA 4 over 2, a lane below the chunk, a lane
    on the null page."""
    span = maxp * ps
    hkv, h = 2, 8
    q8, kp, vp, pages, pe = _operands(c + d, 3, c, h, hkv, d, ps, maxp,
                                      [max(c // 2, 1), c, span])
    jp, plan = _plan(d)
    want = j_prefill(jnp.asarray(q8), jnp.asarray(kp), jnp.asarray(vp), jp,
                     jnp.asarray(pe), jnp.asarray(pages), ps, bkv=16,
                     interpret=True)
    T = torch.as_tensor
    got = F.int_paged_prefill_plain(T(q8), T(kp), T(vp), plan, T(pe),
                                    T(pages), ps)
    assert np.array_equal(got.numpy(), np.asarray(want))
