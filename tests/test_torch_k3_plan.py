"""K3's launch plan and the schedule of its Hopper kernel
(``csrc/int_decode_attention.cu``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
Here: the plan the wrapper launches (the cluster, the keys a rank holds,
the m16 tiles a block, resident or streaming, shared memory, the copy
granule), built from shapes alone and never from ``valid_len``; a numpy
emulation of the kernel's schedule -- the rows of a KV group's query
heads packed into m16 tiles, each rank's share of the lane's live keys,
paged row addresses through a permuted table with null-page lanes,
packed int4 rows expanded with each key's page shift, resident chunks or
streaming tiles of 128 keys over buffers that hold garbage past the
rank's keys, the three cluster reductions taken in shuffled rank order,
P·V split over the warps by output columns -- held equal to
:func:`int_decode_attention_plain`; and the plain version held equal to
the Pallas kernel (interpret mode).
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from test_torch_k5_plan import _exp16_mma

from repro.core import attention as j_attn
from repro.kernels.int_decode_attention import \
    int_decode_attention_fused as j_k3
from repro.ops import RequantSpec as JSpec
from repro_torch.interop import plan_from_reference
from repro_torch.kernels import int_attention_fused as F
from repro_torch.kernels import int_decode_attention as K3
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._abi import exp16_consts
from repro_torch.ops.spec import RequantSpec

SMEM_LIMIT = 232448          # dynamic shared memory a block may have (H100)
ROWS, CHUNK, TILE, WARPS, NEG = 32, 32, 128, 4, -(1 << 30)
T = torch.as_tensor

# ------------------------------------------------------------ the plan ----

_LENGTHS = (1, 100, 512, 4096, 32768)
_LAYOUTS = (("contiguous", False, False), ("paged", True, False),
            ("kv4", True, True))


@pytest.mark.parametrize("d", [32, 64, 120, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("sq", [1, 3, 8])
def test_k3_launch_plan(d, group, sq):
    """Every shape gets a plan within the card's shared memory: its
    blocks cover every (row block, lane, KV head) once, a cluster of 1,
    2, 4 or 8 whose ranks hold the whole span, the largest that keeps the
    blocks within one wave of 132 SMs and no larger than the span's
    32-key chunks, raised only as far as the resident route needs to fit;
    the resident route exactly where its block fits at some cluster size
    up to 8, streaming otherwise."""
    hkv = 2
    h = group * hkv
    for length in _LENGTHS:
        for _, paged, packed in _LAYOUTS:
            p = K3.k3_launch_plan(4, sq, h, hkv, d, length, paged, packed)
            rows = group * sq
            assert p.grid == (p.cluster, -(-rows // ROWS), 4 * hkv)
            assert p.cluster in (1, 2, 4, 8)
            assert p.mtb == (2 if rows > 16 else 1)
            assert p.rank_keys % 64 == 0 and p.rank_keys >= 64
            assert p.rank_keys * p.cluster >= length
            assert p.rank_keys == max(64, -(-(-(-length // p.cluster))
                                             // 64) * 64)
            assert p.smem == K3.k3_smem_bytes(d, p.rank_keys, p.mtb, paged,
                                              packed, p.resident)
            assert p.smem <= SMEM_LIMIT
            def keys(c):
                return max(64, -(-(-(-length // c)) // 64) * 64)

            def fits(c):
                return K3.k3_smem_bytes(d, keys(c), p.mtb, paged, packed,
                                        True) <= SMEM_LIMIT
            groups = 4 * hkv * p.grid[1]
            wave = [c for c in (1, 2, 4, 8) if c == 1 or groups * c <= 132]
            most = [c for c in (1, 2, 4, 8)
                    if c == 1 or c <= -(-length // CHUNK)]
            c0 = min(wave[-1], most[-1])
            if p.resident:
                assert p.cluster >= c0 and fits(p.cluster)
                assert not any(fits(c) for c in (1, 2, 4, 8)
                               if c0 <= c < p.cluster)
            else:
                assert p.cluster == max(c0, most[-1])
                assert not any(fits(c) for c in (1, 2, 4, 8) if c >= c0)
            assert p.copy_bytes == K3.k3_copy_bytes(d, packed, 0, 0)


def test_k3_route_flips_to_streaming():
    """At the serve widths (32 / 8 heads, D 128) a lane's keys stay
    resident up to the 4096-position window and stream past the point
    where 8 ranks' keys, V and scores no longer fit a block."""
    routes = {}
    for length in (512, 2048, 4096, 8192, 16384, 32768):
        p = K3.k3_launch_plan(4, 1, 32, 8, 128, length, True)
        routes[length] = p.resident
        big = K3.k3_smem_bytes(128, p.rank_keys, 1, True, False, True)
        assert p.resident == (big <= SMEM_LIMIT)
    assert routes == {512: True, 2048: True, 4096: True, 8192: False,
                      16384: False, 32768: False}


def test_k3_plan_at_the_path_shapes():
    """The serve row (4 lanes, 32 / 8 heads, D 128, 32 pages of 16): C 4,
    128 keys a rank, resident, 128 blocks (one wave) in 60 160 bytes; kv4
    the same in 61 184; h2o's contiguous L = 512 at D 120 (8-byte copies);
    the full 4096-position window at C 8 (4 would need 1024 keys a rank,
    too many to stay resident) with 512 keys a rank; Sq 8 packs 32 rows
    into two m16 tiles."""
    p = K3.k3_launch_plan(4, 1, 32, 8, 128, 512, True, False, 0, 0, 132)
    assert p == K3.K3Plan((4, 1, 32), 4, 128, 1, True, 60160, 16)
    assert K3.k3_launch_plan(4, 1, 32, 8, 128, 512, True, True).smem == 61184
    h2o = K3.k3_launch_plan(4, 1, 32, 8, 120, 512, False)
    assert (h2o.cluster, h2o.rank_keys, h2o.copy_bytes) == (4, 128, 8)
    win = K3.k3_launch_plan(4, 1, 32, 8, 120, 4096, False)
    assert (win.cluster, win.rank_keys, win.resident, win.smem) == (
        8, 512, True, 186112)
    sq8 = K3.k3_launch_plan(4, 8, 32, 8, 120, 4096, False)
    assert (sq8.mtb, sq8.grid, sq8.resident) == (2, (8, 1, 32), True)
    long = K3.k3_launch_plan(4, 1, 32, 8, 128, 32768, True, True)
    assert (long.cluster, long.rank_keys, long.resident) == (8, 4096, False)
    assert "resident" in p.describe() and "streaming" in long.describe()


def test_k3_plan_refusals_and_copies():
    """Head dims the kernel is not compiled for, ragged GQA, more than
    MAX_SQ rows and packed contiguous caches raise; copies are 16 / 8
    bytes where K and V are aligned to them, else 4 (packed D 120 rows of
    60 bytes always 4)."""
    with pytest.raises(ValueError, match="head dim"):
        K3.k3_launch_plan(4, 1, 32, 8, 96, 512, True)
    with pytest.raises(ValueError, match="Hkv"):
        K3.k3_launch_plan(4, 1, 6, 4, 128, 512, True)
    with pytest.raises(ValueError, match="query rows"):
        K3.k3_launch_plan(4, 9, 32, 8, 128, 512, True)
    with pytest.raises(ValueError, match="paged"):
        K3.k3_launch_plan(4, 1, 32, 8, 128, 512, False, True)
    assert K3.k3_copy_bytes(128, False, 0, 16) == 16
    assert K3.k3_copy_bytes(128, False, 4, 0) == 4
    assert K3.k3_copy_bytes(120, False, 8, 24) == 8
    assert K3.k3_copy_bytes(120, False, 8, 4) == 4
    assert K3.k3_copy_bytes(120, True, 0, 0) == 4
    assert K3.k3_copy_bytes(64, True, 16, 32) == 16
    assert K3.k3_copy_bytes(32, True, 0, 8) == 4


class _DeviceOnly(torch.Tensor):
    """A tensor whose values must stay where they are: every way of
    reading them on the host raises."""

    def _refuse(self, *a, **k):
        raise AssertionError("valid_len / pages read on the host")

    item = tolist = numpy = cpu = _refuse
    __int__ = __index__ = __bool__ = __float__ = __iter__ = _refuse


def test_k3_plan_never_reads_valid_len():
    """The plan takes shapes only, and packing a launch hands valid_len,
    the page table and the shifts of packed int4 pools over as pointers
    without reading a value."""
    params = list(inspect.signature(K3.k3_launch_plan).parameters)
    assert params == ["b", "sq", "h", "hkv", "d", "length", "paged",
                      "packed", "k_addr", "v_addr", "sms"]
    jp = j_attn.make_iattention(64, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    plan = plan_from_reference(jp)
    F.exp16_args(plan.sm)                          # warm the plan cache
    q8 = torch.zeros((2, 3, 8, 64), dtype=torch.int8)
    pool = torch.zeros((9, 16, 2, 64), dtype=torch.int8)
    vl = torch.tensor([40, 64], dtype=torch.int32).as_subclass(_DeviceOnly)
    pages = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4).as_subclass(
        _DeviceOnly)
    rq = RequantSpec.per_tensor(plan.dn_out)
    args, out, kp = K3.k3_args(q8, pool, pool, plan, vl, pages, 16, rq, None)
    assert args.vlen == vl.data_ptr() and args.pages == pages.data_ptr()
    assert (args.S, args.L, args.max_pages, args.page_size) == (3, 64, 4, 16)
    assert (args.cluster, args.rank_keys, args.mtb, args.smem) == (
        kp.cluster, kp.rank_keys, kp.mtb, kp.smem)
    assert kp == K3.k3_launch_plan(2, 3, 8, 2, 64, 64, True)
    assert tuple(out.shape) == (2, 3, 8, 64) and out.dtype == torch.int8
    assert not args.k_shift and not args.v_shift
    packed = torch.zeros((9, 16, 2, 32), dtype=torch.int8)
    shifts = tuple(torch.full((9,), 4, dtype=torch.int32).as_subclass(
        _DeviceOnly) for _ in range(2))
    args, _, kp = K3.k3_args(q8, packed, packed, plan, vl, pages, 16, rq,
                             None, kv_shifts=shifts)
    assert (args.k_shift, args.v_shift) == tuple(x.data_ptr()
                                                 for x in shifts)
    assert kp.smem == K3.k3_smem_bytes(64, kp.rank_keys, 1, True, True,
                                       kp.resident)
    cache = torch.zeros((2, 70, 2, 64), dtype=torch.int8)
    args, _, kp = K3.k3_args(q8, cache, cache, plan, vl, None, 0, rq, None)
    assert not args.pages and (args.L, args.page_size) == (70, 0)
    assert kp == K3.k3_launch_plan(2, 3, 8, 2, 64, 70, False)


# --------------------------------------------------- the kernel's order --

def _wrap(x):
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def _expand4(packed, shift):
    """Packed int4 rows (..., D / 2) with a shift per row -> int8 (..., D),
    nibble arithmetic as the kernel's kv4_shift: lane 2i the low nibble,
    2i + 1 the high, sign-extended, shifted, wrapped to a byte."""
    u = packed.astype(np.uint8).astype(np.int64)
    out = np.empty(packed.shape[:-1] + (2 * packed.shape[-1],), np.int64)
    out[..., 0::2], out[..., 1::2] = u & 15, u >> 4
    out = np.where(out >= 8, out - 16, out)
    out = out << np.asarray(shift, np.int64)[..., None]
    return ((out + 128) % 256) - 128


def emulate_k3(q8, k8, v8, plan, vl, pages, ps, requant, b_vec=None,
               kv_shifts=None, resident=None, sms=132, seed=0,
               stats=None):
    """numpy, in the kernel's order.  Per block (rank, row block, lane x KV
    head): the rank's keys of the lane (whole chunks of 32, evenly over the
    cluster), their pool rows read through the table once a key, their
    K / V rows gathered (packed: expanded with the key's page shift) into
    buffers whose rows past the rank's keys hold garbage, then per route
    the chunks (resident: every chunk of the rank, scores kept; streaming:
    tiles of 128 keys, a chunk a warp, Q·Kᵀ again each sweep).  Each rank
    pushes its row max, then its row sum, then its P·V sums (each warp its
    output columns), and the cluster reduces them in a shuffled rank
    order."""
    rng = np.random.default_rng(seed)
    b, sq, h, d = q8.shape
    paged, packed = pages is not None, kv_shifts is not None
    hkv = k8.shape[2]
    length = pages.shape[1] * ps if paged else k8.shape[1]
    kp = K3.k3_launch_plan(b, sq, h, hkv, d, length, paged, packed, 0, 0,
                           sms)
    res = kp.resident if resident is None else resident
    C = kp.cluster
    ie = plan.sm.iexp
    ex = exp16_consts(plan.sm, *F.exp16_divisor(ie.q_ln2,
                                                ie.z_max * ie.q_ln2))
    group = h // hkv
    nd = d // 8
    per_w = -(-nd // WARPS)
    cols = [list(range(8 * w * per_w, min(8 * (w + 1) * per_w, d)))
            for w in range(WARPS)]
    assert sorted(sum(cols, [])) == list(range(d))   # P·V columns once
    if paged:
        kflat = k8.reshape(-1, hkv, k8.shape[3])
        vflat = v8.reshape(-1, hkv, v8.shape[3])
    acc_all = np.zeros((b, sq, h, d), dtype=np.int64)
    written = np.zeros((b, sq, h), dtype=np.int64)
    st_ = stats if stats is not None else {}
    for key in ("keys", "tiles", "ranks_idle"):
        st_.setdefault(key, 0)
    gx, gy, gz = kp.grid
    for z in range(gz):
        lane, hk = divmod(z, hkv)
        for y in range(gy):
            r0 = ROWS * y
            nrows = min(ROWS, group * sq - r0)
            mtn = -(-nrows // 16)
            rows = r0 + np.arange(16 * mtn)
            live_row = np.arange(16 * mtn) < nrows
            hg, qi = np.minimum(rows, group * sq - 1) // sq, rows % sq
            q = np.where(live_row[:, None],
                         q8[lane, qi, hk * group + hg].astype(np.int64), 0)
            hi = np.where(live_row,
                          np.clip(int(vl[lane]) - (sq - 1 - qi), 0, length),
                          0)
            t_hi = min(max(int(vl[lane]), 0), length)
            per = -(-(-(-t_hi // C)) // CHUNK) * CHUNK
            st_["solo"] = st_.get("solo", 0) + (per >= t_hi)  # rank 0 alone
            ranks = []
            for rank in range(gx):
                k_lo = min(rank * per, t_hi)
                nk = min(k_lo + per, t_hi) - k_lo
                assert nk <= kp.rank_keys
                st_["keys"] += nk
                st_["ranks_idle"] += nk == 0
                keys = k_lo + np.arange(nk)
                cap = -(-nk // CHUNK) * CHUNK if res else -(-nk // TILE) * TILE
                kt = rng.integers(-128, 128, (max(cap, 1), d))  # garbage
                vt = rng.integers(-128, 128, (max(cap, 1), d))
                if paged:
                    pg = pages[lane, keys // ps]
                    prow = pg * ps + keys % ps          # once a key
                    kr, vr = kflat[prow, hk], vflat[prow, hk]
                    if packed:
                        kr = _expand4(kr, kv_shifts[0][pg])
                        vr = _expand4(vr, kv_shifts[1][pg])
                else:
                    kr, vr = k8[lane, keys, hk], v8[lane, keys, hk]
                kt[:nk], vt[:nk] = kr, vr
                live = (k_lo + np.arange(cap))[None, :] < hi[:, None]
                if res:
                    chunks = [(c * CHUNK, 0) for c in range(cap // CHUNK)]
                else:
                    chunks = [(ti * TILE + w * CHUNK, ti)
                              for ti in range(cap // TILE) for w in range(WARPS)
                              if ti * TILE + w * CHUNK < nk]
                    st_["tiles"] += cap // TILE
                ranks.append((k_lo, nk, kt, vt, live, chunks))

            def scores(kt, c0):
                return q @ kt[c0:c0 + CHUNK].T
            # sweep 0: each rank's row max, reduced in a shuffled order
            maxes = []
            for k_lo, nk, kt, vt, live, chunks in ranks:
                m = np.full(16 * mtn, NEG, np.int64)
                for c0, _ in chunks:
                    sc = scores(kt, c0)
                    m = np.maximum(m, np.where(live[:, c0:c0 + CHUNK], sc,
                                               NEG).max(-1))
                maxes.append(m)
            m = np.full(16 * mtn, NEG, np.int64)
            for r in rng.permutation(gx):
                m = np.maximum(m, maxes[r])
            # sweep 1: e16 (resident: from the kept scores) and row sums
            sums, e16s = [], []
            for k_lo, nk, kt, vt, live, chunks in ranks:
                s, e = np.zeros(16 * mtn, np.int64), {}
                for c0, _ in chunks:
                    x = np.where(live[:, c0:c0 + CHUNK], _exp16_mma(
                        _wrap(scores(kt, c0) - m[:, None]), ex), 0)
                    e[c0] = x
                    s = s + x.sum(-1)
                sums.append(s)
                e16s.append(e)
            s = np.zeros(16 * mtn, np.int64)
            for r in rng.permutation(gx):
                s = s + sums[r]
            rcp = (1 << 30) // np.maximum(s, 1)
            # sweep 2: p8, P·V by each warp's columns, summed into rank 0
            acc = np.zeros((16 * mtn, d), np.int64)
            for r in rng.permutation(gx):
                k_lo, nk, kt, vt, live, chunks = ranks[r]
                for c0, _ in chunks:
                    p8 = np.clip(_wrap(_wrap(e16s[r][c0] * rcp[:, None])
                                       + (1 << 22)) >> 23, 0, 127)
                    for w in range(WARPS):
                        cw = cols[w]
                        acc[:, cw] += p8 @ vt[c0:c0 + CHUNK][:, cw]
            acc = _wrap(acc)
            for j in np.flatnonzero(live_row):
                acc_all[lane, qi[j], hk * group + hg[j]] = acc[j]
                written[lane, qi[j], hk * group + hg[j]] += 1
    assert (written == 1).all()                # every output row once
    return _ref.apply_attn_requant(
        T(_wrap(acc_all).astype(np.int32)), requant,
        None if b_vec is None else T(b_vec))


def _plan(d):
    jp = j_attn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)
    return jp, plan_from_reference(jp)


def _case(seed, layout, d, group, sq, length=260, ps=16):
    """Four lanes at valid_len 0, 1, the span and a ragged one; 2 KV heads;
    paged: a permuted table of 16-row pages with lane 2 on the null page;
    kv4: packed pools, shifts 0..7 drawn per page for K and V apart."""
    rng = np.random.default_rng(seed)
    b, hkv = 4, 2
    h = group * hkv
    q8 = rng.integers(-128, 128, (b, sq, h, d)).astype(np.int8)
    out = dict(q8=q8, pages=None, ps=0, kv_shifts=None)
    if layout == "contiguous":
        out["k8"], out["v8"] = (rng.integers(-128, 128, (b, length, hkv, d))
                                .astype(np.int8) for _ in range(2))
        span = length
    else:
        maxp = -(-length // ps)
        span, num = maxp * ps, b * maxp + 1
        w = d // 2 if layout == "kv4" else d
        out["k8"], out["v8"] = (rng.integers(-128, 128, (num, ps, hkv, w))
                                .astype(np.int8) for _ in range(2))
        pages = rng.permutation(np.arange(1, num)).reshape(b, maxp)
        pages[2] = 0
        out["pages"], out["ps"] = pages.astype(np.int32), ps
        if layout == "kv4":
            out["kv_shifts"] = tuple(rng.integers(0, 8, num).astype(np.int32)
                                     for _ in range(2))
    out["vl"] = np.array([0, 1, span, span // 2 + 7], np.int32)
    return out


def _plain(c, plan, rq, b_vec=None):
    return K3.int_decode_attention_plain(
        T(c["q8"]), T(c["k8"]), T(c["v8"]), plan, T(c["vl"]),
        None if c["pages"] is None else T(c["pages"]), c["ps"], requant=rq,
        b_vec=None if b_vec is None else T(b_vec),
        kv_shifts=(None if c["kv_shifts"] is None
                   else tuple(T(x) for x in c["kv_shifts"])))


# (route, sms): resident at the card's SMs (clusters of 8 here); streaming
# on 4 SMs, a cluster of 1 whose one rank holds the lane's keys in 3 tiles
_ROUTES = [("resident", 132), ("streaming", 4)]


@pytest.mark.parametrize("route,sms", _ROUTES)
@pytest.mark.parametrize("layout", ["contiguous", "paged", "kv4"])
@pytest.mark.parametrize("sq", [1, 3, 8])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [32, 120])
def test_schedule_emulation_matches_plain(d, group, sq, layout, route, sms):
    """The emulated kernel equals the plain version on lanes at valid_len
    0, 1, the span and a ragged length (a lane on the null page), in
    both layouts (and over packed pools), on both routes; per-tensor and
    raw epilogues (per-channel too at D 32)."""
    c = _case(d * 97 + group * 13 + sq, layout, d, group, sq)
    _, plan = _plan(d)
    rqs = [RequantSpec.per_tensor(plan.dn_out), RequantSpec.raw()]
    b_vec = None
    if d == 32:
        rqs.append(RequantSpec.per_channel(22, 8))
        b_vec = np.random.default_rng(d).integers(
            1000, 20000, c["q8"].shape[2] * d).astype(np.int32)
    for rq in rqs:
        want = _plain(c, plan, rq, b_vec)
        stats = {}
        got = emulate_k3(c["q8"], c["k8"], c["v8"], plan, c["vl"],
                         c["pages"], c["ps"], rq, b_vec, c["kv_shifts"],
                         resident=route == "resident", sms=sms,
                         seed=sq + group, stats=stats)
        assert np.array_equal(got.numpy().astype(np.int64),
                              want.numpy().astype(np.int64)), rq.kind
        assert stats["ranks_idle"] > 0            # valid_len 0 and 1 lanes
        assert stats["solo"] > 0                  # ... which rank 0 takes alone
        assert stats["keys"] > 0
        if route == "streaming":
            assert stats["tiles"] > 0


def test_emulation_splits_keys_evenly_over_the_ranks():
    """At the serve row's geometry (C 8 over 512 positions) lanes at 137
    and 300 keys use 5 ranks of 32 or 64 keys, no rank more than one
    chunk above another's share, and the emulation equals the plain
    version."""
    c = _case(3, "paged", 32, 4, 1, length=512)
    c["vl"] = np.array([1, 137, 300, 512], np.int32)
    _, plan = _plan(32)
    rq = RequantSpec.per_tensor(plan.dn_out)
    kp = K3.k3_launch_plan(4, 1, 8, 2, 32, 512, True)
    assert kp.cluster == 8
    stats = {}
    got = emulate_k3(c["q8"], c["k8"], c["v8"], plan, c["vl"], c["pages"],
                     c["ps"], rq, stats=stats)
    assert np.array_equal(got.numpy(), _plain(c, plan, rq).numpy())
    assert stats["keys"] == 2 * (1 + 137 + 300 + 512)    # 2 KV heads
    for t_hi, busy in ((1, 1), (137, 5), (300, 5), (512, 8)):
        per = -(-(-(-t_hi // 8)) // CHUNK) * CHUNK
        assert sum(min(r * per + per, t_hi) > min(r * per, t_hi)
                   for r in range(8)) == busy


@pytest.mark.parametrize("layout,group,sq,d", [
    ("paged", 1, 3, 32), ("paged", 4, 1, 120), ("contiguous", 8, 3, 32),
    ("contiguous", 4, 8, 120), ("kv4", 8, 1, 32), ("kv4", 1, 8, 120)])
def test_plain_matches_pallas(layout, group, sq, d):
    """The plain version equals the Pallas kernel (interpret mode) on the
    emulation's seeded inputs: G 1 / 4 / 8, Sq 1 / 3 / 8, both layouts
    and packed pools, lanes at valid_len 0, 1, the span and ragged."""
    c = _case(d + group + sq, layout, d, group, sq, length=48, ps=8)
    jp, plan = _plan(d)
    kw = dict(requant=JSpec.per_tensor(jp.dn_out), bkv=16, interpret=True)
    if c["pages"] is not None:
        kw.update(pages=jnp.asarray(c["pages"]), page_size=c["ps"])
    if c["kv_shifts"] is not None:
        kw["kv_shifts"] = tuple(jnp.asarray(x) for x in c["kv_shifts"])
    want = j_k3(jnp.asarray(c["q8"]), jnp.asarray(c["k8"]),
                jnp.asarray(c["v8"]), jp, jnp.asarray(c["vl"]), **kw)
    got = _plain(c, plan, RequantSpec.per_tensor(plan.dn_out))
    assert np.array_equal(got.numpy(), np.asarray(want))
