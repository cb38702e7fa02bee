"""The MSR-4 correction's tensor-core route, modelled in numpy on the CPU.

``csrc/int8_matmul_msr4.cu``'s ``msr4_correct_mma_kernel`` cannot run
here, so its index arithmetic is modelled from ``msr4_plan``:

  * the schedule: whole-group K steps, lane chunks of the (K / g * n_out,
    N) lane rows staged per step (columns past N as the 16-byte or the
    scalar copies leave them), the scatter into the delta tile's word
    layout (word row / 4, swizzled column, byte row % 4), x's tile
    zero-filled past M and past the step's rows, split K into a workspace
    with the last-arriving split running the epilogue, every ragged edge;
    held with ``torch.equal`` against ``msr4_correct_plain`` and the dense
    product (``int8_matmul_plain``);
  * the ``mma.sync.m16n8k32`` fragments each lane loads (A from x's tile,
    B from the delta tile) against the product of the decoded tiles, and
    the shared-memory banks of the scatter's stores and the fragment
    loads;
  * the route rule, and the precondition of the dense tile: both
    packages' ``pack_msr4`` give distinct in-range lane rows in every
    column, and ``interop`` refuses a leaf whose lanes repeat a row.

Tolerance: 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.ops import QuantLinearParams as JQLP
from repro.ops import packed as jpk
from repro.quant import pack as jpack
from repro_torch.interop import qparams_from_reference
from repro_torch.kernels import int8_matmul as k1
from repro_torch.ops import packed as tpk
from repro_torch.ops.spec import QuantLinearParams
from repro_torch.ops.spec import RequantSpec as TSpec
from repro_torch.quant import pack as tpack

T = torch.as_tensor
BN = k1.MSR4_BN


def _swz(c):
    """``swz`` (the delta tile's word column of column c)."""
    return (c & ~3) | ((c + (c >> 5)) & 3)


def _tile_addr(row, col):
    """Byte address of (row, column) in a delta tile: word (row / 4,
    swz(column)) of 128-word rows, byte row % 4."""
    return (row & ~3) * BN + (row & 3) + 4 * _swz(col)


def _weights(rng, k, n, kind, group):
    """int8 (k, n): ``0`` in [-7, 7] (no lanes); ``1`` one outlier on row
    ``grp % g`` of every group in the even columns; ``g`` every weight an
    outlier (|w| >= 8, -128 included); ``rand`` any int8."""
    g = group if k % group == 0 else k
    if kind in ("0", "1"):
        w = rng.integers(-7, 8, (k, n))
    elif kind == "g":
        w = rng.integers(8, 129, (k, n)) * rng.choice([-1, 1], (k, n))
    else:
        w = rng.integers(-128, 128, (k, n))
    w = np.clip(w, -128, 127).astype(np.int8)
    if kind == "1":
        for grp in range(k // g):
            w[grp * g + grp % g, ::2] = -128 if grp % 2 else 127
    return w


def _packed(rng, k, n, kind, group):
    w = _weights(rng, k, n, kind, group)
    qw = tpack.pack_linear(QuantLinearParams(
        T(w), T(rng.integers(1000, 30000, n).astype(np.int32)),
        T(rng.integers(-500, 500, n).astype(np.int32))), "msr4", group)
    return w, qw


def _emulate_msr4_mma(acc, x8, qw, spec, plan, idx_vec):
    """``msr4_correct_mma_kernel`` block by block in numpy, its loop
    order and buffers as in the source; the product of a step is that of
    the decoded tiles (the fragments are modelled in
    :func:`test_mma_fragments_read_the_tiles`).  Splits run in reverse
    order, so the last to arrive is split 0."""
    m, k = x8.shape
    meta = qw.pack_meta
    g, n_out, n = meta.group, meta.n_outliers, qw.n_dim
    idx = qw.out_idx.numpy().reshape(-1, n)     # lane rows (K/g * n_out, N)
    val = qw.out_val.numpy().reshape(-1, n)
    x = x8.numpy()
    bm, gps, sp, lc = plan.mt, plan.kc // g, plan.sp, plan.lc
    ngrp = k // g
    gx, gy, splits = plan.grid
    assert plan.route == "mma" and plan.kc % g == 0
    assert sp % 32 == 0 and plan.kc <= sp < plan.kc + 32
    assert plan.groups_per_split % gps == 0
    assert 1 <= lc <= k1.MSR4_LANE_CHUNK
    assert plan.smem == k1.msr4_mma_smem(bm, sp, lc) <= k1.MSR4_MAX_SMEM
    assert gx == -(-m // bm) and gy == -(-n // BN)
    ws = np.zeros((m, n), np.int64)
    count = np.zeros(gx * gy, np.int64)
    corr = np.zeros((m, n), np.int64)
    rows_b = np.arange(sp)
    dec = _tile_addr(rows_b[:, None], np.arange(BN)[None, :])   # (sp, BN)
    for bz in reversed(range(splits)):
        gbeg = bz * plan.groups_per_split
        gend = min(ngrp, gbeg + plan.groups_per_split)
        assert gbeg < gend or not n_out
        cps = -(-gps * n_out // lc) if n_out else 0
        nchunks = -(-(gend - gbeg) // gps) * cps if n_out else 0
        for bx in range(gx):
            m0 = bx * bm
            for by in range(gy):
                n0 = by * BN
                ncol = min(BN, n - n0)
                part = np.zeros((bm, BN), np.int64)
                tiles = [np.zeros(sp * BN, np.uint8) for _ in range(2)]
                xs = {}                 # x tiles by step
                for u in range(nchunks):
                    s, j = divmod(u, cps)
                    grp0 = gbeg + s * gps
                    gl = min(gps, gend - grp0)
                    rows = min(lc, gl * n_out - j * lc)
                    if j == 0:
                        xt = np.zeros((bm, sp), np.int64)
                        blk = x[m0:m0 + bm, grp0 * g:(grp0 + gl) * g]
                        xt[:blk.shape[0], :blk.shape[1]] = blk
                        xs[s] = xt
                        tiles[(s + 1) & 1][:] = 0
                    tb = tiles[s & 1]
                    if rows > 0:
                        r0 = grp0 * n_out + j * lc
                        sidx = np.full((rows, BN), 0 if idx_vec else -1,
                                       np.int64)
                        sval = np.zeros((rows, BN), np.int8)
                        sidx[:, :ncol] = idx[r0:r0 + rows, n0:n0 + ncol]
                        sval[:, :ncol] = val[r0:r0 + rows, n0:n0 + ncol]
                        for rr in range(rows):
                            q = (j * lc + rr) // n_out
                            r = sidx[rr]
                            ok = (r >= 0) & (r < g)
                            cols = np.arange(BN)[ok]
                            tb[_tile_addr(q * g + r[ok], cols)] = \
                                sval[rr][ok].view(np.uint8)
                    if j == cps - 1:
                        b = tb[dec].view(np.int8).astype(np.int64)
                        part += xs[s] @ b
                mm = min(bm, m - m0)
                sl = (slice(m0, m0 + mm), slice(n0, n0 + ncol))
                if splits == 1:
                    corr[sl] = part[:mm, :ncol]
                    continue
                ws[sl] += part[:mm, :ncol]
                tile = by * gx + bx
                count[tile] += 1
                if count[tile] == splits:           # the last to arrive
                    corr[sl] = ws[sl]
    assert splits == 1 or (count == splits).all()
    out = acc.numpy().astype(np.int64) + corr
    if qw.bias32 is not None:
        out = out + qw.bias32.numpy()[None, :]
    out = ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    return k1._epilogue_plain(T(out), spec, qw.b_mult)


_GROUPS = [(4, 256), (16, 256), (64, 256), (256, 512), (100, 160), (6, 96)]


@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 33, 128])
@pytest.mark.parametrize("group,k", _GROUPS)
@pytest.mark.parametrize("kind", ["0", "1", "g"])
@pytest.mark.parametrize("sms", [1, 132])
def test_mma_route_schedule_matches_plain(m, group, k, kind, sms):
    """The tensor-core route's plan and schedule equal the plain version
    and the dense product: groups 4 / 16 / 64 / 256, g = K (100 does not
    divide 160) and 6 (steps of 10 groups, 60 rows in a 64-row tile, a
    ragged last step); n_out 0, 1 and g; N 130 (scalar lane copies), 136
    (16-byte index copies, scalar deltas, a ragged second tile) or 256."""
    rng = np.random.default_rng(m * 131 + group * 7 + k + len(kind) + sms)
    n = (130, 136, 256)[(m + group + sms) % 3]
    w, qw = _packed(rng, k, n, kind, group)
    meta = qw.pack_meta
    g = meta.group
    want_out = {"0": 0, "1": 1, "g": g}[kind]
    assert meta.n_outliers == want_out
    x8 = T(rng.integers(-128, 128, (m, k)).astype(np.int8))
    x8[0, :3] = -128
    plan = k1.msr4_plan(m, n, k, g, meta.n_outliers, sms)
    assert plan.route == "mma"
    first = 16 if m <= 16 else 64 if m <= 64 else 128
    assert plan.mt == first or plan.mt < first and k1.msr4_mma_smem(
        first, plan.sp, 16) > k1.MSR4_MAX_SMEM
    assert plan.lc == k1.msr4_lane_chunk(plan.mt, plan.sp,
                                         plan.kc // g * meta.n_outliers)
    if not meta.n_outliers:
        assert plan.grid[2] == 1
    acc = k1.int8_matmul_nibbles_plain(x8, qw.w_packed, TSpec.raw())
    for spec in (TSpec.per_channel(c=28, pre=7, out_bits=14),
                 TSpec.raw()):
        want = k1.msr4_correct_plain(acc, x8, qw, spec)
        got = _emulate_msr4_mma(acc, x8, qw, spec, plan,
                                idx_vec=n % 8 == 0)
        assert torch.equal(got, want)
        assert torch.equal(want, k1.int8_matmul_plain(
            x8, T(w), spec, qw.bias32, qw.b_mult))


@pytest.mark.parametrize("bm", [16, 64, 128])
@pytest.mark.parametrize("sp", [64, 160])
def test_mma_fragments_read_the_tiles(bm, sp):
    """The words each lane loads as ``mma.sync.m16n8k32`` fragments (a0
    = sx[g][kb+t], a1 = sx[g+8][kb+t], a2 / a3 at kb+4+t; b0 =
    tile[kb+t][swz(col)], b1 = tile[kb+4+t][swz(col)]; c0..c3 at rows g,
    g + 8 and columns 2t, 2t + 1), warp by warp as the kernel assigns
    them, give x's tile times the delta tile decoded byte by byte."""
    rng = np.random.default_rng(bm + sp)
    wm_n = 1 if bm == 16 else 2
    wn_n = 8 // wm_n
    wtm, wtn = bm // wm_n, BN // wn_n
    sxw = sp // 4 + 4
    xw = rng.integers(0, 2 ** 32, (bm, sxw), dtype=np.uint64)
    tile = rng.integers(0, 256, sp * BN, dtype=np.uint64).astype(np.uint8)
    tw = tile.view(np.uint32).astype(np.uint64)    # words, 128 a word row

    def sbytes(words):                       # (..., ) -> (..., 4) int64
        return np.stack([((words >> (8 * b)) & 0xFF) for b in range(4)],
                        -1).astype(np.uint8).view(np.int8).astype(np.int64)

    lane = np.arange(32)
    fg, ft = lane // 4, lane % 4
    got = np.zeros((bm, BN), np.int64)
    for warp in range(8):
        wm, wn = warp // wn_n, warp % wn_n
        for kb in range(0, sp // 4, 8):
            for jn in range(wtn // 8):
                bcol = _swz(wn * wtn + 8 * jn + fg)
                b = np.zeros((32, 8), np.int64)
                b0 = sbytes(tw[(kb + ft) * BN + bcol])
                b1 = sbytes(tw[(kb + 4 + ft) * BN + bcol])
                for byte in range(4):
                    b[4 * ft + byte, fg] = b0[:, byte]
                    b[16 + 4 * ft + byte, fg] = b1[:, byte]
                for i in range(wtm // 16):
                    r = wm * wtm + 16 * i + fg
                    a = np.zeros((16, 32), np.int64)
                    frag = [sbytes(xw[r, kb + ft]), sbytes(xw[r + 8, kb + ft]),
                            sbytes(xw[r, kb + 4 + ft]),
                            sbytes(xw[r + 8, kb + 4 + ft])]
                    for byte in range(4):
                        a[fg, 4 * ft + byte] = frag[0][:, byte]
                        a[fg + 8, 4 * ft + byte] = frag[1][:, byte]
                        a[fg, 16 + 4 * ft + byte] = frag[2][:, byte]
                        a[fg + 8, 16 + 4 * ft + byte] = frag[3][:, byte]
                    c = a @ b
                    rows = wm * wtm + 16 * i + fg
                    cols = wn * wtn + 8 * jn + 2 * ft
                    for e in range(4):
                        got[rows + 8 * (e // 2), cols + e % 2] += \
                            c[fg + 8 * (e // 2), 2 * ft + e % 2]
    xb = sbytes(xw[:, :sp // 4]).reshape(bm, sp)
    dec = tile[_tile_addr(np.arange(sp)[:, None], np.arange(BN)[None, :])]
    assert np.array_equal(got, xb @ dec.view(np.int8).astype(np.int64))


def test_delta_tile_layout_and_banks():
    """The tile address is a bijection of (row, column) onto the tile's
    bytes; every byte-store instruction of the scatter (lane i: column 4i
    + jj of one lane row, any rows) hits 32 distinct banks; a B fragment
    load hits 8 banks (4-way), an A fragment load 32 (row stride sp / 4
    + 4 words)."""
    sp = 256
    addr = _tile_addr(np.arange(sp)[:, None], np.arange(BN)[None, :])
    assert np.array_equal(np.sort(addr.ravel()), np.arange(sp * BN))
    rng = np.random.default_rng(0)
    lane = np.arange(32)
    for _ in range(50):
        rows = rng.integers(0, sp, 32)
        for jj in range(4):
            bank = (_tile_addr(rows, 4 * lane + jj) // 4) % 32
            assert len(set(bank.tolist())) == 32
    fg, ft = lane // 4, lane % 4
    for n8 in range(0, BN, 8):
        for kb in (0, 8):
            bank = ((kb + ft) * BN + _swz(n8 + fg)) % 32
            assert len(set(bank.tolist())) == 8
    for sp in (64, 96, 160, 256, 512):
        sxw = sp // 4 + 4
        assert len(set(((sxw * fg + ft) % 32).tolist())) == 32


@pytest.mark.parametrize("g,k,m,route", [
    (64, 4096, 4, "mma"), (64, 4096, 128, "mma"), (256, 4096, 128, "mma"),
    (512, 512, 5, "mma"), (512, 512, 128, "mma"), (640, 640, 4, "mma"),
    (768, 768, 4, "gather"), (1024, 1024, 4, "gather"),
    (2048, 2048, 128, "gather"), (14336, 14336, 128, "gather")])
def test_msr4_route_rule(g, k, m, route):
    """The route from the shape alone: the tensor cores wherever a step's
    ring, x tiles and delta tiles fit the shared memory (in a smaller row
    tile if need be), the gather route past that; the gather route's plan
    is :func:`msr4_gather_plan`'s."""
    p = k1.msr4_plan(m, 4096, k, g, g, 132)
    assert p.route == route
    assert p.smem <= k1.MSR4_MAX_SMEM
    if route == "gather":
        assert p == k1.msr4_gather_plan(m, 4096, k, g, g, 132)
    else:
        assert p.smem == k1.msr4_mma_smem(p.mt, p.sp, p.lc)
        assert p.lc == k1.msr4_lane_chunk(p.mt, p.sp, p.kc // g * g)
        first = 16 if m <= 16 else 64 if m <= 64 else 128
        assert p.mt <= first
        bigger = [b for b in (128, 64, 16) if p.mt < b <= first]
        assert all(k1.msr4_mma_smem(b, p.sp, k1.msr4_lane_chunk(
            b, p.sp, p.kc // g * g)) > k1.MSR4_MAX_SMEM for b in bigger)


# --------------------------------------------------- the precondition ----

@pytest.mark.parametrize("group", [4, 16, 64, 100])
@pytest.mark.parametrize("spread", [9, 40, 128])
def test_pack_msr4_lane_rows_are_distinct(group, spread):
    """Both packages' ``pack_msr4`` (2-D and layer-stacked) name distinct
    in-range rows in every column's lanes of a group, and the two give the
    same lanes."""
    rng = np.random.default_rng(group + spread)
    w = rng.integers(-spread, spread, (3, 192, 40)).clip(-128, 127
                                                         ).astype(np.int8)
    _, jmeta, jidx, _ = jpack.pack_msr4(w, group)
    _, tmeta, tidx, _ = tpack.pack_msr4(T(w), group)
    assert jmeta.group == tmeta.group and jmeta.n_outliers == tmeta.n_outliers
    jidx = np.asarray(jidx)
    assert np.array_equal(jidx, tidx.numpy())
    g = tmeta.group
    assert ((jidx >= 0) & (jidx < g)).all()
    srt = np.sort(jidx, axis=-2)
    assert not (srt[..., 1:, :] == srt[..., :-1, :]).any()
    assert tpk.msr4_lanes_distinct(tidx, g)
    assert tpk.msr4_lanes_distinct(tidx[1], g)


def test_lanes_distinct_ignores_out_of_range_lanes():
    idx = T(np.array([[[0, 1], [1, 0], [5, -1], [5, -1]]], np.int16))
    assert tpk.msr4_lanes_distinct(idx, 4)       # 5 and -1 name no row
    idx[0, 2, 0] = 1
    assert not tpk.msr4_lanes_distinct(idx, 4)


def test_out_of_range_lane_adds_nothing():
    """A lane index outside [0, g) adds nothing to the plain correction,
    as the reference's one-hot ``unpack_weights`` (the dense weights the
    product is held to) has it."""
    rng = np.random.default_rng(3)
    w = rng.integers(-128, 128, (64, 24)).astype(np.int8)
    jq = jpack.pack_linear(JQLP(jnp.asarray(w)), "msr4", 16)
    tq = tpack.pack_linear(QuantLinearParams(T(w)), "msr4", 16)
    idx = tq.out_idx.clone()
    idx[1, 0, 3], idx[2, 1, 5], idx[0, 0, 0] = 16, -1, 32767
    tq = tq._replace(out_idx=idx)
    jq = jq._replace(out_idx=jnp.asarray(idx.numpy()))
    dense = np.asarray(jpk.unpack_weights(jq))
    assert np.array_equal(tpk.unpack_weights(tq).numpy(), dense)
    x = rng.integers(-128, 128, (5, 64)).astype(np.int32)
    nib = tpk.nibble_unpack(tq.w_packed).numpy().astype(np.int64)
    assert np.array_equal(x @ nib + tpk.msr4_correction(T(x), tq).numpy(),
                          x @ dense.astype(np.int64))


def test_interop_refuses_repeated_lane_rows():
    """``qparams_from_reference`` carries a reference-packed msr4 leaf
    across, and refuses one whose lanes repeat a row within a group of a
    column, naming the precondition."""
    rng = np.random.default_rng(7)
    w = rng.integers(-128, 128, (64, 24)).astype(np.int8)
    jq = jpack.pack_linear(JQLP(jnp.asarray(w)), "msr4", 16)
    jq = jq._replace(**{f: np.array(getattr(jq, f))
                        for f in ("w_packed", "out_idx", "out_val")})
    got = qparams_from_reference(jq, device="cpu")
    assert torch.equal(got.out_idx, T(jq.out_idx))
    idx = jq.out_idx.copy()
    idx[2, 1, 7] = idx[2, 0, 7]
    with pytest.raises(ValueError, match="repeat a row"):
        qparams_from_reference(jq._replace(out_idx=idx), device="cpu")
    idx = jq.out_idx.copy()
    idx[2, 1, 7] = 16                        # out of range: no row named
    qparams_from_reference(jq._replace(out_idx=idx), device="cpu")
