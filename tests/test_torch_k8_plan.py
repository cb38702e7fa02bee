"""K8's launch plan and the schedule of its tensor-core kernel
(``csrc/int_attention_online.cu``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
Here: a numpy emulation of the kernel's exact order of operations -- 64-row
blocks of 16-row warps, activity per row, key tiles that start at the
logical KV blocks' first keys, the max pass and then the e16 pass,
rescale-then-accumulate, u8 packed into A fragments against the K5 key
permutation of Vᵀ, the tiles and blocks it skips -- held equal to
:func:`int_attention_online_plain` at the reference's logical blocks; and
the plan the wrapper launches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_k5_plan import _exp16_mma, _stage_vt, _vswz

from repro_torch.analysis.contracts import KernelContractError
from repro_torch.core import attention as iattn
from repro_torch.core.dyadic import apply_dyadic, clip_to_bits
from repro_torch.kernels import int_attention as K8
from repro_torch.kernels._abi import exp16_consts
from repro_torch.kernels.int_attention_fused import exp16_divisor

SMEM_LIMIT = 232448          # dynamic shared memory a block may have (H100)
ROWS, KEYS, NEG = K8.K8_ROWS, K8.K8_KEYS, -(1 << 30)

# ---------------------------------------------- the fragments' key order --


def _a_keys():
    """Key (within a 32-key chunk) of each k position of the P·V A
    fragment, from ``tc::pack_p``: n-tile 4s + jj's C values p[e] (key
    8 jj + 2t + (e & 1)) go to register 2 (jj >> 1) + row half, byte
    2 (jj & 1) + (e & 1); register ri holds k positions 16 (ri >> 1) +
    4t .. +3 (mma's A layout)."""
    keys = np.empty(32, dtype=np.int64)
    for t in range(4):
        for jj in range(4):
            for e in range(2):
                ai, byte = jj >> 1, 2 * (jj & 1) + e
                keys[16 * ai + 4 * t + byte] = 8 * jj + 2 * t + e
    return keys


def _b_keys(d):
    """Key of each (k position, column) of the P·V B fragments of both
    chunks of a tile, read as ``tc::pv_chunk`` reads the Vᵀ that
    ``tc::store_v`` staged (test_torch_k5_plan's model): b0 = word
    2 ((4s + t) ^ vswz(col)) holds k positions 4t..4t+3, b1 the next word
    16 + 4t..  (-> (2, 32, D))."""
    v8 = np.tile(np.arange(KEYS, dtype=np.int64)[:, None], (1, d))
    svt, _ = _stage_vt(v8.astype(np.int8))
    keys = np.empty((2, 32, d), dtype=np.int64)
    for s in range(2):
        for col in range(d):
            for t in range(4):
                w = 2 * ((4 * s + t) ^ _vswz(col))
                for hw in range(2):
                    word = int(svt[col, w + hw])
                    for byte in range(4):
                        keys[s, 16 * hw + 4 * t + byte, col] = \
                            (word >> (8 * byte)) & 0xFF
    return keys


@pytest.mark.parametrize("d", [32, 64, 120, 128])
def test_pv_fragments_share_one_key_order(d):
    """The A fragment's key order (u8 from the score layout) is the B
    fragment's (the staged Vᵀ) in every column, so P·V sums each key's
    u8 · v exactly once."""
    a = _a_keys()
    assert sorted(a) == list(range(32))
    b = _b_keys(d)
    for s in range(2):
        assert np.array_equal(b[s], np.tile(32 * s + a[:, None], (1, d)))


# --------------------------------------------------- the kernel's order --

def _wrap(x):
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def _rescale32(x, c):
    """int32 ``(x * c) >> 15`` through the hi/lo split, wrapping."""
    lo = _wrap(_wrap((x & 0x7FFF) * c) + (1 << 14)) >> 15
    return _wrap(_wrap((x >> 15) * c) + lo)


def emulate_k8(q8, k8, v8, plan, causal, window, bq, bkv, out_bits=8,
               stats=None):
    """numpy, in the kernel's order: per 64-row block its logical KV
    blocks [j0, j1), per 16-row warp the steps (a one-tile block: max and
    e16 on one K tile; else T max steps, then T e16 steps), the warp's
    skips (rows all inactive; no live key in the tile), per-row activity,
    rescale then add, u8 through the fragments' key order.  ``stats``
    (a dict) receives counts of what was skipped."""
    b, sq, h, d = q8.shape
    skv, hkv = k8.shape[1], k8.shape[2]
    bq, bkv = min(bq, sq), min(bkv, skv)
    ie = plan.sm.iexp
    ex = exp16_consts(plan.sm, *exp16_divisor(ie.q_ln2, ie.z_max * ie.q_ln2))
    heads = np.arange(h) // (h // hkv)               # GQA: KV head of h
    q = q8.astype(np.int64).transpose(0, 2, 1, 3)    # (B, H, Sq, D)
    kh = k8.astype(np.int64).transpose(0, 2, 1, 3)[:, heads]
    vh = v8.astype(np.int64).transpose(0, 2, 1, 3)[:, heads]
    a_keys, b_keys = _a_keys(), _b_keys(d)
    tiles = -(-bkv // KEYS)
    per = 1 if tiles == 1 else 2 * tiles
    n_kv = skv // bkv
    st_ = stats if stats is not None else {}
    for key in ("leading_blocks_skipped", "warp_blocks_skipped",
                "warp_tiles_skipped"):
        st_.setdefault(key, 0)

    def live_lo(i):
        return np.maximum(i - window + 1, 0) if window > 0 else 0 * i

    def live_hi(i):
        return np.minimum(i + 1, skv) if causal else skv + 0 * i

    def block_last(i):
        return (i // bq) * bq + bq - 1

    acc_all = np.zeros((b, h, sq, d), dtype=np.int64)
    s_all = np.zeros((b, h, sq), dtype=np.int64)
    cols = np.arange(KEYS)
    for q0 in range(0, sq, ROWS):
        j0 = min(int(live_lo(q0)) // bkv, n_kv)
        j1 = (min(n_kv, block_last(min(q0 + ROWS, sq) - 1) // bkv + 1)
              if causal else n_kv)
        nsteps = (j1 - j0) * per if j1 > j0 else 0
        st_["leading_blocks_skipped"] += min(j0, j1)
        for w in range(ROWS // 16):
            wr0 = q0 + 16 * w
            if wr0 >= sq:
                break
            wlast = min(wr0 + 15, sq - 1)
            w_lo, w_hi = int(live_lo(wr0)), int(live_hi(wlast))
            w_qlast = block_last(wlast)
            rows = wr0 + np.arange(16)
            valid = rows < sq
            lo, hi, qlast = live_lo(rows), live_hi(rows), block_last(rows)
            qr = q[:, :, np.minimum(rows, sq - 1)] * valid[:, None]
            m = np.full((b, h, 16), NEG, dtype=np.int64)
            s = np.zeros((b, h, 16), dtype=np.int64)
            acc = np.zeros((b, h, 16, d), dtype=np.int64)
            act = np.zeros(16, dtype=bool)
            mc = mn = corr = bsum = None
            for st in range(nsteps):
                j = j0 + st // per
                r = st % per
                pss = 2 if tiles == 1 else r // tiles
                k0 = j * bkv + (r % tiles) * KEYS
                k1 = min(k0 + KEYS, (j + 1) * bkv)
                t0, nk = j * bkv, k1 - k0
                if causal and t0 > w_qlast:
                    st_["warp_blocks_skipped"] += 1
                    continue
                kt = np.zeros((b, h, KEYS, d), dtype=np.int64)
                vt = np.zeros((b, h, KEYS, d), dtype=np.int64)
                kt[:, :, :nk], vt[:, :, :nk] = kh[:, :, k0:k1], vh[:, :, k0:k1]
                tile_live = k0 < w_hi and k1 > w_lo
                if not tile_live:
                    st_["warp_tiles_skipped"] += 1
                if pss != 1 and k0 == t0:        # the block's first step
                    act = valid & ((not causal) | (t0 <= qlast))
                    mc = np.full((b, h, 16), NEG, dtype=np.int64)
                    bsum = np.zeros((b, h, 16), dtype=np.int64)
                keys = k0 + cols
                live = (act[:, None] & (cols < nk)[None, :]
                        & (keys[None, :] >= lo[:, None])
                        & (keys[None, :] < hi[:, None]))
                scores = None
                if tile_live:
                    scores = qr @ kt.transpose(0, 1, 3, 2)   # (B, H, 16, 64)
                if pss != 1 and tile_live:
                    mc = np.maximum(mc, np.where(live, scores, NEG).max(-1))
                if pss != 1 and k1 == t0 + bkv:  # the block max is complete
                    mn = np.maximum(m, mc)
                    corr = _exp16_mma(_wrap(m - mn), ex)
                    acc = np.where(act[:, None],
                                   _rescale32(acc, corr[..., None]), acc)
                if pss != 0 and tile_live:       # e16, u8, P·V
                    e16 = np.where(live, _exp16_mma(
                        _wrap(scores - mn[..., None]), ex), 0)
                    bsum = _wrap(bsum + e16.sum(-1))
                    u8 = ((e16 >> 8) & 0xFF).astype(np.uint8).view(
                        np.int8).astype(np.int64)
                    for c in range(KEYS // 32):
                        if 32 * c >= nk:
                            break
                        a_frag = u8[..., 32 * c + a_keys]     # (.., 16, 32)
                        b_frag = np.take_along_axis(
                            vt, np.broadcast_to(b_keys[c], (b, h, 32, d)),
                            axis=2)                            # (.., 32, D)
                        acc = _wrap(acc + a_frag @ b_frag)
                if pss != 0 and k1 == t0 + bkv:  # the block is complete
                    s = np.where(act, _wrap(_rescale32(s, corr) + bsum), s)
                    m = np.where(act, mn, m)
            acc_all[:, :, rows[valid]] = acc[:, :, valid]
            s_all[:, :, rows[valid]] = s[:, :, valid]
    s8 = np.maximum(s_all >> 8, 1)[..., None]
    whole = acc_all // s8
    rem = acc_all - whole * s8
    out7 = _wrap(whole * 128 + (rem << 7) // s8)
    out = clip_to_bits(apply_dyadic(torch.as_tensor(out7.astype(np.int32)),
                                    plan.dn_out), out_bits)
    return out.to(torch.int8).numpy().transpose(0, 2, 1, 3)


def _plan(d):
    return iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127)


def _check(b, sq, skv, h, hkv, d, causal, window, bq, bkv, seed,
           operands="random", stats=None):
    rng = np.random.default_rng(seed)
    if operands == "random":
        q8 = rng.integers(-128, 128, (b, sq, h, d)).astype(np.int8)
        k8 = rng.integers(-128, 128, (b, skv, hkv, d)).astype(np.int8)
        v8 = rng.integers(-128, 128, (b, skv, hkv, d)).astype(np.int8)
    else:
        fill = -128 if operands == "min" else 127
        q8, k8, v8 = (np.full(s, fill, dtype=np.int8) for s in (
            (b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    plan = _plan(d)
    got = emulate_k8(q8, k8, v8, plan, causal, window, bq, bkv, stats=stats)
    want = K8.int_attention_online_plain(
        torch.as_tensor(q8), torch.as_tensor(k8), torch.as_tensor(v8), plan,
        causal, window, bq, bkv).numpy()
    assert np.array_equal(got, want)
    return got


# lengths for each logical block: a few blocks, the lengths unequal
_SQ = {1: 80, 4: 80, 16: 80, 68: 136, 128: 128}
_SKV = {1: 24, 8: 80, 68: 136, 128: 128, 256: 256}
_MASKS = {"none": (False, 0), "causal": (True, 0),
          "causal+window": (True, 20), "window": (False, 20)}


@pytest.mark.parametrize("mask", list(_MASKS))
@pytest.mark.parametrize("bkv", list(_SKV))
@pytest.mark.parametrize("bq", list(_SQ))
def test_schedule_matches_plain_at_logical_blocks(bq, bkv, mask):
    """Every logical block pair (bq < 16 puts several logical query blocks
    in one warp; bkv < 64 leaves a partial tile, 68 a 4-key second tile,
    256 four tiles) under each mask, GQA 2:1, Sq != Skv (both ways
    across the grid); the window alone leaves rows past Skv + 19 with no
    live key."""
    causal, window = _MASKS[mask]
    _check(1, _SQ[bq], _SKV[bkv], 2, 1, 32, causal, window, bq, bkv,
           seed=bq * 1000 + bkv)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("operands", ["min", "max"])
def test_schedule_at_extreme_operands(d, operands):
    """All -128 / +127: the largest scores and products, wrapping int32
    where the reference does."""
    _check(1, 128, 128, 2, 2, d, True, 0, 16, 128, seed=0,
           operands=operands)


def test_schedule_at_the_encoder_blocks():
    """The encoder's launch cut to one head: S = 512, 128 x 128 logical
    blocks (two tiles a block: 4 steps), unmasked and causal."""
    for causal in (False, True):
        _check(1, 512, 512, 2, 1, 64, causal, 0, 128, 128, seed=7)


def test_schedule_skips_exactly():
    """The skips the kernel makes change no integer: leading blocks below
    every row's window, warps whose rows are past their causal blocks,
    and tiles with no live key for a warp (while its rows still
    rescale)."""
    stats = {}
    _check(1, 256, 256, 2, 2, 32, True, 40, 64, 32, seed=3, stats=stats)
    assert stats["leading_blocks_skipped"] > 0
    assert stats["warp_tiles_skipped"] > 0
    stats = {}
    _check(1, 128, 128, 2, 2, 32, True, 0, 128, 64, seed=4, stats=stats)
    assert stats["warp_tiles_skipped"] > 0       # rows 0-63 in block 1
    stats = {}
    _check(1, 128, 128, 2, 2, 32, True, 0, 16, 16, seed=5, stats=stats)
    assert stats["warp_blocks_skipped"] > 0


def test_rows_with_no_live_key_write_requant_zero():
    """Sq > Skv with a window and no causal mask: the rows past
    Skv + window - 1 see no key and keep m = NEG, s = acc = 0."""
    got = _check(1, 136, 24, 2, 1, 32, False, 20, 68, 8, seed=11)
    plan = _plan(32)
    zero = int(clip_to_bits(apply_dyadic(torch.zeros(1, dtype=torch.int32),
                                         plan.dn_out), 8)[0])
    assert (got[:, 24 + 19:] == zero).all()
    assert not (got[:, :24 + 19] == zero).all()


# ------------------------------------------------------------ the plan ----

@pytest.mark.parametrize("d", [32, 64, 120, 128])
@pytest.mark.parametrize("bkv", [1, 8, 16, 63, 64, 65, 68, 128, 256, 1000,
                                 4096, 65536])
def test_k8_launch_plan(d, bkv):
    """Tiles of 64 keys per logical block; the shared memory does not
    depend on the blocks and fits the card; the batch and the heads
    change only the grid."""
    for b, sq, h in ((1, 1, 1), (3, 100, 8), (32, 512, 12)):
        p = K8.k8_launch_plan(b, sq, h, d, bkv)
        assert p.grid == (-(-sq // 64), h, b)
        assert p.tiles == -(-bkv // 64)
        assert p.smem == K8.k8_smem_bytes(d) <= SMEM_LIMIT


def test_k8_plan_at_the_path_shapes():
    """The encoder's 128 x 128 launch: 3 072 blocks of 64 rows, two tiles
    a logical block, 16 KB; D = 128 takes 28 KB."""
    enc = K8.k8_launch_plan(32, 512, 12, 64, 128)
    assert enc == K8.K8Plan((8, 12, 32), 2, 16384)
    assert K8.k8_smem_bytes(128) == 28672 and K8.k8_smem_bytes(32) == 6144
    assert K8.k8_smem_bytes(120) == 28672      # padded as D = 128


@pytest.mark.parametrize("d", [16, 48, 96, 136, 256])
def test_k8_plan_refuses_other_head_dims(d):
    with pytest.raises(KernelContractError, match="head dim"):
        K8.k8_launch_plan(1, 64, 2, d, 64)
