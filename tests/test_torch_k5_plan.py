"""K5's launch plan and the index arithmetic of its tensor-core kernel
(``csrc/int_attention_mma.cuh``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
Here: the plan the wrapper launches (grid, key tiles, shared memory, the
e16 store, wide or word copies), the exp16 division as a multiply-high,
and a numpy model of the kernel's fragments — the Q·Kᵀ k order, the
V-staging key permutation, and at a head dim that is not a multiple of 32
(D = 120) the zero pad of the Q fragments and the K tile copies in 8-byte
granules — held against plain products.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import attention as iattn
from repro_torch.core.softmax import _exp16
from repro_torch.kernels import int_attention_fused as F

SMEM_LIMIT = 232448          # dynamic shared memory a block may have (H100)

# ------------------------------------------------------------ the plan ----


def _widest_span(sq, skv, causal, window):
    """Key tiles of the widest 64-row block, from the explicit mask."""
    qi = np.arange(sq)[:, None]
    ki = np.arange(skv)[None, :]
    live = np.ones((sq, skv), dtype=bool)
    if causal or window > 0:
        live &= ki <= qi
        if window > 0:
            live &= ki > qi - window
    most = 0
    for q0 in range(0, sq, 64):
        cols = np.flatnonzero(live[q0:q0 + 64].any(axis=0))
        if cols.size:
            most = max(most, -(-(cols[-1] + 1 - cols[0]) // 64))
    return most


_SHAPES = [(1, 1), (37, 37), (100, 100), (512, 512), (4096, 4096),
           (64, 512), (37, 100), (100, 37), (1, 4096), (512, 1)]


@pytest.mark.parametrize("d", [32, 64, 120, 128])
@pytest.mark.parametrize("sq,skv", _SHAPES)
@pytest.mark.parametrize("mask", ["none", "causal", "window"])
def test_k5_launch_plan(d, sq, skv, mask):
    """Every shape gets a plan within the card's shared memory; its key
    tiles cover the widest block's live keys exactly; the e16 store is
    taken exactly where it fits; GQA groups 1/4/8 change only the grid."""
    causal, window = mask != "none", (48 if mask == "window" else 0)
    for h, hkv in ((8, 8), (8, 2), (8, 1)):
        p = F.k5_launch_plan(3, sq, skv, h, hkv, d, causal, window, 1 << 20)
        assert p.grid == (-(-sq // 64), h, 3)
        assert p.tiles == _widest_span(sq, skv, causal, window)
        assert p.smem <= SMEM_LIMIT
        fits = F.k5_smem_bytes(d, p.tiles, True) <= SMEM_LIMIT
        assert p.store_e16 == fits
        assert p.smem == F.k5_smem_bytes(d, p.tiles, p.store_e16)
        assert p.vec_k


def test_k5_plan_shared_memory_at_the_path_shapes():
    """The encoder's launch keeps e16 (8 tiles, 80 KB, two blocks an SM);
    a causal 4096-key launch cannot and recomputes (28 KB)."""
    enc = F.k5_launch_plan(32, 512, 512, 12, 12, 64, False, 0, 0)
    assert (enc.grid, enc.tiles, enc.smem, enc.store_e16) == (
        (8, 12, 32), 8, 81920, True)
    long = F.k5_launch_plan(1, 4096, 4096, 2, 2, 128, True, 0, 0)
    assert (long.tiles, long.smem, long.store_e16) == (64, 28672, False)
    # e16 that did not fit 16 bits would never be stored
    assert not F.k5_launch_plan(32, 512, 512, 12, 12, 64, False, 0, 0,
                                e16_fits=False).store_e16


@pytest.mark.parametrize("off,vec", [(0, True), (4, False), (8, False),
                                     (12, False), (16, True)])
def test_k5_plan_word_copies_off_alignment(off, vec):
    """K one word (or more) off 16-byte alignment is copied 4 bytes at a
    time; the rest of the plan does not change."""
    base = F.k5_launch_plan(2, 100, 100, 4, 2, 64, True, 0, 4096)
    p = F.k5_launch_plan(2, 100, 100, 4, 2, 64, True, 0, 4096 + off)
    assert p.vec_k == vec
    assert p._replace(vec_k=True) == base


@pytest.mark.parametrize("off,vec", [(0, True), (4, False), (8, True),
                                     (12, False), (16, True)])
def test_k5_plan_copy_granule_at_head_dim_120(off, vec):
    """At D = 120 a head's K row starts 8-byte aligned, so the wide
    copies are 8 bytes and take K at any 8-byte aligned address; 4 bytes
    off, word copies."""
    p = F.k5_launch_plan(2, 100, 100, 32, 8, 120, True, 0, 4096 + off)
    assert p.vec_k == vec
    assert F.k_copy_bytes(120, 4096 + off) == (8 if vec else 4)
    assert F.k_copy_bytes(128, 4096 + off) == (16 if off % 16 == 0 else 4)


@pytest.mark.parametrize("d", [16, 48, 96, 136, 256])
def test_k5_plan_refuses_other_head_dims(d):
    with pytest.raises(ValueError, match="head dim .*ROADMAP §2 item 4"):
        F.k5_launch_plan(1, 64, 64, 2, 2, d, False, 0, 0)


def test_k5_plan_refuses_ragged_gqa():
    with pytest.raises(ValueError, match="Hkv"):
        F.k5_launch_plan(1, 64, 64, 6, 4, 64, False, 0, 0)


# ---------------------------------------------------- exp16's division ----

@pytest.mark.parametrize("q_ln2", [2, 3, 7, 1000, 11356, 12345, 65535,
                                   1 << 20])
def test_exp16_divisor_is_exact_on_its_domain(q_ln2):
    n_max = 30 * q_ln2
    magic, shift = F.exp16_divisor(q_ln2, n_max)
    assert 0 < magic < 1 << 32 and 0 <= shift <= 31
    n = np.arange(n_max + 1, dtype=np.uint64)
    got = (n * np.uint64(magic)) >> np.uint64(32) >> np.uint64(shift)
    assert np.array_equal(got, n // np.uint64(q_ln2))


def test_exp16_divisor_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        F.exp16_divisor(1, 100)
    with pytest.raises(ValueError):
        F.exp16_divisor(11356, 1 << 31)


def _exp16_mma(q_sub, ex):
    """numpy model of the kernel's exp16_mma on the constants the wrapper
    packs (``_abi.exp16_consts``): every shift as ``(x * mul + half) >>
    rs`` wrapping as uint32, the division by q_ln2 a multiply-high."""
    def wrap(x):
        return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)

    def rshift(x, sh):
        return wrap(x * sh.mul + sh.half) >> sh.rs

    q = np.maximum(q_sub.astype(np.int64), -ex.q_band)
    q = np.minimum(rshift(wrap(rshift(q, ex.in_pre) * ex.in_b), ex.in_post),
                   0)
    qn = np.maximum(q, ex.neg_zq)
    z = ((-qn).astype(np.uint64) * np.uint64(ex.magic)) \
        >> np.uint64(32 + ex.z_shift)
    z = z.astype(np.int64)
    t = wrap(wrap(qn + wrap(z * ex.q_ln2)) + ex.q_b)
    e = wrap(wrap(t * t) + ex.q_c) >> z
    return rshift(wrap(rshift(e, ex.e_pre) * ex.e_b), ex.e_post)


@pytest.mark.parametrize("s", range(-31, 32))
def test_shift_struct_is_rshift_round(s):
    """The branch-free shift equals core.dyadic.rshift_round (int32
    wrap-around included) on edge and random values."""
    from repro_torch.core.dyadic import rshift_round
    from repro_torch.kernels._abi import shift_struct
    sh = shift_struct(s)
    x = np.concatenate([np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 1,
                                  2 ** 31 - 1], dtype=np.int64),
                        np.random.default_rng(s + 31).integers(
                            -2 ** 31, 2 ** 31, 500)])
    got = ((x * sh.mul + sh.half + (1 << 31)) % (1 << 32) - (1 << 31)) \
        >> sh.rs
    want = rshift_round(torch.as_tensor(x, dtype=torch.int32), s)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("d", [32, 64, 120, 128])
def test_exp16_with_multiply_high_equals_exp16(d):
    """Over exp16's whole input range (and past its clip), the kernel's
    branch-free exp16 with the multiply-high division equals
    core.softmax._exp16, and every e16 fits the 16 bits the e16 store
    keeps."""
    sm = iattn.make_iattention(d, 8 / 127, 8 / 127, 4 / 127, 4 / 127).sm
    ie = sm.iexp
    from repro_torch.kernels._abi import exp16_consts
    ex = exp16_consts(sm, *F.exp16_divisor(ie.q_ln2, ie.z_max * ie.q_ln2))
    q = np.arange(-sm.q_band - 50, 1, dtype=np.int64)
    want = _exp16(torch.as_tensor(q, dtype=torch.int32), sm).numpy()
    assert np.array_equal(_exp16_mma(q, ex), want)
    assert F.e16_fits_16_bits(sm)
    assert int(want.max()) == 32755 and int(want.min()) >= 0


# ------------------------------------------- the kernel's fragment model --
# mma.sync.m16n8k32 .s8 (PTX ISA), lane = 4 g + t: a0 = A[g][4t..4t+3],
# a1 = A[g+8][4t..], a2 = A[g][16+4t..], a3 = A[g+8][16+4t..];
# b0 = B[4t..4t+3][g], b1 = B[16+4t..][g]; c = C[g][2t, 2t+1],
# C[g+8][2t, 2t+1].

def _bytes(w):
    return np.array([(int(w) >> (8 * i)) & 0xFF for i in range(4)],
                    dtype=np.uint8).view(np.int8).astype(np.int64)


def _word(b):
    return int(sum((int(x) & 0xFF) << (8 * i) for i, x in enumerate(b)))


def _mma(c, a, b0, b1):
    """c (32, 4) += A x B from the per-lane registers a (32, 4), b0, b1."""
    A = np.zeros((16, 32), dtype=np.int64)
    B = np.zeros((32, 8), dtype=np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, 4 * t:4 * t + 4] = _bytes(a[lane][0])
        A[g + 8, 4 * t:4 * t + 4] = _bytes(a[lane][1])
        A[g, 16 + 4 * t:20 + 4 * t] = _bytes(a[lane][2])
        A[g + 8, 16 + 4 * t:20 + 4 * t] = _bytes(a[lane][3])
        B[4 * t:4 * t + 4, g] = _bytes(b0[lane])
        B[16 + 4 * t:20 + 4 * t, g] = _bytes(b1[lane])
    C = A @ B
    for lane in range(32):
        g, t = divmod(lane, 4)
        c[lane] += [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                    C[g + 8, 2 * t + 1]]


def _words(x8):
    """int8 rows -> little-endian int32 words (the shared-memory view)."""
    return np.ascontiguousarray(x8).view(np.int32)


def _vswz(d):
    return (((d >> 1) & 1) << 2) ^ ((d >> 2) & 7)


def _stage_vt(v8):
    """The kernel's load_v + store_v on one 64-key tile: (64, D) int8 ->
    Vᵀ words (v_cols(D), 16), and where each (key, column) byte went.
    The units run over the padded columns (an even share for each of the
    128 threads); columns past D load as 0."""
    keys, d = v8.shape
    dw_n = F.v_cols(d) // 4
    assert (16 * dw_n) % 128 == 0                     # whole units a thread
    svt = np.zeros((F.v_cols(d), 16), dtype=np.int64)
    where = {}
    for i in range(16 * dw_n):                        # every V unit
        dw, gi = i % dw_n, i // dw_n
        k0 = 32 * (gi >> 3) + 16 * ((gi >> 2) & 1) + 2 * (gi & 3)
        ks = [k0 + (jj & 1) + 8 * (jj >> 1) for jj in range(4)]
        pair, hw = 4 * (gi >> 3) + (gi & 3), (gi >> 2) & 1
        for jj in range(4):                           # transpose4
            col = 4 * dw + jj
            word = 2 * (pair ^ _vswz(col)) + hw
            if col >= d:                              # the pad loads 0
                svt[col, word] = 0
                continue
            svt[col, word] = _word([v8[k, col] for k in ks])
            for byte, k in enumerate(ks):
                where[(k, col)] = (col, word, byte)
    return svt, where


@pytest.mark.parametrize("d", [32, 64, 120, 128])
def test_v_staging_permutation_is_a_bijection(d):
    """Each (key, column) byte of a 64-key V tile lands in exactly one
    byte of its column's Vᵀ row, every byte of the row is used, and the
    pad rows past D hold zeros."""
    v8 = np.arange(64 * d, dtype=np.int64).reshape(64, d).astype(np.int8)
    svt, where = _stage_vt(v8)
    assert not svt[d:].any()
    assert len(where) == 64 * d
    slots = set(where.values())
    assert slots == {(c, w, b) for c in range(d) for w in range(16)
                     for b in range(4)}
    for (k, c), (col, w, b) in where.items():
        assert col == c
        chunk, kk = divmod(k, 32)
        q, u, e = kk >> 3, (kk >> 1) & 3, kk & 1
        # the comment's rule, before the pair swizzle
        pair = 4 * chunk + u
        assert (w - (q >> 1)) // 2 == pair ^ _vswz(c)
        assert (w & 1) == (q >> 1) and b == 2 * (q & 1) + e


def _q_fragments(qw, base, d):
    """The kernel's Q A-fragments of one warp's 16 rows, read from the
    global Q (``qw``, int32 words; row r starts at word ``base[r]``):
    lane (g, t), k-step s -> words 8s + 2t, 8s + 2t + 1 of rows g and g + 8
    (a0..a3), zero past D (the pad of a D that is not a multiple of 32)."""
    ks = -(-d // 32)
    qa = np.zeros((32, ks, 4), dtype=np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for s in range(ks):
            w = 8 * s + 2 * t
            if d % 32 == 0 or w < d // 4:
                qa[lane, s] = [qw[base[g] + w], qw[base[g + 8] + w],
                               qw[base[g] + w + 1], qw[base[g + 8] + w + 1]]
    return qa


def _k_tile(kbytes, rows, d, k_addr, rng):
    """The kernel's K tile in shared memory, (64, sk_words(D)) words: key
    j's D bytes copied from byte ``rows[j]`` of the global K (at address
    ``k_addr``) in granules of ``k_copy_bytes`` -- each copy aligned to
    its granule, as cp.async needs, and the row tiled exactly; the words
    past D are never written (random here)."""
    gran = F.k_copy_bytes(d, k_addr)
    assert d % gran == 0, "the copies do not tile a row"
    tile = rng.integers(-2 ** 31, 2 ** 31, (64, F.sk_words(d)))
    for j, a in enumerate(rows):
        for c in range(d // gran):
            src = a + gran * c
            assert (k_addr + src) % gran == 0, \
                f"a {gran}-byte copy from an address {(k_addr + src) % 16} " \
                "bytes off 16"
            w0 = gran // 4 * c
            tile[j, w0:w0 + gran // 4] = _words(kbytes[src:src + gran])
    return tile


@pytest.mark.parametrize("d", [32, 64, 120, 128])
def test_fragment_model_gives_exact_products(d):
    """One warp's 16 rows of query head 1 against one 64-key tile of KV
    head 1 (of 2) through the kernel's fragments: Q·Kᵀ with the permuted
    k order equals q8 @ k8ᵀ -- at D = 120 over four k-steps, the Q pad
    zero and the K tile copied in 8-byte granules with whatever its pad
    holds -- and P·V with p8 packed from the score layout against the
    staged Vᵀ equals p8 @ v8, with the extreme values -128 / 127
    included."""
    rng = np.random.default_rng(d)
    qg = rng.integers(-128, 128, (16, 2, d)).astype(np.int8)
    kg = rng.integers(-128, 128, (64, 2, d)).astype(np.int8)
    v8 = rng.integers(-128, 128, (64, d)).astype(np.int8)
    qg[0, 1], kg[0, 1], v8[:, 0] = -128, -128, 127
    q8, k8 = qg[:, 1], kg[:, 1]
    p8 = rng.integers(0, 128, (16, 64)).astype(np.int64)
    p8[3] = 127
    qa = _q_fragments(_words(qg.reshape(-1)),
                      [(2 * r + 1) * d // 4 for r in range(16)], d)
    tile = _k_tile(kg.reshape(-1), [(2 * j + 1) * d for j in range(64)], d,
                   4096, rng)

    scores = np.zeros((16, 64), dtype=np.int64)
    for j in range(8):
        c = np.zeros((32, 4), dtype=np.int64)
        for s in range(-(-d // 32)):
            b0, b1 = [], []
            for lane in range(32):
                g, t = divmod(lane, 4)
                b0.append(tile[8 * j + g, 8 * s + 2 * t])
                b1.append(tile[8 * j + g, 8 * s + 2 * t + 1])
            _mma(c, qa[:, s], b0, b1)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for e in range(4):
                scores[g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)] = c[lane, e]
    assert np.array_equal(scores, q8.astype(np.int64) @ k8.T.astype(np.int64))

    svt, _ = _stage_vt(v8)
    acc = np.zeros((d // 8, 32, 4), dtype=np.int64)
    for s in range(2):
        pa = np.zeros((32, 4), dtype=np.int64)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for jj in range(4):
                j = 4 * s + jj
                p = [p8[g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)]
                     for e in range(4)]
                sh, ai = 16 * (jj & 1), jj >> 1
                pa[lane, 2 * ai] |= (p[0] | (p[1] << 8)) << sh
                pa[lane, 2 * ai + 1] |= (p[2] | (p[3] << 8)) << sh
        for nd in range(d // 8):
            b0, b1 = [], []
            for lane in range(32):
                g, t = divmod(lane, 4)
                col = 8 * nd + g
                w = 2 * ((4 * s + t) ^ _vswz(col))
                b0.append(svt[col, w])
                b1.append(svt[col, w + 1])
            _mma(acc[nd], pa, b0, b1)
    out = np.zeros((16, d), dtype=np.int64)
    for nd in range(d // 8):
        for lane in range(32):
            g, t = divmod(lane, 4)
            out[g, 8 * nd + 2 * t:8 * nd + 2 * t + 2] = acc[nd, lane, :2]
            out[g + 8, 8 * nd + 2 * t:8 * nd + 2 * t + 2] = acc[nd, lane, 2:]
    assert np.array_equal(out, p8 @ v8.astype(np.int64))


def _bank_pairs(addrs):
    """The 8-byte accesses of one half-warp as 2-bank pairs (bank // 2)."""
    return [(a % 32) // 2 for a in addrs]


@pytest.mark.parametrize("d", [32, 64, 120, 128])
def test_fragment_loads_are_free_of_bank_conflicts(d):
    """Each half-warp's 8-byte B-fragment loads (K rows at stride SK,
    swizzled Vᵀ rows) hit 16 distinct bank pairs."""
    sk = F.sk_words(d)
    assert sk % 16 == 8 and sk >= F.v_cols(d) // 4
    for half in range(2):
        lanes = range(16 * half, 16 * half + 16)
        for j in range(8):
            for s in range(-(-d // 32)):
                k_addr = [(8 * j + lane // 4) * sk + 8 * s + 2 * (lane % 4)
                          for lane in lanes]
                assert len(set(_bank_pairs(k_addr))) == 16
        for nd in range(d // 8):
            for s in range(2):
                v_addr = []
                for lane in lanes:
                    col = 8 * nd + lane // 4
                    v_addr.append(col * 16
                                  + 2 * ((4 * s + lane % 4) ^ _vswz(col)))
                assert len(set(_bank_pairs(v_addr))) == 16
