// Pieces of integer attention on the int8 tensor cores shared by K5 and
// K4 (int_attention_mma.cuh, exact), K8 (int_attention_online.cu, one
// pass) and K3 (int_decode_attention.cu, exact): the branch-free exp16,
// the K tile copy, the Q·Kᵀ n-tile, and the key-permuted, swizzled Vᵀ
// tile with the P·V chunk that reads it.  The copies take each key's row
// address from a functor, so one tile may gather its keys from contiguous
// K/V (K5, K8) or through a page table (K4), or, in K3, from rows already
// copied into shared memory.
//
// Tiles of KEYS keys are processed by THREADS threads in warps of 16
// query rows; thread (g, t) = (lane / 4, lane % 4) of a warp owns rows g
// and g + 8 (int_mma.cuh has the fragment layouts).
//
//   K tile: row-major (key, D bytes) at a row stride of sk_words(D)
//   words, 8 mod 16, so a half-warp's 8-byte B-fragment loads hit 32
//   distinct banks.  A row-major K tile is mma's .col B operand of Q·Kᵀ;
//   for k-step s thread (g, t) feeds words 8s + 2t, 8s + 2t + 1 of its
//   query rows and of key n0 + g.  A D that is not a multiple of 32
//   (D = 120: three k-steps and 24 bytes) takes ksteps(D) k-steps over
//   rows padded to the next multiple of 32 bytes: the kernels load their
//   Q fragments as zeros past D, so whatever the K tile's pad words hold
//   (they are never written) multiplies zero and the product is exact.
//   The tile copies move K rows in 16-byte granules, 8 where D is not a
//   multiple of 16 (a head's row h * D bytes in is then only 8-byte
//   aligned), or 4 where K itself is not aligned to those.  Vᵀ is staged
//   with v_cols(D) rows, D padded the same way, so a tile's V units divide
//   evenly among the threads; the pad columns load as zeros and P·V never
//   reads them (D / 8 output n-tiles).
//
//   P·V without shuffles: the s32 C layout of Q·Kᵀ gives thread (g, t)
//   keys 8j + 2t, 8j + 2t + 1 of rows g and g + 8 for n-tile j.  For the
//   32-key chunk s (n-tiles 4s..4s+3) pack_p puts, per row, keys
//   {2t, 2t+1, 8+2t, 9+2t} into one word (a0 / a1) and
//   {16+2t, 17+2t, 24+2t, 25+2t} into another (a2 / a3).  The sum over
//   keys does not care about their order, so Vᵀ is staged with the same
//   key permutation: key k of a chunk (k = 8q + 2u + e, q, u in 0..3,
//   e in 0..1) sits in byte 2(q & 1) + e of word 2u + (q >> 1) of its
//   column's chunk, and b0, b1 are words 2t, 2t + 1: one 8-byte load.
//   V is read from device memory one tile ahead into registers
//   (load_v), a unit of keys (k0, k0+1, k0+8, k0+9) x 4 columns a
//   thread, and transposed with transpose4 into exactly those words
//   (store_v).  Vᵀ rows are KEYS / 4 words; pair p of column d is stored
//   at p ^ vswz(d), which keeps the fragment loads conflict-free and
//   spreads the stores.  tests/test_torch_k5_plan.py models this layout
//   in numpy.
//
//   Packed int4 pools (K4's kv_shifts: rows of D / 2 bytes, two head-dim
//   lanes a byte, a shift per page; int_common.cuh's unpack_kv4): cp.async
//   cannot transform bytes, so K goes through registers as V does.
//   load_kp reads a tile's packed K rows one tile ahead, 4 bytes (8 lanes)
//   a load, with the shift of each key's page; store_kp expands them into
//   the int8 K tile (two words a load) that qk_ntile reads.  load_vp reads
//   V's units as load_v does, 2 packed bytes where load_v reads a word,
//   with each key's shift; expand_v turns them into load_v's words before
//   store_v.  Packed rows start on 4-byte boundaries (D / 2 is a multiple
//   of 4 for every D the kernels take), so the loads are aligned for every
//   D and every 4-byte aligned pool.
//
//   exp16 (exp16_mma, in int_common.cuh since K7 shares it) has no
//   branch per pair: the host resolves each dyadic shift, a launch
//   constant, into a multiply, a rounding add and a right shift
//   (kernels/_abi.py::exp16_consts), which the kernel reads from its
//   parameters; the division (-qn) / q_ln2 is an exact multiply-high: the
//   wrapper finds (magic, shift) with __umulhi(n, magic) >> shift == n /
//   q_ln2 and checks it on every n of the domain [0, -neg_zq];
//   chip_smoke.py checks the same on the card (r8_exp16_div_check).
#pragma once

#include "int_common.cuh"
#include "int_mma.cuh"

namespace r8 {
namespace tc {

// k-steps of Q·Kᵀ: D padded to a multiple of 32 bytes
__host__ __device__ constexpr int ksteps(int D) { return (D + 31) / 32; }

// Vᵀ rows: D padded to a multiple of 32
__host__ __device__ constexpr int v_cols(int D) { return 32 * ksteps(D); }

// K row stride in words: the padded row, then 8 mod 16 for conflict-free
// 8-byte loads
__host__ __device__ constexpr int sk_words(int D) {
  return (8 * ksteps(D)) % 16 == 8 ? 8 * ksteps(D) : 8 * ksteps(D) + 8;
}

// Vᵀ pair swizzle of column d (see the note)
__device__ __forceinline__ int vswz(int d) {
  return (((d >> 1) & 1) << 2) ^ ((d >> 2) & 7);
}

// K rows t0 .. t0 + KEYS - 1 into dst by cp.async in wide granules: 16
// bytes, or 8 where D is not a multiple of 16; row(key) is the address of
// key's D bytes (contiguous, or through a page table), aligned to the
// granule, read only for keys before t_hi; later keys are zero-filled
// (`any` is a valid address for their source)
template <int D, int KEYS, int THREADS, class Row>
__device__ __forceinline__ void load_k_wide(int* dst, Row&& row, int t0,
                                            int t_hi, int tid,
                                            const int8_t* any) {
  constexpr int G = D % 16 == 0 ? 16 : 8;    // bytes a copy
  constexpr int CH = D / G;                  // copies a key
  constexpr int SK = sk_words(D);
  static_assert(D % 8 == 0, "K rows copy in 8- or 16-byte granules");
#pragma unroll
  for (int i = tid; i < KEYS * CH; i += THREADS) {
    const int j = i / CH, c = i % CH, key = t0 + j;
    const bool ok = key < t_hi;
    const unsigned dst_c = smem_addr(dst + j * SK + (G / 4) * c);
    if (G == 16)
      cp_async16(dst_c, ok ? row(key) + G * c : any, ok ? G : 0);
    else
      cp_async8(dst_c, ok ? row(key) + G * c : any, ok ? G : 0);
  }
}

// 4-byte packed units (8 head-dim lanes) of a K tile a thread loads
template <int D, int KEYS, int THREADS>
__host__ __device__ constexpr int kp_units() {
  return (KEYS * (D / 8) + THREADS - 1) / THREADS;
}

// packed K rows t0 .. t0 + KEYS - 1 into registers: unit n of this thread
// is 4 bytes at column unit c of key j (i = tid + n * THREADS = j * D / 8 +
// c), with its page's shift; keys at or past t_hi read as 0.  row(key) is
// the address of key's D / 2 packed bytes, row.page(key) its page.
template <int D, int KEYS, int THREADS, class Row>
__device__ __forceinline__ void load_kp(
    unsigned (&kr)[kp_units<D, KEYS, THREADS>()],
    int (&ks)[kp_units<D, KEYS, THREADS>()], Row&& row, const int* shift,
    int t0, int t_hi, int tid) {
  constexpr int CH = D / 8;
  static_assert(D % 8 == 0, "packed K rows load in 4-byte units");
#pragma unroll
  for (int n = 0; n < kp_units<D, KEYS, THREADS>(); ++n) {
    const int i = tid + n * THREADS, j = i / CH, c = i % CH, key = t0 + j;
    const bool ok = i < KEYS * CH && key < t_hi;
    kr[n] = ok ? reinterpret_cast<const unsigned*>(row(key))[c] : 0u;
    ks[n] = ok ? shift[row.page(key)] : 0;
  }
}

// the units of load_kp expanded into the int8 K tile dst (row stride
// sk_words(D) words): unit (j, c) is words 2c, 2c + 1 of row j
template <int D, int KEYS, int THREADS>
__device__ __forceinline__ void store_kp(
    int* dst, const unsigned (&kr)[kp_units<D, KEYS, THREADS>()],
    const int (&ks)[kp_units<D, KEYS, THREADS>()], int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int n = 0; n < kp_units<D, KEYS, THREADS>(); ++n) {
    const int i = tid + n * THREADS, j = i / CH, c = i % CH;
    if (i < KEYS * CH)
      *reinterpret_cast<uint2*>(dst + j * sk_words(D) + 2 * c) =
          unpack_kv4x2(kr[n], ks[n]);
  }
}

// Q·Kᵀ of n-tile j (keys 8j..8j+7 of the K tile sKb) from the Q
// A-fragments qa: c0, c1 row g keys 8j+2t, +1; c2, c3 row g + 8
template <int D>
__device__ __forceinline__ void qk_ntile(const int* sKb, int j,
                                         const int (&qa)[ksteps(D)][4],
                                         int g, int t, int (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0;
  const int* kr = sKb + (8 * j + g) * sk_words(D) + 2 * t;
#pragma unroll
  for (int s = 0; s < ksteps(D); ++s) {
    const int2 bw = *reinterpret_cast<const int2*>(kr + 8 * s);
    mma_s8(c, qa[s], bw.x, bw.y);
  }
}

// V units a thread stages per tile (over the v_cols(D) padded columns)
template <int D, int KEYS, int THREADS>
__host__ __device__ constexpr int v_units() {
  return (KEYS / 4) * (v_cols(D) / 4) / THREADS;
}

// V unit i: columns 4 dw..4 dw+3 of keys k0, k0+1, k0+8, k0+9, where
// gi = i / DW names chunk c = gi / 8 and word 2 u + hw of its rows; row(key)
// as in load_k_wide; keys at or past t_hi and columns past D read as 0
template <int D, int KEYS, int THREADS, class Row>
__device__ __forceinline__ void load_v(
    unsigned (&vr)[v_units<D, KEYS, THREADS>()][4], Row&& row, int t0,
    int t_hi, int tid) {
  constexpr int DW = v_cols(D) / 4;
  static_assert(v_units<D, KEYS, THREADS>() * THREADS == (KEYS / 4) * DW,
                "whole V units");
#pragma unroll
  for (int n = 0; n < v_units<D, KEYS, THREADS>(); ++n) {
    const int i = tid + n * THREADS, dw = i % DW, gi = i / DW;
    const int k0 = t0 + 32 * (gi >> 3) + 16 * ((gi >> 2) & 1) + 2 * (gi & 3);
    const bool col = D % 32 == 0 || dw < D / 4;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int key = k0 + (jj & 1) + 8 * (jj >> 1);
      vr[n][jj] = col && key < t_hi
                      ? reinterpret_cast<const unsigned*>(row(key))[dw]
                      : 0u;
    }
  }
}

// load_v over packed pools: unit n's four keys' 2 packed bytes of columns
// 4 dw..4 dw+3 (bytes 2 dw, 2 dw + 1 of the packed row) and the shift of
// each key's page; row and row.page as in load_kp
template <int D, int KEYS, int THREADS, class Row>
__device__ __forceinline__ void load_vp(
    unsigned (&vr)[v_units<D, KEYS, THREADS>()][4],
    int (&vs)[v_units<D, KEYS, THREADS>()][4], Row&& row, const int* shift,
    int t0, int t_hi, int tid) {
  constexpr int DW = v_cols(D) / 4;
#pragma unroll
  for (int n = 0; n < v_units<D, KEYS, THREADS>(); ++n) {
    const int i = tid + n * THREADS, dw = i % DW, gi = i / DW;
    const int k0 = t0 + 32 * (gi >> 3) + 16 * ((gi >> 2) & 1) + 2 * (gi & 3);
    const bool col = D % 32 == 0 || dw < D / 4;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int key = k0 + (jj & 1) + 8 * (jj >> 1);
      const bool ok = col && key < t_hi;
      vr[n][jj] =
          ok ? reinterpret_cast<const unsigned short*>(row(key))[dw] : 0u;
      vs[n][jj] = ok ? shift[row.page(key)] : 0;
    }
  }
}

// load_vp's packed units expanded into load_v's int8 words
template <int D, int KEYS, int THREADS>
__device__ __forceinline__ void expand_v(
    unsigned (&vr)[v_units<D, KEYS, THREADS>()][4],
    const int (&vs)[v_units<D, KEYS, THREADS>()][4]) {
#pragma unroll
  for (int n = 0; n < v_units<D, KEYS, THREADS>(); ++n)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) vr[n][jj] = unpack_kv4(vr[n][jj], vs[n][jj]);
}

// the units of load_v as KEYS columns of a Vᵀ tile whose rows are sv
// words (v_cols(D) rows), from pair `pair0` (a multiple of 8: 64 keys) on
template <int D, int KEYS, int THREADS>
__device__ __forceinline__ void store_v_at(
    int* sVt, const unsigned (&vr)[v_units<D, KEYS, THREADS>()][4], int tid,
    int sv, int pair0) {
  constexpr int DW = v_cols(D) / 4;
#pragma unroll
  for (int n = 0; n < v_units<D, KEYS, THREADS>(); ++n) {
    const int i = tid + n * THREADS, dw = i % DW, gi = i / DW;
    const int pair = 4 * (gi >> 3) + (gi & 3), hw = (gi >> 2) & 1;
    const int4 w4 = transpose4(vr[n][0], vr[n][1], vr[n][2], vr[n][3]);
    const int col[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int d = 4 * dw + jj;
      sVt[d * sv + 2 * (pair0 + (pair ^ vswz(d))) + hw] = col[jj];
    }
  }
}

// the units of load_v as Vᵀ (v_cols(D) rows of KEYS / 4 words)
template <int D, int KEYS, int THREADS>
__device__ __forceinline__ void store_v(
    int* sVt, const unsigned (&vr)[v_units<D, KEYS, THREADS>()][4],
    int tid) {
  store_v_at<D, KEYS, THREADS>(sVt, vr, tid, KEYS / 4, 0);
}

// the four s8 weights p[] (n-tile 4s + jj of a chunk, C layout) into the
// chunk's A fragment pa: n-tiles 4s, 4s+1 -> a0 (row g) / a1 (row g+8);
// 4s+2, 4s+3 -> a2 / a3
__device__ __forceinline__ void pack_p(unsigned (&pa)[4], int jj,
                                       const unsigned (&p)[4]) {
  const int sh = 16 * (jj & 1), ai = jj >> 1;
  pa[2 * ai] |= (p[0] | (p[1] << 8)) << sh;
  pa[2 * ai + 1] |= (p[2] | (p[3] << 8)) << sh;
}

// acc += P (chunk s of the tile, A fragment afr) x V (the staged Vᵀ)
template <int D, int KEYS>
__device__ __forceinline__ void pv_chunk(int (&acc)[D / 8][4],
                                         const int (&afr)[4], const int* sVt,
                                         int s, int g, int t) {
  constexpr int SV = KEYS / 4;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int d = 8 * nd + g;
    const int2 bw = *reinterpret_cast<const int2*>(
        sVt + d * SV + 2 * ((4 * s + t) ^ vswz(d)));
    mma_s8(acc[nd], afr, bw.x, bw.y);
  }
}

}  // namespace tc
}  // namespace r8
