// K1: int8 x int8 -> int32 GEMM with the fused requant epilogue.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul_pallas
// (body _mm_kernel, epilogue _requant_tile).  x (M, K) and w (K, N) are
// both row-major int8: w is N-major, the layout QuantLinearParams.w8
// shares with the reference and with K3/K4's folded o-projection.
//
// Two paths, chosen by the wrapper from the shape (kernels/int8_matmul.py
// ::launch_plan): M <= 16 (decode, M = batch) is the TMA-fed tile of
// int8_matmul_decode.cu; this file holds the tiles of M > 16:
//
// * Design, M > 16 (prefill chunks M = 128, encoder passes M = 16 384,
//   heads): mma.sync.m16n8k32 s8 x s8 -> s32 on the int8 tensor cores.  At
//   M = 16 384 the products (77 G operations for w1) would take ~1 ms on
//   the CUDA cores at ~70 T __dp4a operations/s, 17-29x the bound, which
//   is the int32 output bytes (w1: 201 MB) or the tensor cores' rate.
//   A block of 8 warps (2 along M x 4 along N) owns a BM x 128 output
//   tile (BM = 128, or 64 where 128-row tiles would not fill the card),
//   a warp a (BM/2) x 32 sub-tile of m16n8 products, and the block walks
//   K in steps of BK = 64 bytes:
//     - X tiles (K-contiguous, no transform) go by cp.async.cg 16-byte
//       copies into a ring of 3 stages, zero-filled (src-size 0) past the
//       ragged M / K edge;
//     - W tiles are read with 8-byte loads into registers one step ahead
//       (sixteen threads cover a 128-byte row, so every thread of the
//       block has one 4-row x 8-byte unit), byte-transposed with
//       __byte_perm into the same "4 K values of one column" words as the
//       decode tile's, and stored into the other of two sw buffers after
//       the current step's products.  Those words are exactly mma's .col
//       B fragments, and the X words sx[m][k/4] exactly its .row A
//       fragments, so neither operand is reshuffled again.
//   Measured alternatives, no faster on this card (PERF.md): W through a
//   4-stage cp.async ring transposed shared-to-shared (2 steps in
//   flight), and a 128 x 256 tile of 16 warps (a quarter fewer L2 bytes
//   per product).  The two k32 steps of a stage are not unrolled: with
//   both unrolled, ptxas hoists both steps' fragments and the 128-row
//   tile spills at the 128 registers that 2 blocks an SM allow.
//   Fragments (PTX ISA, m16n8k32 .s8; g = lane / 4, t = lane % 4, kb the
//   word offset of the k32 step): a0 = sx[g][kb+t], a1 = sx[g+8][kb+t],
//   a2 = sx[g][kb+4+t], a3 = sx[g+8][kb+4+t]; b0 = sw[kb+t][g],
//   b1 = sw[kb+4+t][g]; c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row
//   g + 8.  Padded row strides keep every fragment load free of bank
//   conflicts: sx rows are BK/4 + 4 = 20 words, so a0's bank is
//   (20 g + t) mod 32 and 20 g mod 32 runs over {0, 20, 8, 28, 16, 4,
//   24, 12} for g = 0..7, 32 distinct banks with t; sw rows are
//   128 + 8 = 136 words, so b0's bank is (8 t + g) mod 32, again 32
//   distinct.  The W stores are 16-byte: a thread writes columns
//   8 nn .. 8 nn + 7 of one word row as two int4, and threads with
//   nn & 4 write their upper half first, so the 8 threads of a store
//   phase hit words {0, 8, 16, 24, 36, 44, 52, 60} (mod 64): distinct
//   4-bank groups.
//   The accumulator wraps modulo 2^32 (no .satfinite), as JAX's int32
//   does; the bit-budget certifier keeps real sums in range anyway.
//   What bounds it as built (PERF.md): ~0.4 P int8 operations/s at
//   M = 16 384 and on the M = 128 logits head, a fifth of the card's
//   int8 peak and 2-7x the bound, so neither bytes nor the L2 or load
//   latency (the alternatives above) but the issue of mma.sync with its
//   1.5 shared-memory fragment loads a product, and a barrier every 64
//   bytes of K.
//
// Why mma.sync and not wgmma: for 8-bit types wgmma reads A and B from
// shared memory K-major only (there is no transposed 8-bit operand as
// there is for 16-bit types), and the weights are N-major.  A K-major
// copy would change the weight layout shared with the reference, or
// double weight memory; that is a later change (ROADMAP).
//
// The tiles split K across blocks (grid.z) when the output tiles cover
// fewer than about two waves of SMs: each split adds its partial tile
// into an int32 workspace with atomicAdd and the last split to arrive (a
// per-tile counter) runs the epilogue on the full sum.  Integer addition
// modulo 2^32 is associative and commutative, so the result does not
// depend on the arrival order and is bit-exact.  Ragged M, N and K are
// masked inside the kernels (zero-filled loads, guarded stores); where K,
// N or a pointer is not aligned for the vector copies (vec_x / vec_w),
// the same kernel takes scalar masked loads.
//
// Packed weights (int8_matmul_pallas's packed=True: QuantLinearParams.
// w_packed, int4 nibble pairs (K/2, N), K row 2i in the low nibble of byte
// row i) are the PACKED instantiation of the tiles, a template argument
// (a run-time branch cost 5-6 % in K3).  Only the W loads change: byte
// rows 2kk and 2kk + 1 of a column hold exactly K rows 4kk..4kk+3, so the
// two bytes b0 | b1 << 8 expand (unpack_kv4 at shift 0: one byte permute
// and a bytewise sign extension) straight into the "4 K values of one
// column" word, with no 4x4 transpose; a load unit reads half the bytes.
// The K range of a split is a multiple of BK, so every byte row is whole;
// where K / 2 is odd, the byte row past kend / 2 loads as zero.  MSR-4's
// outlier lanes are not applied here: a raw launch feeds
// csrc/int8_matmul_msr4.cu.
//
// Epilogue (exactly _requant_tile), in registers: acc + bias, then raw
// int32 out, or the two-stage round-half-up dyadic (per-tensor b, or
// per-channel b_vec[n] with shared c, pre), clipped to out_bits, stored
// as int8 or int32.
#include "int_common.cuh"
#include "int_mma.cuh"
#include "int_attrs.cuh"

namespace r8 {

// four x[m][k..k+3] bytes as one little-endian word, zero past kend / M
__device__ __forceinline__ int load_x_pack(const int8_t* __restrict__ x,
                                           int M, int K, int kend, int m,
                                           int k, bool vec) {
  if (m >= M || k >= kend) return 0;
  const int8_t* p = x + (size_t)m * K + k;
  if (vec && k + 3 < kend) return *reinterpret_cast<const int*>(p);
  int v = 0;
  for (int j = 0; j < 4; ++j)
    if (k + j < kend) v |= ((int)(uint8_t)p[j]) << (8 * j);
  return v;
}

namespace tc {

// shape shared by the tensor-core tiles (BM = 64 or 128)
constexpr int THREADS = 256;       // 8 warps: 2 along M x 4 along N
constexpr int BN = 128;
constexpr int BK = 64;             // K bytes per stage
constexpr int BK4 = BK / 4;        // K words per stage
constexpr int SX = BK4 + 4;        // sx row stride (words), see the note
constexpr int SW = BN + 8;         // sw row stride (words), see the note
constexpr int XSTAGES = 3;         // cp.async ring of X tiles
constexpr int WN = 4;              // warps along N
constexpr int WTN = BN / WN;       // 32 columns a warp
constexpr int NT = WTN / 8;        // m16n8 products along N a warp
static_assert(THREADS == BK4 * (BN / 8), "one W load unit per thread");

// one X stage: BM rows x BK bytes from k0 into sx (row stride SX words)
template <int BM>
__device__ __forceinline__ void load_x_stage(int* sx,
                                             const int8_t* __restrict__ x,
                                             int M, int K, int kend, int m0,
                                             int k0, bool vec) {
  constexpr int CPR = BK / 16;     // 16-byte chunks a row
  static_assert(BM * CPR % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int q = 0; q < BM * CPR / THREADS; ++q) {
    const int i = threadIdx.x + q * THREADS;
    const int r = i / CPR, c = i % CPR;
    const int m = m0 + r, k = k0 + 16 * c;
    int* dst = sx + r * SX + 4 * c;
    if (vec) {
      const int valid = (m < M && k < kend) ? min(16, kend - k) : 0;
      cp_async16(smem_addr(dst), valid ? x + (size_t)m * K + k : x, valid);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = load_x_pack(x, M, K, kend, m, k + 4 * j, false);
    }
  }
}

// w[k][n..n+7] as two little-endian words, zero past kend / N
__device__ __forceinline__ uint2 load_w8(const int8_t* __restrict__ w, int N,
                                         int kend, int k, int n, bool vec) {
  if (k >= kend || n >= N) return make_uint2(0u, 0u);
  const int8_t* p = w + (size_t)k * N + n;
  if (vec) return *reinterpret_cast<const uint2*>(p);
  unsigned lo = 0u, hi = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (n + j >= N) break;
    const unsigned b = (unsigned)(uint8_t)p[j];
    if (j < 4)
      lo |= b << (8 * j);
    else
      hi |= b << (8 * (j - 4));
  }
  return make_uint2(lo, hi);
}

// this thread's W load unit of a stage: word row kk (K rows 4 kk..4 kk+3),
// columns 8 nn..8 nn+7; PACKED: byte rows 2 kk, 2 kk + 1 of the nibbles
// (k0 is even), into r[0..1]
template <bool PACKED>
__device__ __forceinline__ void load_w_regs(uint2 (&r)[4],
                                            const int8_t* __restrict__ w,
                                            int N, int kend, int k0, int n0,
                                            bool vec) {
  const int kk = threadIdx.x / (BN / 8), nn = threadIdx.x % (BN / 8);
  if constexpr (PACKED) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      r[j] = load_w8(w, N, kend / 2, k0 / 2 + 2 * kk + j, n0 + 8 * nn, vec);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = load_w8(w, N, kend, k0 + 4 * kk + j, n0 + 8 * nn, vec);
  }
}

// the unit as "4 K values of one column" words into sw
template <bool PACKED>
__device__ __forceinline__ void store_w_regs(int* sw, const uint2 (&r)[4]) {
  const int kk = threadIdx.x / (BN / 8), nn = threadIdx.x % (BN / 8);
  const int4 lo = PACKED ? expand_w4(r[0].x, r[1].x)
                         : transpose4(r[0].x, r[1].x, r[2].x, r[3].x);
  const int4 hi = PACKED ? expand_w4(r[0].y, r[1].y)
                         : transpose4(r[0].y, r[1].y, r[2].y, r[3].y);
  int* row = sw + kk * SW + 8 * nn;
  // upper half first where nn & 4: conflict-free phases (see the note)
  const bool swap = (nn & 4) != 0;
  *reinterpret_cast<int4*>(row + (swap ? 4 : 0)) = swap ? hi : lo;
  *reinterpret_cast<int4*>(row + (swap ? 0 : 4)) = swap ? lo : hi;
}

}  // namespace tc
}  // namespace r8

namespace r8 {
namespace tc {

// 2 blocks an SM: at most 128 registers a thread
template <int BM, bool PACKED>
__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_mma_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const int* __restrict__ bias,
                       const int* __restrict__ bvec, Requant rq,
                       void* __restrict__ out, int out_is_int8, int M, int N,
                       int K, int k_per_split, int* __restrict__ ws,
                       int* __restrict__ tile_count, int vec_x, int vec_w) {
  constexpr int WTM = BM / 2;      // rows a warp
  constexpr int MT = WTM / 16;     // m16n8 products along M a warp
  __shared__ __align__(16) int sx_ring[XSTAGES][BM][SX];
  __shared__ __align__(16) int sw_pair[2][BK4][SW];
  __shared__ int is_last;
  int* sx0 = &sx_ring[0][0][0];
  int* sw0 = &sw_pair[0][0][0];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int nk = (kend - kbeg + BK - 1) / BK;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // X of K-step s in slot s % XSTAGES; its W in sw[s & 1], stored from
  // registers loaded one step ahead
#pragma unroll
  for (int s = 0; s < XSTAGES - 1; ++s) {
    if (s < nk)
      load_x_stage<BM>(sx0 + s * BM * SX, x, M, K, kend, m0, kbeg + s * BK,
                       vec_x);
    cp_commit();
  }
  uint2 wr[4];
  load_w_regs<PACKED>(wr, w, N, kend, kbeg, n0, vec_w);
  store_w_regs<PACKED>(sw0, wr);

  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk)                 // next W step: in flight meanwhile
      load_w_regs<PACKED>(wr, w, N, kend, kbeg + (it + 1) * BK, n0, vec_w);
    cp_wait<XSTAGES - 2>();          // X of step it has landed
    __syncthreads();                 // ... for every thread; step it-1 done
    {
      const int s = it + XSTAGES - 1;  // into step it-1's slot
      if (s < nk)
        load_x_stage<BM>(sx0 + (s % XSTAGES) * BM * SX, x, M, K, kend, m0,
                         kbeg + s * BK, vec_x);
      cp_commit();
    }
    const int* sx = sx0 + (it % XSTAGES) * BM * SX + (wm * WTM + g) * SX + t;
    const int* sw = sw0 + (it & 1) * BK4 * SW + t * SW + wn * WTN + g;
#pragma unroll 1
    for (int kb = 0; kb < BK4; kb += 8) {
      int b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b[j][0] = sw[kb * SW + 8 * j];
        b[j][1] = sw[(kb + 4) * SW + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int* r = sx + 16 * i * SX + kb;
        const int a[4] = {r[0], r[8 * SX], r[4], r[8 * SX + 4]};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
    if (it + 1 < nk)                 // the sw buffer read at it-1 is free
      store_w_regs<PACKED>(sw0 + ((it + 1) & 1) * BK4 * SW, wr);
  }

  // this thread's outputs: rows m_i + 8 h, columns n_j, n_j + 1
  const int mw = m0 + wm * WTM + g;
  const int nw = n0 + wn * WTN + 2 * t;
  if (gridDim.z > 1) {
    // split-K: add this split's partial tile, the last split finishes
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mw + 16 * i + 8 * (e / 2);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = nw + 8 * j + (e % 2);
          if (m < M && n < N) atomicAdd(&ws[(size_t)m * N + n], acc[i][j][e]);
        }
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      is_last = atomicAdd(&tile_count[tile], 1) == (int)gridDim.z - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mw + 16 * i + 8 * (e / 2);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = nw + 8 * j + (e % 2);
          if (m < M && n < N) acc[i][j][e] = __ldcg(&ws[(size_t)m * N + n]);
        }
      }
  }

  // epilogue: bias, requant, clip, store (column pairs where N is even)
  const bool pair = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = nw + 8 * j;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const int bias0 = bias != nullptr ? bias[n] : 0;
    const int bias1 = bias != nullptr && two ? bias[n + 1] : 0;
    int b0 = rq.b, b1 = rq.b;
    if (rq.kind == RQ_PER_CHANNEL) {
      b0 = bvec[n];
      b1 = two ? bvec[n + 1] : 0;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mw + 16 * i + 8 * h;
        if (m >= M) continue;
        int v0 = wadd(acc[i][j][2 * h], bias0);
        int v1 = wadd(acc[i][j][2 * h + 1], bias1);
        if (rq.kind != RQ_RAW) {
          v0 = requant(v0, rq, b0);
          v1 = requant(v1, rq, b1);
        }
        const size_t o = (size_t)m * N + n;
        if (out_is_int8) {
          int8_t* p = reinterpret_cast<int8_t*>(out) + o;
          if (pair) {
            *reinterpret_cast<char2*>(p) = make_char2((char)v0, (char)v1);
          } else {
            p[0] = (int8_t)v0;
            if (two) p[1] = (int8_t)v1;
          }
        } else {
          int* p = reinterpret_cast<int*>(out) + o;
          if (pair) {
            *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
          } else {
            p[0] = v0;
            if (two) p[1] = v1;
          }
        }
      }
  }
}

template <int BM, bool PACKED>
int launch(const void* x, const void* w, const void* bias, const void* bvec,
           const Requant& rq, void* out, int out_is_int8, int M, int N,
           int K, int splits, int k_per_split, void* ws, void* tile_count,
           int vec_x, int vec_w, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_matmul_mma_kernel<BM, PACKED><<<grid, THREADS, 0, s>>>(
      (const int8_t*)x, (const int8_t*)w, (const int*)bias,
      (const int*)bvec, rq, out, out_is_int8, M, N, K, k_per_split,
      (int*)ws, (int*)tile_count, vec_x, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace r8

namespace r8 {
template <bool PACKED>
int launch_all(const void* x, const void* w, const void* bias,
               const void* bvec, const Requant& rq, void* out,
               int out_is_int8, int M, int N, int K, int tile, int splits,
               int k_per_split, void* ws, void* tile_count, int vec_x,
               int vec_w, cudaStream_t s) {
  if (tile == 1)
    return tc::launch<64, PACKED>(x, w, bias, bvec, rq, out, out_is_int8, M,
                                  N, K, splits, k_per_split, ws, tile_count,
                                  vec_x, vec_w, s);
  if (tile == 2)
    return tc::launch<128, PACKED>(x, w, bias, bvec, rq, out, out_is_int8, M,
                                   N, K, splits, k_per_split, ws, tile_count,
                                   vec_x, vec_w, s);
  return (int)cudaErrorInvalidValue;
}
}  // namespace r8

// tile: 1 the 64 x 128 and 2 the 128 x 128 tensor-core tiles (M > 16;
// kernels/int8_matmul.py::launch_plan; M <= 16 is int8_matmul_decode.cu's);
// packed: w is (K / 2, N) int4 nibble pairs
extern "C" int r8_int8_matmul(const void* x, const void* w, const void* bias,
                              const void* bvec, const r8::Requant* rq,
                              void* out, int out_is_int8, int M, int N,
                              int K, int tile, int splits,
                              int k_per_split, void* ws, void* tile_count,
                              int vec_x, int vec_w, int packed,
                              void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return packed ? r8::launch_all<true>(x, w, bias, bvec, *rq, out,
                                       out_is_int8, M, N, K, tile, splits,
                                       k_per_split, ws, tile_count, vec_x,
                                       vec_w, s)
                : r8::launch_all<false>(x, w, bias, bvec, *rq, out,
                                        out_is_int8, M, N, K, tile, splits,
                                        k_per_split, ws, tile_count, vec_x,
                                        vec_w, s);
}

extern "C" const char* r8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: BM 64 or 128, packed); out[6]
extern "C" int r8_attrs_int8_matmul(const int* sel, int threads, int smem,
                                    int cluster, int* out) {
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  const bool packed = sel[1] != 0;
  if (sel[0] == 64)
    return packed ? r8::attrs(r8::tc::int8_matmul_mma_kernel<64, true>,
                              threads, smem, 1, 1, out)
                  : r8::attrs(r8::tc::int8_matmul_mma_kernel<64, false>,
                              threads, smem, 1, 1, out);
  if (sel[0] == 128)
    return packed ? r8::attrs(r8::tc::int8_matmul_mma_kernel<128, true>,
                              threads, smem, 1, 1, out)
                  : r8::attrs(r8::tc::int8_matmul_mma_kernel<128, false>,
                              threads, smem, 1, 1, out);
  return (int)cudaErrorInvalidValue;
}
