// The pieces of K1's tensor-core tile (csrc/int8_matmul.cu) that its
// grouped instantiation (csrc/int8_matmul_grouped.cu) shares: the tile
// constants, the X stage copies, and the W load units read into
// registers and stored byte-transposed as mma.sync .col B fragments.
// int8_matmul.cu's note explains the layout, the strides and the banks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "int_common.cuh"
#include "int_mma.cuh"

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
