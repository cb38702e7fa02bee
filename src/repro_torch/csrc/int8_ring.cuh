// The TMA-fed ring pieces shared by K1's decode tile
// (int8_matmul_decode.cu) and K1's grouped instantiation
// (int8_matmul_grouped.cu): the full / empty mbarriers of a ring of
// stages, the 2-D and 3-D TMA loads that complete on them, the 128- and
// 64-byte swizzles the TMA writes a weight tile and an x box in, the copy
// route's masked word loads.
#pragma once

#include <cuda.h>
#include <cstdint>

#include "int_mma.cuh"

namespace r8 {
namespace dec {

constexpr int TR = 128;                    // weight tile rows a stage

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the phase of `bar` with this parity; a wait past ~10 s (2^34
// cycles) is a fault, and traps rather than hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  long long t0 = -1;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 < 0)
      t0 = now;
    else if (now - t0 > (1ll << 34))
      __trap();
  }
}

// one 2-D TMA box into this block's shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(unsigned dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// one 3-D TMA box (coordinates innermost first) into this block's shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(unsigned dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// byte offset of (row, col) in a weight tile of BN-byte rows, as the TMA
// swizzle lays it out (128B for BN = 128, 64B for BN = 64)
template <int BN>
__device__ __forceinline__ int wswz(int row, int col) {
  if (BN == 128)
    return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
  return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// byte offset of (row m, K byte col) in an x box (128-byte rows, 128B)
__device__ __forceinline__ int xswz(int m, int col) {
  return m * 128 + ((((col >> 4) ^ m) & 7) << 4) + (col & 15);
}

// bytes p[0..3] as a little-endian word, zero from byte `lim` on
__device__ __forceinline__ unsigned load4(const int8_t* __restrict__ p,
                                          int lim, bool vec) {
  if (lim <= 0) return 0u;
  if (vec && lim >= 4) return *reinterpret_cast<const unsigned*>(p);
  unsigned v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < lim) v |= (unsigned)(uint8_t)p[j] << (8 * j);
  return v;
}

}  // namespace dec
}  // namespace r8
