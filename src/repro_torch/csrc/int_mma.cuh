// Tensor-core and async-copy helpers shared by the int8 kernels on
// mma.sync: K1's tiles (int8_matmul.cu, int8_matmul_decode.cu), K5 and K4
// (int_attention_mma.cuh) and K8 (int_attention_online.cu).
//
// mma.sync.m16n8k32 .s8 fragments (PTX ISA; g = lane / 4, t = lane % 4):
// a0 holds A[g][4t..4t+3], a1 A[g+8][4t..4t+3], a2 A[g][16+4t..16+4t+3],
// a3 A[g+8][16+4t..]; b0 holds B[4t..4t+3][g], b1 B[16+4t..16+4t+3][g];
// c0, c1 are C[g][2t], C[g][2t+1] and c2, c3 the same columns of row g + 8.
// The product sums over k, so a kernel may feed any permutation of k as
// long as A and B use the same one.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "int_common.cuh"

namespace r8 {
namespace tc {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; bytes past `valid` (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid)
               : "memory");
}

// 8 bytes global -> shared (K rows of a head dim that is not a multiple
// of 16: at D = 120 a head's row starts 8-byte aligned); zero-filled where
// `valid` is 0
__device__ __forceinline__ void cp_async8(unsigned dst, const void* src,
                                          int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid)
               : "memory");
}

// 4 bytes global -> shared (word copies of operands that are not 16-byte
// aligned); zero-filled where `valid` is 0
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 x s8 -> s32, wrapping
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       int b0, int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: word j holds rows r0..r3's byte j (column j)
__device__ __forceinline__ int4 transpose4(unsigned r0, unsigned r1,
                                           unsigned r2, unsigned r3) {
  const unsigned lo01 = __byte_perm(r0, r1, 0x5140);
  const unsigned lo23 = __byte_perm(r2, r3, 0x5140);
  const unsigned hi01 = __byte_perm(r0, r1, 0x7362);
  const unsigned hi23 = __byte_perm(r2, r3, 0x7362);
  return make_int4((int)__byte_perm(lo01, lo23, 0x5410),
                   (int)__byte_perm(lo01, lo23, 0x7632),
                   (int)__byte_perm(hi01, hi23, 0x5410),
                   (int)__byte_perm(hi01, hi23, 0x7632));
}

// two byte rows' words (4 columns each) of packed int4 nibbles (K row 2i
// in the low nibble of byte row i) -> the 4 columns' "4 K values of one
// column" words: column j's byte of p0 (K rows 2 r0, 2 r0 + 1) and of p1
// (2 r1, 2 r1 + 1) side by side, then expanded (unpack_kv4 at shift 0)
__device__ __forceinline__ int4 expand_w4(unsigned p0, unsigned p1) {
  const uint2 c01 = unpack_kv4x2(__byte_perm(p0, p1, 0x5140), 0);
  const uint2 c23 = unpack_kv4x2(__byte_perm(p0, p1, 0x7362), 0);
  return make_int4((int)c01.x, (int)c01.y, (int)c23.x, (int)c23.y);
}

}  // namespace tc
}  // namespace r8
