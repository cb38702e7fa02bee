// Shared integer helpers for the port's Hopper kernels.
//
// The JAX reference computes in int32 with wrap-around (XLA semantics).
// Signed overflow is undefined in C++, so every add/multiply that the
// reference may wrap goes through unsigned arithmetic and is cast back,
// which is two's-complement truncation exactly as int32 would do.  `>>` on
// a negative int is an arithmetic shift under nvcc.  Integer `/` truncates;
// every division below has non-negative operands, where truncation and the
// reference's floor division agree (the call sites say why).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace r8 {

// requant epilogue kinds (RequantSpec)
enum { RQ_RAW = 0, RQ_PER_TENSOR = 1, RQ_PER_CHANNEL = 2 };

// RequantSpec flattened: per-tensor uses b; per-channel reads b from a
// vector; both share (c, pre); lo/hi clip to out_bits.
struct Requant {
  int kind;
  int b;
  int c;
  int pre;
  int lo;
  int hi;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// core.dyadic.rshift_round: s == 0 identity, s < 0 exact left shift,
// else (x + 2^(s-1)) >> s with the rounding add wrapping as int32.
// Wrappers keep -31 <= s <= 31.
__device__ __forceinline__ int rshift_round(int x, int s) {
  if (s == 0) return x;
  if (s < 0) return (int)((unsigned)x << (unsigned)(-s));
  return wadd(x, (int)(1u << (unsigned)(s - 1))) >> s;
}

// two-stage dyadic requant: rshift_round(rshift_round(x, pre) * b, c - pre)
__device__ __forceinline__ int dyadic(int x, int b, int c, int pre) {
  return rshift_round(wmul(rshift_round(x, pre), b), c - pre);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Shiftmax's exp16 (core.softmax._exp16) with no branch per element, for
// K3, K4, K5 and K8 (int_attention_tc.cuh's tiles) and K7
// (int_softmax.cu): the host resolves each dyadic shift, a launch
// constant, into a multiply, a rounding add and a right shift
// (kernels/_abi.py::exp16_consts), and the division (-qn) / q_ln2 becomes
// an exact multiply-high (kernels/int_attention_fused.py::exp16_divisor,
// checked on its whole domain on the host and on the card by
// r8_exp16_div_check).
namespace tc {

__device__ __forceinline__ int div_ln2(int n, unsigned magic, int shift) {
  return (int)(__umulhi((unsigned)n, magic) >> shift);
}

// core.dyadic.rshift_round by a launch-constant s, without branches:
// x * 2^max(-s, 0) + 2^(s-1) (s > 0), wrapping, then >> max(s, 0)
struct Shift {
  unsigned mul;
  unsigned half;
  int rs;
};

__device__ __forceinline__ int rshift(int x, const Shift& sh) {
  return (int)((unsigned)x * sh.mul + sh.half) >> sh.rs;
}

// the Shiftmax constants with every shift resolved for the launch (by the
// host: kernels/_abi.py::exp16_consts), read from the kernel's parameters
struct Exp16 {
  int q_band, in_b, neg_zq, q_ln2, q_b, q_c, e_b;
  Shift in_pre, in_post, e_pre, e_post;
  unsigned magic;           // n / q_ln2 == __umulhi(n, magic) >> z_shift
  int z_shift;              //   on [0, -neg_zq]
};

// core.softmax._exp16: (score - rowmax) <= 0 -> exp as a 2^-15 fraction,
// with the dyadic shifts resolved per launch and the division by q_ln2 a
// multiply-high
__device__ __forceinline__ int exp16_mma(int q_sub, const Exp16& p) {
  int q = max(q_sub, -p.q_band);
  q = rshift(wmul(rshift(q, p.in_pre), p.in_b), p.in_post);
  q = min(q, 0);
  const int qn = max(q, p.neg_zq);
  const int z = div_ln2(-qn, p.magic, p.z_shift);
  const int q_p = wadd(qn, wmul(z, p.q_ln2));
  const int t = wadd(q_p, p.q_b);
  const int q_l = wadd(wmul(t, t), p.q_c);
  const int e = q_l >> z;
  return rshift(wmul(rshift(e, p.e_pre), p.e_b), p.e_post);
}

}  // namespace tc

// Packed int4 KV (repro/ops/packed.py, the kv_dtype="int4" page tier): a
// byte holds head-dim lanes 2i (low nibble) and 2i + 1 (high); a lane
// dequantizes to its sign-extended nibble q4 shifted left by its page's
// shift, wrapped to int8 as the reference's int32 shift and int8 cast do.
// Four lanes (two packed bytes, the low 16 bits of p) expand into one
// word of four int8 lanes; 8 lanes (four bytes) into two words.  The
// nibbles are spread into bytes with one byte permute, sign-extended
// bytewise (n | (n & 8) * 30: 8 * 30 = 0xF0 stays inside the byte) and
// shifted as a word, the bits a byte shifts into its neighbour masked
// off.  A shift outside 0..7 leaves 0, the low byte of q4 << s for s >= 8.
__device__ __forceinline__ unsigned kv4_shift(unsigned n, int s) {
  const unsigned v = n | ((n & 0x08080808u) * 0x1Eu);
  const unsigned su = min((unsigned)s, 8u);
  return (v << su) & (((0xFFu << su) & 0xFFu) * 0x01010101u);
}

__device__ __forceinline__ unsigned unpack_kv4(unsigned p, int s) {
  return kv4_shift(__byte_perm(p & 0x0F0Fu, (p >> 4) & 0x0F0Fu, 0x5140), s);
}

__device__ __forceinline__ uint2 unpack_kv4x2(unsigned p, int s) {
  const unsigned lo = p & 0x0F0F0F0Fu, hi = (p >> 4) & 0x0F0F0F0Fu;
  return make_uint2(kv4_shift(__byte_perm(lo, hi, 0x5140), s),
                    kv4_shift(__byte_perm(lo, hi, 0x7362), s));
}

// the RequantSpec epilogue on one int32 accumulator (not raw)
__device__ __forceinline__ int requant(int acc, const Requant& rq, int b) {
  return clampi(dyadic(acc, b, rq.c, rq.pre), rq.lo, rq.hi);
}

}  // namespace r8
