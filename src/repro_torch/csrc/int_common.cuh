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

// The Shiftmax constants of an ISoftmaxPlan (core.softmax._exp16).
struct SoftmaxConsts {
  int q_band;                  // clip: q - max >= -q_band
  int in_b, in_c, in_pre;      // dn_in
  int q_ln2, q_b, q_c;         // i-exp polynomial
  int neg_zq;                  // -z_max * q_ln2
  int e_b, e_c, e_pre;         // dn_e16
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

// core.softmax._exp16: (score - rowmax) <= 0 -> exp as a 2^-15 fraction
__device__ __forceinline__ int exp16(int q_sub, const SoftmaxConsts& p) {
  int q = max(q_sub, -p.q_band);
  q = dyadic(q, p.in_b, p.in_c, p.in_pre);
  q = min(q, 0);
  const int qn = max(q, p.neg_zq);
  // -qn >= 0 and q_ln2 > 0: truncation == the reference's floor division
  const int z = (-qn) / p.q_ln2;
  const int q_p = wadd(qn, wmul(z, p.q_ln2));
  const int t = wadd(q_p, p.q_b);
  const int q_l = wadd(wmul(t, t), p.q_c);
  const int e = q_l >> z;                    // 0 <= z <= z_max = 30
  return dyadic(e, p.e_b, p.e_c, p.e_pre);
}

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
