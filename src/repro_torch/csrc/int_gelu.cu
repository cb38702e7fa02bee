// K6: integer-only GELU (SwiftTron §III-H, Fig. 14), bit-exact.
//
// Replaces the TPU kernel repro/kernels/int_gelu.py::int_gelu_pallas
// (body _gelu_kernel).
//
// What bounds it on the H100: device-memory bytes.  Each int32 element is
// read once and written once (8 bytes) against about 20 integer
// operations, far below the card's ratio of operations to bytes; on the
// encoder's FFN (16 384 x 3072 elements) that is 402 MB, about 120 us at
// 3.35 TB/s.
//
// Design: a flat grid-stride loop over numel, masked at the tail (the TPU
// kernel fitted a block that divides numel; here any size is one launch),
// one element per thread per step, neighbouring threads on neighbouring
// words so every load and store coalesces.  The arithmetic is the
// reference's int32 arithmetic exactly: sign(0) is 0, |q| wraps at -2^31,
// and every add and multiply that may wrap (q * (erf + q_one) comes
// within 1% of INT32_MAX on the FFN's plan) goes through the unsigned
// helpers of int_common.cuh; `>>` is arithmetic.  The output is int32
// clipped to out_bits, as on the TPU.
#include "int_common.cuh"
#include "int_attrs.cuh"

namespace r8 {

// An IGeluPlan (its IErfPlan) and the output Dyadic + clip.
struct GeluConsts {
  int q_clip, q_bneg, q_c;     // i-erf polynomial
  int q_one;                   // 1.0 at the erf output scale
  int out_b, out_c, out_pre;   // dn_out
  int lo, hi;                  // clip to out_bits
};

constexpr int GELU_THREADS = 256;

__device__ __forceinline__ int i_gelu_requant(int q, const GeluConsts& p) {
  const int sgn = (q > 0) - (q < 0);
  const int q_abs = q < 0 ? wsub(0, q) : q;      // wraps at -2^31
  const int t = wadd(min(q_abs, p.q_clip), p.q_bneg);
  const int bracket = wadd(wmul(t, t), p.q_c);
  const int q_erf = wmul(sgn, wsub(0, bracket));
  const int out = wmul(q, wadd(q_erf, p.q_one));
  return clampi(dyadic(out, p.out_b, p.out_c, p.out_pre), p.lo, p.hi);
}

__global__ void __launch_bounds__(GELU_THREADS)
int_gelu_kernel(const int* __restrict__ q, int* __restrict__ out,
                long long n, GeluConsts p) {
  const long long stride = (long long)gridDim.x * GELU_THREADS;
  for (long long i = (long long)blockIdx.x * GELU_THREADS + threadIdx.x;
       i < n; i += stride)
    out[i] = i_gelu_requant(q[i], p);
}

}  // namespace r8

extern "C" int r8_int_gelu(const void* q, void* out, long long n,
                           const r8::GeluConsts* p, int blocks,
                           void* stream) {
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  r8::int_gelu_kernel<<<blocks, r8::GELU_THREADS, 0, s>>>(
      (const int*)q, (int*)out, n, *p);
  return (int)cudaGetLastError();
}

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: none); out[6]
extern "C" int r8_attrs_int_gelu(const int* sel, int threads, int smem,
                                 int cluster, int* out) {
  (void)sel;
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  return r8::attrs(r8::int_gelu_kernel, threads, smem, 1, 1, out);
}
