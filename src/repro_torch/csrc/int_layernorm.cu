// K2: integer LayerNorm / RMSNorm, one row per block.
//
// Replaces the TPU kernel repro/kernels/int_layernorm.py::int_layernorm_pallas
// (body _ln_kernel, integer sqrt _i_sqrt_tile).
//
// What bounds it on the H100: device-memory bytes — each row of d int32 is
// read once and written once (d = 4096: 32 KB per row), and the arithmetic
// per element is a few integer ops; the row reductions and the 16 Newton
// steps are per-row scalars.
//
// Design: one block of 256 threads per row.  The row stays in the block
// (each thread keeps its strided elements in registers between the three
// phases, so the row is read from device memory once): block-wide int32
// sums (wrap-around modular adds — associative, so the shuffle order
// cannot change the result) for the dyadic mean (LayerNorm only) and the
// pre-shifted variance, then one thread-uniform integer sqrt with the
// reference's fixed 16 Newton steps, the clamp at 46340 and the final +-1
// corrections, one reciprocal per row, and the per-channel gamma/beta and
// dyadic output requant per element.
#include "int_common.cuh"

namespace r8 {

struct NormConsts {
  int d;
  int subtract_mean;
  int mean_b, mean_c, mean_pre;   // dn_mean
  int var_b, var_c, var_pre;      // dn_var
  int pre_shift;
  int recip_bits;
  int out_b, out_c, out_pre;      // dn_out
  int lo, hi;                     // clip to out_bits
};

constexpr int LN_THREADS = 256;
constexpr int LN_MAX_PER_THREAD = 32;   // d <= 8192

// block-wide int32 sum modulo 2^32
__device__ __forceinline__ int block_sum(int v, int* red) {
  unsigned u = (unsigned)v;
  for (int off = 16; off > 0; off >>= 1)
    u += __shfl_xor_sync(0xffffffffu, u, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                      // red may still be read
  if (lane == 0) red[warp] = (int)u;
  __syncthreads();
  unsigned total = 0;
  for (int i = 0; i < LN_THREADS / 32; ++i) total += (unsigned)red[i];
  return (int)total;
}

// core.intmath.i_sqrt: floor(sqrt(n)) for n > 0, 0 for n <= 0
__device__ __forceinline__ int isqrt16(int n) {
  if (n <= 0) return 0;
  int b = 0, v = n;
  for (int s = 16; s > 0; s >>= 1) {
    const int t = v >> s;
    if (t > 0) {
      b += s;
      v = t;
    }
  }
  const int bl = b + (v > 0 ? 1 : 0);
  int x = max(1 << ((bl + 1) >> 1), 1);
  for (int i = 0; i < 16; ++i) {
    // n > 0 and x >= 1: truncation == the reference's floor division
    const int nx = (x + n / x) >> 1;
    x = min(x, max(nx, 1));
  }
  x = min(x, 46340);
  for (int i = 0; i < 2; ++i)
    if (x * x > n) x -= 1;
  if (x < 46340 && (x + 1) * (x + 1) <= n) x += 1;
  return x;
}

__global__ void __launch_bounds__(LN_THREADS)
int_layernorm_kernel(const int* __restrict__ q, const int* __restrict__ gamma,
                     const int* __restrict__ beta, NormConsts p,
                     int* __restrict__ out) {
  __shared__ int red[LN_THREADS / 32];
  const int row = blockIdx.x;
  const int* x = q + (size_t)row * p.d;
  int* o = out + (size_t)row * p.d;
  int vals[LN_MAX_PER_THREAD];
  int n_mine = 0;
  int s = 0;
  for (int i = threadIdx.x; i < p.d; i += LN_THREADS) {
    vals[n_mine] = x[i];
    s = wadd(s, vals[n_mine]);
    ++n_mine;
  }
  int mu = 0;
  if (p.subtract_mean) {
    mu = dyadic(block_sum(s, red), p.mean_b, p.mean_c, p.mean_pre);
  }
  int ss = 0;
  for (int j = 0; j < n_mine; ++j) {
    vals[j] = wsub(vals[j], mu);                 // y = q - mu
    const int ys = rshift_round(vals[j], p.pre_shift);
    ss = wadd(ss, wmul(ys, ys));
  }
  const int var = dyadic(block_sum(ss, red), p.var_b, p.var_c, p.var_pre);
  const int sigma = isqrt16(var);
  // both operands positive: truncation == floor division
  const int r = (1 << (p.recip_bits + p.pre_shift)) / max(sigma, 1);
  int j = 0;
  for (int i = threadIdx.x; i < p.d; i += LN_THREADS, ++j) {
    int nq = 0;
    if (sigma != 0) nq = rshift_round(wmul(vals[j], r), 2 * p.pre_shift);
    int v = wmul(nq, gamma[i]);
    if (beta != nullptr) v = wadd(v, beta[i]);
    v = dyadic(v, p.out_b, p.out_c, p.out_pre);
    o[i] = clampi(v, p.lo, p.hi);
  }
}

}  // namespace r8

extern "C" int r8_int_layernorm(const void* q, const void* gamma,
                                const void* beta, const r8::NormConsts* p,
                                void* out, int rows, void* stream) {
  if (p->d > r8::LN_THREADS * r8::LN_MAX_PER_THREAD)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  r8::int_layernorm_kernel<<<rows, r8::LN_THREADS, 0, s>>>(
      (const int*)q, (const int*)gamma, (const int*)beta, *p, (int*)out);
  return (int)cudaGetLastError();
}
