// K2: integer LayerNorm / RMSNorm, rows held in registers.
//
// Replaces the TPU kernel repro/kernels/int_layernorm.py::int_layernorm_pallas
// (body _ln_kernel, integer sqrt _i_sqrt_tile).
//
// What bounds it on the H100:
//   * many rows (an encode pass's 16 384 x 768, a windowed prefill's
//     1024 x 3840): device-memory bytes.  Each row of d int32 is read once
//     and written once, 8d bytes (16 384 x 768: 100.7 MB, 30 us at
//     3.35 TB/s); gamma / beta come from L2.  The arithmetic, ~16 int32
//     operations an element, hides under the bytes once enough rows are in
//     flight on every SM.
//   * few rows (a decode step's 4 x 4096): launch latency.  The 131 KB
//     take 0.04 us at the byte rate; the time is the launch, one round trip
//     to device memory for the row and gamma, two reductions and a store.
//
// Design.  A thread owns the same columns of every row it touches, in
// vectors of VEC ints (an int4, 128-bit, when d % 4 == 0 and every
// operand is 16-byte aligned, else one int): its vector j is the row's
// vector j * stride + t.  The count a thread holds is a template argument
// (VPL values), so every loop unrolls and the row stays in registers
// between the three phases: read once, written once, no local memory.
//   * Warp route (d <= 1024): one warp a row, 8 rows a CTA, a persistent
//     grid of about one wave striding over the rows.  A lane loads its
//     gamma / beta slice once and keeps it across its rows; the two row
//     sums are warp butterflies of __shfl_xor_sync (no shared memory, no
//     __syncthreads).
//   * Block route (d > 1024, up to 8192): one CTA a row, 8 values (two
//     int4) a thread: 512 threads at d = 4096, 480 at 3840.  At 4 rows the
//     launch is latency: fewer values a thread shorten each thread's
//     serial chain (16 a thread was slower at 4 and 128 rows and no faster
//     at 1024).  Sums by warp butterflies, then one __syncthreads and a
//     butterfly over the per-warp partials.
// The arithmetic is the reference's: int32 sums modulo 2^32 (associative,
// so no reduction order can change the bits), dyadic mean, y = q - mu,
// rshift_round by pre_shift, the sum of squares and dyadic variance, the
// integer sqrt, one reciprocal per row, then per element
// rshift_round(y * r, 2 * pre_shift) x gamma (+ beta), dyadic out, clamp.
// The sqrt is isqrt_fast: the IEEE float square root truncated, then the
// reference's clamp and +-1 corrections; it equals the reference's
// 16-step Newton sqrt (isqrt16, kept as its yardstick) on every int32,
// which r8_isqrt_check proves on the card.
#include "int_common.cuh"
#include "int_attrs.cuh"

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

namespace k2 {

// mirrored by kernels/int_layernorm.py
constexpr int MAX_D = 8192;
constexpr int WARP_MAX_D = 1024;
constexpr int WARP_THREADS = 256;          // 8 rows a CTA
constexpr int BLOCK_VPL = 8;
constexpr int BLOCK_MAX_THREADS = MAX_D / BLOCK_VPL;

// the CTAs an SM must hold on the warp route (its __launch_bounds__), by
// values a lane: WARP_CTAS_PER_SM in kernels/int_layernorm.py
__host__ __device__ constexpr int warp_ctas_per_sm(int vpl) {
  return vpl <= 8 ? 4 : vpl <= 12 ? 3 : vpl <= 24 ? 2 : 1;
}

// core.intmath.i_sqrt: floor(sqrt(n)) for n > 0, 0 for n <= 0, by the
// reference's 16 Newton steps (r8_isqrt_check's yardstick)
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

// the same integer in O(1): the correctly rounded float root of the
// correctly rounded float of n is within 1 of floor(sqrt(n)), and the
// reference's clamp and corrections take it the rest of the way
__device__ __forceinline__ int isqrt_fast(int n) {
  if (n <= 0) return 0;
  int x = (int)__fsqrt_rn(__int2float_rn(n));   // truncates
  x = min(x, 46340);
  for (int i = 0; i < 2; ++i)
    if (x * x > n) x -= 1;
  if (x < 46340 && (x + 1) * (x + 1) <= n) x += 1;
  return x;
}

__device__ __forceinline__ int warp_sum(int v) {
  unsigned u = (unsigned)v;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    u += __shfl_xor_sync(0xffffffffu, u, off);
  return (int)u;
}

struct WarpSum {
  __device__ __forceinline__ int operator()(int v, int) const {
    return warp_sum(v);
  }
};

// one row a CTA: slot 0 (the mean's sum) and slot 1 (the variance's) have
// their own partials, so each sum needs one __syncthreads
struct BlockSum {
  int* red;   // [2][BLOCK_MAX_THREADS / 32]
  __device__ __forceinline__ int operator()(int v, int slot) const {
    constexpr int W = BLOCK_MAX_THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) red[slot * W + warp] = v;
    __syncthreads();
    return warp_sum(lane < (int)(blockDim.x >> 5) ? red[slot * W + lane] : 0);
  }
};

template <int VEC>
__device__ __forceinline__ void load(const int* __restrict__ p, int* v) {
  if constexpr (VEC == 4) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(int* __restrict__ p, const int* v) {
  if constexpr (VEC == 4)
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// a thread's VPL values of one row (vectors past the row read as 0)
template <int VEC, int VPL>
__device__ __forceinline__ void load_slice(const int* __restrict__ src,
                                           int t, int stride, int nvec,
                                           int (&x)[VPL]) {
#pragma unroll
  for (int j = 0; j < VPL / VEC; ++j) {
    const int v = j * stride + t;
    if (v < nvec) {
      load<VEC>(src + v * VEC, &x[j * VEC]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) x[j * VEC + k] = 0;
    }
  }
}

template <int VEC, int VPL, bool MEAN, bool BETA, class Sum>
__device__ __forceinline__ void norm_row(const int* __restrict__ x_row,
                                         int* __restrict__ o_row, int t,
                                         int stride, int nvec,
                                         const int (&g)[VPL],
                                         const int (&b)[VPL],
                                         const NormConsts& p, Sum sum) {
  constexpr int N = VPL / VEC;
  int y[VPL];
  load_slice<VEC, VPL>(x_row, t, stride, nvec, y);
  if constexpr (MEAN) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < VPL; ++i) s = wadd(s, y[i]);
    const int mu = dyadic(sum(s, 0), p.mean_b, p.mean_c, p.mean_pre);
#pragma unroll
    for (int i = 0; i < VPL; ++i) y[i] = wsub(y[i], mu);
  }
  int ss = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j * stride + t < nvec) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int ys = rshift_round(y[j * VEC + k], p.pre_shift);
        ss = wadd(ss, wmul(ys, ys));
      }
    }
  }
  const int sigma = isqrt_fast(dyadic(sum(ss, 1), p.var_b, p.var_c,
                                      p.var_pre));
  // both operands positive: truncation == the reference's floor division.
  // sigma == 0 gives r = 0, so every n_q is 0, as the reference's select
  const int r = sigma == 0 ? 0 : (1 << (p.recip_bits + p.pre_shift)) / sigma;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int v = j * stride + t;
    if (v < nvec) {
      int o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int i = j * VEC + k;
        int w = wmul(rshift_round(wmul(y[i], r), 2 * p.pre_shift), g[i]);
        if constexpr (BETA) w = wadd(w, b[i]);
        o[k] = clampi(dyadic(w, p.out_b, p.out_c, p.out_pre), p.lo, p.hi);
      }
      store<VEC>(o_row + v * VEC, o);
    }
  }
}

template <bool WARP, int VEC, int VPL, bool MEAN, bool BETA>
__global__ void __launch_bounds__(WARP ? WARP_THREADS : BLOCK_MAX_THREADS,
                                  WARP ? warp_ctas_per_sm(VPL) : 1)
int_layernorm_kernel(const int* __restrict__ q, const int* __restrict__ gamma,
                     const int* __restrict__ beta, int* __restrict__ out,
                     int rows, NormConsts p) {
  const int nvec = p.d / VEC;
  int g[VPL], b[VPL];
  if constexpr (WARP) {
    constexpr int RPC = WARP_THREADS / 32;
    const int lane = threadIdx.x & 31;
    load_slice<VEC, VPL>(gamma, lane, 32, nvec, g);
    if constexpr (BETA) load_slice<VEC, VPL>(beta, lane, 32, nvec, b);
    // the loop bound is warp-uniform: every lane shuffles in every row
    for (long long row = (long long)blockIdx.x * RPC + (threadIdx.x >> 5);
         row < rows; row += (long long)gridDim.x * RPC)
      norm_row<VEC, VPL, MEAN, BETA>(q + row * p.d, out + row * p.d, lane,
                                     32, nvec, g, b, p, WarpSum{});
  } else {
    __shared__ int red[2 * BLOCK_MAX_THREADS / 32];
    const long long row = blockIdx.x;
    load_slice<VEC, VPL>(gamma, threadIdx.x, blockDim.x, nvec, g);
    if constexpr (BETA)
      load_slice<VEC, VPL>(beta, threadIdx.x, blockDim.x, nvec, b);
    norm_row<VEC, VPL, MEAN, BETA>(q + row * p.d, out + row * p.d,
                                   threadIdx.x, blockDim.x, nvec, g, b, p,
                                   BlockSum{red});
  }
}

template <bool WARP, int VEC, int VPL>
int launch(const int* q, const int* gamma, const int* beta, int* out,
           int rows, const NormConsts& p, int threads, int grid,
           cudaStream_t s) {
  if (p.subtract_mean) {
    if (beta)
      int_layernorm_kernel<WARP, VEC, VPL, true, true>
          <<<grid, threads, 0, s>>>(q, gamma, beta, out, rows, p);
    else
      int_layernorm_kernel<WARP, VEC, VPL, true, false>
          <<<grid, threads, 0, s>>>(q, gamma, beta, out, rows, p);
  } else {
    if (beta)
      int_layernorm_kernel<WARP, VEC, VPL, false, true>
          <<<grid, threads, 0, s>>>(q, gamma, beta, out, rows, p);
    else
      int_layernorm_kernel<WARP, VEC, VPL, false, false>
          <<<grid, threads, 0, s>>>(q, gamma, beta, out, rows, p);
  }
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_warp(const int* q, const int* gamma, const int* beta, int* out,
                int rows, const NormConsts& p, int vpl, int grid,
                cudaStream_t s) {
  switch (vpl) {
    case 4:
      return launch<true, VEC, 4>(q, gamma, beta, out, rows, p,
                                  WARP_THREADS, grid, s);
    case 8:
      return launch<true, VEC, 8>(q, gamma, beta, out, rows, p,
                                  WARP_THREADS, grid, s);
    case 12:
      return launch<true, VEC, 12>(q, gamma, beta, out, rows, p,
                                   WARP_THREADS, grid, s);
    case 16:
      return launch<true, VEC, 16>(q, gamma, beta, out, rows, p,
                                   WARP_THREADS, grid, s);
    case 24:
      return launch<true, VEC, 24>(q, gamma, beta, out, rows, p,
                                   WARP_THREADS, grid, s);
    case 32:
      return launch<true, VEC, 32>(q, gamma, beta, out, rows, p,
                                   WARP_THREADS, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// every n in [-1, 2^31): *bad (zeroed by the caller) counts the n where
// isqrt_fast and isqrt16 differ
__global__ void isqrt_check_kernel(int* bad) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  int mine = 0;
  for (long long n = -1 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       n <= 0x7fffffffLL; n += stride)
    mine += isqrt_fast((int)n) != isqrt16((int)n);
  if (mine) atomicAdd(bad, mine);
}

__global__ void empty_kernel() {}

}  // namespace k2
}  // namespace r8

// The launch must be kernels/int_layernorm.py::launch_plan's for the
// shape and the operands' alignment: warp (route 1) or block (route 0),
// VEC 4 or 1, VPL values a thread, the CTA size and the grid.
extern "C" int r8_int_layernorm(const void* q, const void* gamma,
                                const void* beta, const r8::NormConsts* p,
                                void* out, int rows, int warp_route, int vec,
                                int vpl, int threads, int grid,
                                void* stream) {
  using namespace r8::k2;
  const int d = p->d;
  const uintptr_t any = (uintptr_t)q | (uintptr_t)gamma | (uintptr_t)beta |
                        (uintptr_t)out;
  if (!q || !gamma || !out || rows <= 0 || d <= 0 || d > MAX_D ||
      (vec != 1 && vec != 4) || (vec == 4 && (d % 4 || any % 16)) ||
      vpl % vec || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const int nvec = d / vec;
  if (warp_route) {
    if (d > WARP_MAX_D || threads != WARP_THREADS || 32 * (vpl / vec) < nvec)
      return (int)cudaErrorInvalidValue;
  } else if (d <= WARP_MAX_D || vpl != BLOCK_VPL || threads % 32 ||
             threads > BLOCK_MAX_THREADS || threads * (vpl / vec) < nvec ||
             grid != rows) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* qi = (const int*)q;
  const int* gi = (const int*)gamma;
  const int* bi = (const int*)beta;
  int* oi = (int*)out;
  if (warp_route)
    return vec == 4 ? launch_warp<4>(qi, gi, bi, oi, rows, *p, vpl, grid, s)
                    : launch_warp<1>(qi, gi, bi, oi, rows, *p, vpl, grid, s);
  return vec == 4 ? launch<false, 4, BLOCK_VPL>(qi, gi, bi, oi, rows, *p,
                                                threads, grid, s)
                  : launch<false, 1, BLOCK_VPL>(qi, gi, bi, oi, rows, *p,
                                                threads, grid, s);
}

// isqrt_fast against isqrt16 on every n in [-1, 2^31); *bad zeroed by the
// caller
extern "C" int r8_isqrt_check(int* bad, int blocks, void* stream) {
  if (!bad || blocks <= 0) return (int)cudaErrorInvalidValue;
  r8::k2::isqrt_check_kernel<<<blocks, 256, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(bad);
  return (int)cudaGetLastError();
}

// an empty launch: the floor of a latency-bound launch on this card
extern "C" int r8_empty_kernel(void* stream) {
  r8::k2::empty_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

namespace r8 {
namespace k2 {

template <bool WARP, int VEC, int VPL>
int attrs_mb(int mean, int beta, int threads, int* out) {
  if (mean)
    return beta ? attrs(int_layernorm_kernel<WARP, VEC, VPL, true, true>,
                        threads, 0, 1, 1, out)
                : attrs(int_layernorm_kernel<WARP, VEC, VPL, true, false>,
                        threads, 0, 1, 1, out);
  return beta ? attrs(int_layernorm_kernel<WARP, VEC, VPL, false, true>,
                      threads, 0, 1, 1, out)
              : attrs(int_layernorm_kernel<WARP, VEC, VPL, false, false>,
                      threads, 0, 1, 1, out);
}

template <int VEC>
int attrs_warp(int vpl, int mean, int beta, int threads, int* out) {
  switch (vpl) {
    case 4: return attrs_mb<true, VEC, 4>(mean, beta, threads, out);
    case 8: return attrs_mb<true, VEC, 8>(mean, beta, threads, out);
    case 12: return attrs_mb<true, VEC, 12>(mean, beta, threads, out);
    case 16: return attrs_mb<true, VEC, 16>(mean, beta, threads, out);
    case 24: return attrs_mb<true, VEC, 24>(mean, beta, threads, out);
    case 32: return attrs_mb<true, VEC, 32>(mean, beta, threads, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace k2
}  // namespace r8

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: warp route, VEC, VPL, MEAN, BETA);
// out[6]
extern "C" int r8_attrs_int_layernorm(const int* sel, int threads, int smem,
                                      int cluster, int* out) {
  using namespace r8::k2;
  const int warp = sel[0], vec = sel[1], vpl = sel[2], mean = sel[3],
            beta = sel[4];
  if (smem != 0 || cluster != 1 || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  if (warp)
    return vec == 4 ? attrs_warp<4>(vpl, mean, beta, threads, out)
                    : attrs_warp<1>(vpl, mean, beta, threads, out);
  if (vpl != BLOCK_VPL) return (int)cudaErrorInvalidValue;
  return vec == 4 ? attrs_mb<false, 4, BLOCK_VPL>(mean, beta, threads, out)
                  : attrs_mb<false, 1, BLOCK_VPL>(mean, beta, threads, out);
}
