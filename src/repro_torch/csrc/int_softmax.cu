// K7: integer-only softmax, "Shiftmax" (SwiftTron §III-F), bit-exact.
//
// Replaces the TPU kernel repro/kernels/int_softmax.py::int_softmax_pallas
// (body _softmax_kernel).
//
// What bounds it on the H100: device-memory bytes.  Each int32 score is
// read once and each int8 probability written once (5 bytes); on
// RoBERTa-base's full score matrix (32 x 12 x 512 rows of 512) that is
// 503 MB, 150 us at 3.35 TB/s.  The arithmetic comes close: the warp
// route's SASS runs ~13 IMADs (the FMA pipe) and ~19 other integer
// instructions (the ALU pipe, half the issue rate) an element, some
// 0.12 ms over 100.7 M elements, so every instruction an element counts.
//
// What the first design lost, at 45 % of the byte bound: exp16 divided
// by the run-time q_ln2 (a multi-instruction division sequence an
// element) and ran four rshift_rounds that branch on run-time shift
// counts; `j < vl ? exp16 : 0` compiled to a branch around each element;
// a lane loaded one int and stored one byte at a time (a warp's store was
// 32 bytes); rows past 1024 took three passes over the row and two exp16
// an element.
//
// Design.  A thread owns the same vectors of a row: its vector j is the
// row's vector j * stride + t, VEC ints wide (an int4, one 16-byte load,
// and 4 packed int8, one 4-byte store, when L % 4 == 0 and both pointers
// are 16-byte aligned; else one int and one byte).  The values a thread
// holds are a template argument (VPT), so every loop unrolls and the row
// stays in registers: read once, written once, exp16 once an element, no
// local memory.  Loads and stores carry the streaming hint (ld.global.cs /
// st.global.cs): each byte is touched once and the matrix is 10x the L2.
//   * Warp route (L <= 1024): a warp a row, 1..16 rows a CTA (block_rows),
//     the max and the sum by __shfl_xor_sync butterflies.
//   * Block route (1024 < L <= 2^15, the row-sum budget the wrapper
//     enforces): a CTA a row, VPT 8 or 16 values a thread on up to 1024
//     threads, or 32 on exactly 1024 (a constant stride keeps that
//     instantiation inside the 64 registers a thread of 1024 may have);
//     warp butterflies, then one __syncthreads and a butterfly over the
//     per-warp partials, for the max and for the sum.
//   * exp16 is int_common.cuh's exp16_mma: the dyadic shifts resolved per
//     launch into a multiply, a rounding add and a shift, the division a
//     multiply-high.  Every plan core.intmath.make_iexp builds has one
//     (q_ln2 >= 16 and z_max * q_ln2 < 2^31: the largest shift whose
//     magic fits 32 bits is exact on the whole domain), as K3, K4, K5 and
//     K8 rely on; the host refuses any other plan.
//   * exp16 runs for every position of a vector, then a select: no
//     branch an element.  A row without a mask (valid_len >= L) takes a
//     path with no per-element predicate; with one, positions >=
//     valid_len count -2^30 in the max and 0 in the sum (the TPU kernel's
//     static padding mask), and vectors wholly past valid_len are neither
//     read nor given an exp16.
// The rest is the reference's: the row sum modulo 2^32 (integer max and
// modular sums are associative, so no reduction order changes the bits),
// one reciprocal 2^30 // max(s, 1) a row, and
// clip(rshift_round(e16 * r, 23), 0, 127) an element.
#include "int_common.cuh"
#include "int_attrs.cuh"

namespace r8 {
namespace k7 {

// mirrored by kernels/int_softmax.py
constexpr int MAX_L = 1 << 15;
constexpr int WARP_MAX_L = 1024;
constexpr int MAX_BLOCK_ROWS = 16;
constexpr int BLOCK_MAX_THREADS = 1024;
constexpr int WARP_VPT[] = {1, 2, 4, 8, 16, 32};
constexpr int BLOCK_VPT[] = {8, 16, 32};
constexpr int BLOCK_FULL_VPT = 32;      // always BLOCK_MAX_THREADS threads

constexpr int NEG = -(1 << 30);

// p = clip(rshift_round(e16 * (2^30 // s), 23), 0, 127): e16 <= s, so the
// product stays below 2^30
__device__ __forceinline__ int prob8(int e16, int recip) {
  return clampi(rshift_round(wmul(e16, recip), 23), 0, 127);
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = wadd(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

struct WarpRed {
  __device__ __forceinline__ int max(int v) const { return warp_max(v); }
  __device__ __forceinline__ int sum(int v) const { return warp_sum(v); }
};

// one row a CTA: the max and the sum have their own slots of per-warp
// partials, so each needs one __syncthreads
struct BlockRed {
  int* red;   // [2][32]
  __device__ __forceinline__ int max(int v) const {
    const int lane = threadIdx.x & 31;
    v = warp_max(v);
    if (lane == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    return warp_max(lane < (int)(blockDim.x >> 5) ? red[lane] : NEG);
  }
  __device__ __forceinline__ int sum(int v) const {
    const int lane = threadIdx.x & 31;
    v = warp_sum(v);
    if (lane == 0) red[32 + (threadIdx.x >> 5)] = v;
    __syncthreads();
    return warp_sum(lane < (int)(blockDim.x >> 5) ? red[32 + lane] : 0);
  }
};

template <int VEC>
__device__ __forceinline__ void load(const int* __restrict__ p, int* v) {
  if constexpr (VEC == 4) {
    const int4 t = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldcs(p);
  }
}

// probabilities in [0, 127]: four bytes packed by byte permutes
template <int VEC>
__device__ __forceinline__ void store(int8_t* __restrict__ p, const int* q) {
  if constexpr (VEC == 4) {
    const unsigned lo = __byte_perm(q[0], q[1], 0x0040);
    const unsigned hi = __byte_perm(q[2], q[3], 0x0040);
    __stcs(reinterpret_cast<int*>(p), (int)__byte_perm(lo, hi, 0x5410));
  } else {
    __stcs(reinterpret_cast<signed char*>(p), (signed char)q[0]);
  }
}

// One row of L = nvec * VEC scores (vl of them live) by the thread that
// owns vectors j * stride + t, j < VPT / VEC.  MASK false: vl == L, so a
// vector is live iff it lies in the row, and no element needs a predicate
// (on the H100 the masked body run at vl == L takes 2.7 % longer on
// 196 608 rows of 512, 1.5x on 256 of 1024, 1.2x on 4 of 2^15).
// Which vectors lie in the row (j < n_in) and which hold a live position
// (j < n_read) are two counts, so no per-vector offset or predicate stays
// live across the reductions; with a constant stride (the warp route's
// 32, the block route's 1024 at VPT 32) every offset is an immediate.
template <int VEC, int VPT, bool MASK, class Red>
__device__ __forceinline__ void softmax_row(const int* __restrict__ xr,
                                            int8_t* __restrict__ orow,
                                            int t, int stride, int nvec,
                                            int vl, const tc::Exp16& p,
                                            Red red) {
  constexpr int NV = VPT / VEC;
  const int n_in = t < nvec ? (nvec - 1 - t) / stride + 1 : 0;
  const int nlive = MASK ? (vl + VEC - 1) / VEC : nvec;
  const int n_read = t < nlive ? (nlive - 1 - t) / stride + 1 : 0;
  const int lim = vl - t * VEC;       // column c live iff c - t * VEC < lim
  const int* __restrict__ xt = xr + t * VEC;
  int v[VPT];
  int m = NEG;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j < n_read) {
      load<VEC>(xt + j * stride * VEC, &v[j * VEC]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[j * VEC + k] = NEG;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if constexpr (MASK) {
        if (j * stride * VEC + k >= lim) v[j * VEC + k] = NEG;
      }
      m = max(m, v[j * VEC + k]);
    }
  }
  m = red.max(m);
  int s = 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (MASK && j >= n_read) {          // no live position: no exp16
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[j * VEC + k] = 0;
      continue;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const bool live = MASK ? j * stride * VEC + k < lim : j < n_in;
      const int i = j * VEC + k;
      // exp16 for every position, then a select: written `live ? exp16
      // : 0` it compiles to a branch around each element
      const int e = tc::exp16_mma(wsub(v[i], m), p);
      v[i] = live ? e : 0;
      s = wadd(s, v[i]);
    }
  }
  // s >= 0 (non-negative e16, < 2^31 for rows <= 2^15): truncation == the
  // reference's floor division
  const int r = (1 << 30) / max(red.sum(s), 1);
  int8_t* __restrict__ ot = orow + t * VEC;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j < n_in) {
      int q[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) q[k] = prob8(v[j * VEC + k], r);
      store<VEC>(ot + j * stride * VEC, q);
    }
  }
}

// Block route: VPT 32 (rows past 16 384 vectors' worth of 16 values) runs
// on all BLOCK_MAX_THREADS threads, so its stride is a constant; VPT 8
// and 16 stride by the CTA's size.
template <bool WARP, int VEC, int VPT>
__global__ void __launch_bounds__(WARP ? 32 * MAX_BLOCK_ROWS
                                       : BLOCK_MAX_THREADS)
int_softmax_kernel(const int* __restrict__ x, int8_t* __restrict__ out,
                   long long rows, int L, int vl, tc::Exp16 p) {
  const int nvec = L / VEC;
  if constexpr (WARP) {
    const long long row =
        (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= rows) return;     // warp-uniform: every lane shuffles
    const int lane = threadIdx.x & 31;
    if (vl < L)
      softmax_row<VEC, VPT, true>(x + row * L, out + row * L, lane, 32,
                                  nvec, vl, p, WarpRed{});
    else
      softmax_row<VEC, VPT, false>(x + row * L, out + row * L, lane, 32,
                                   nvec, vl, p, WarpRed{});
  } else {
    __shared__ int red[64];
    const long long row = blockIdx.x;
    const int stride =
        VPT == BLOCK_FULL_VPT ? BLOCK_MAX_THREADS : (int)blockDim.x;
    if (vl < L)
      softmax_row<VEC, VPT, true>(x + row * L, out + row * L, threadIdx.x,
                                  stride, nvec, vl, p, BlockRed{red});
    else
      softmax_row<VEC, VPT, false>(x + row * L, out + row * L, threadIdx.x,
                                   stride, nvec, vl, p, BlockRed{red});
  }
}

template <bool WARP, int VEC, int VPT>
int launch(const int* x, int8_t* out, long long rows, int L, int vl,
           int threads, long long grid, const tc::Exp16& p, cudaStream_t s) {
  int_softmax_kernel<WARP, VEC, VPT>
      <<<(unsigned)grid, threads, 0, s>>>(x, out, rows, L, vl, p);
  return (int)cudaGetLastError();
}

// the instantiations: WARP_VPT on the warp route (VPT >= VEC), BLOCK_VPT
// on the block route; a: launch's arguments
template <bool WARP, int VEC, class... A>
int launch_vpt(int vpt, A... a) {
  switch (vpt) {
    case 1:
      if constexpr (WARP && VEC == 1) return launch<WARP, VEC, 1>(a...);
      break;
    case 2:
      if constexpr (WARP && VEC == 1) return launch<WARP, VEC, 2>(a...);
      break;
    case 4:
      if constexpr (WARP) return launch<WARP, VEC, 4>(a...);
      break;
    case 8:
      return launch<WARP, VEC, 8>(a...);
    case 16:
      return launch<WARP, VEC, 16>(a...);
    case 32:
      return launch<WARP, VEC, 32>(a...);
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <int N>
constexpr bool listed(const int (&vpts)[N], int vpt) {
  for (int v : vpts)
    if (v == vpt) return true;
  return false;
}

}  // namespace k7
}  // namespace r8

// scores (rows, L) int32 -> probabilities (rows, L) int8, positions >= vl
// (0 <= vl <= L) masked.  The launch must be kernels/int_softmax.py::
// launch_plan's for the shape and the pointers' alignment: warp (route 1)
// or block (route 0), VEC 4 or 1, VPT values a thread, the CTA size and
// the grid; ex: exp16's constants, its division a multiply-high.
extern "C" int r8_int_softmax(const void* scores, void* out, long long rows,
                              int L, int vl, int warp_route, int vec,
                              int vpt, int threads, long long grid,
                              const r8::tc::Exp16* ex, void* stream) {
  using namespace r8::k7;
  const uintptr_t any = (uintptr_t)scores | (uintptr_t)out;
  if (!scores || !out || !ex || rows <= 0 || rows > 0x7fffffffLL ||
      L <= 0 || L > MAX_L || vl < 0 || vl > L || (vec != 1 && vec != 4) ||
      (vec == 4 && (L % 4 || any % 16)) || vpt % vec || threads % 32 ||
      threads <= 0 || ex->magic == 0 || ex->q_ln2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int nvec = L / vec;
  if (warp_route) {
    if (L > WARP_MAX_L || !listed(WARP_VPT, vpt) ||
        threads > 32 * MAX_BLOCK_ROWS || 32 * (vpt / vec) < nvec ||
        grid != (rows + threads / 32 - 1) / (threads / 32))
      return (int)cudaErrorInvalidValue;
  } else if (L <= WARP_MAX_L || !listed(BLOCK_VPT, vpt) ||
             threads > BLOCK_MAX_THREADS || threads * (vpt / vec) < nvec ||
             (vpt == BLOCK_FULL_VPT && threads != BLOCK_MAX_THREADS) ||
             grid != rows) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* x = static_cast<const int*>(scores);
  int8_t* o = static_cast<int8_t*>(out);
  if (warp_route)
    return vec == 4
               ? launch_vpt<true, 4>(vpt, x, o, rows, L, vl, threads, grid,
                                     *ex, s)
               : launch_vpt<true, 1>(vpt, x, o, rows, L, vl, threads, grid,
                                     *ex, s);
  return vec == 4
             ? launch_vpt<false, 4>(vpt, x, o, rows, L, vl, threads, grid,
                                    *ex, s)
             : launch_vpt<false, 1>(vpt, x, o, rows, L, vl, threads, grid,
                                    *ex, s);
}

namespace r8 {
namespace k7 {

// the instantiations of launch_vpt
template <bool WARP, int VEC>
int attrs_vpt(int vpt, int threads, int* out) {
  switch (vpt) {
    case 1:
      if constexpr (WARP && VEC == 1)
        return attrs(int_softmax_kernel<WARP, VEC, 1>, threads, 0, 1, 1, out);
      break;
    case 2:
      if constexpr (WARP && VEC == 1)
        return attrs(int_softmax_kernel<WARP, VEC, 2>, threads, 0, 1, 1, out);
      break;
    case 4:
      if constexpr (WARP)
        return attrs(int_softmax_kernel<WARP, VEC, 4>, threads, 0, 1, 1, out);
      break;
    case 8:
      return attrs(int_softmax_kernel<WARP, VEC, 8>, threads, 0, 1, 1, out);
    case 16:
      return attrs(int_softmax_kernel<WARP, VEC, 16>, threads, 0, 1, 1, out);
    case 32:
      return attrs(int_softmax_kernel<WARP, VEC, 32>, threads, 0, 1, 1, out);
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace k7
}  // namespace r8

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: warp route, VEC, VPT); out[6]
extern "C" int r8_attrs_int_softmax(const int* sel, int threads, int smem,
                                    int cluster, int* out) {
  using namespace r8::k7;
  if (smem != 0 || cluster != 1 || (sel[1] != 1 && sel[1] != 4))
    return (int)cudaErrorInvalidValue;
  if (sel[0])
    return sel[1] == 4 ? attrs_vpt<true, 4>(sel[2], threads, out)
                       : attrs_vpt<true, 1>(sel[2], threads, out);
  return sel[1] == 4 ? attrs_vpt<false, 4>(sel[2], threads, out)
                     : attrs_vpt<false, 1>(sel[2], threads, out);
}
