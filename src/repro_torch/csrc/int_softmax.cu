// K7: integer-only softmax, "Shiftmax" (SwiftTron §III-F), bit-exact.
//
// Replaces the TPU kernel repro/kernels/int_softmax.py::int_softmax_pallas
// (body _softmax_kernel).
//
// What bounds it on the H100: device-memory bytes.  Each int32 score is
// read once and each int8 probability written once (5 bytes) against
// about 25 integer operations; on RoBERTa-base's full score matrix
// (32 x 12 x 512 rows of 512) that is 503 MB, 150 us at 3.35 TB/s.
//
// Design: the ASIC's row-parallel Softmax units become one warp per row.
// Rows up to 1024 long stay in registers (VPT values per lane, loaded
// with neighbouring lanes on neighbouring words), so the three phases of
// the row -- masked max, i-exp with an exact int32 sum, one reciprocal
// 2^30 // s and the int8 probabilities -- read the scores from device
// memory once.  Longer rows (up to the 2^15 row-sum budget, which the
// wrapper enforces) take one 256-thread block per row and three passes
// over the row, which the L1/L2 caches serve after the first.  Integer
// max and modular int32 sums are associative, so the warp and block
// reductions give the reference's bits in any order.  Positions at or
// beyond valid_len count -2^30 in the max and 0 in the sum, exactly as
// the TPU kernel's static padding mask.
#include "int_common.cuh"

namespace r8 {

constexpr int SM_NEG = -(1 << 30);
constexpr int SM_BLOCK = 256;       // threads of the long-row kernel

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

// p = clip(rshift_round(e16 * (2^30 // s), 23), 0, 127): e16 <= s, so the
// product stays below 2^30
__device__ __forceinline__ int8_t prob8(int e16, int recip) {
  return (int8_t)clampi(rshift_round(wmul(e16, recip), 23), 0, 127);
}

// s >= 0 (a sum of non-negative e16, < 2^30 for rows <= 2^15): truncation
// == the reference's floor division
__device__ __forceinline__ int recip30(int s) { return (1 << 30) / max(s, 1); }

// one warp per row, the row in registers: VPT * 32 >= L
template <int VPT>
__global__ void __launch_bounds__(512)
int_softmax_warp_kernel(const int* __restrict__ x, int8_t* __restrict__ out,
                        long long rows, int L, int vl, SoftmaxConsts p) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int* xr = x + row * L;
  int v[VPT];
  int m = SM_NEG;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < vl ? xr[j] : SM_NEG;
    m = max(m, v[k]);
  }
  m = warp_max(m);
  int s = 0;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = lane + 32 * k;
    v[k] = j < vl ? exp16(wsub(v[k], m), p) : 0;
    s = wadd(s, v[k]);
  }
  const int r = recip30(warp_sum(s));
  int8_t* orow = out + row * L;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = lane + 32 * k;
    if (j < L) orow[j] = prob8(v[k], r);
  }
}

// block-wide reduction of one value per thread (all threads must call)
template <bool MAX>
__device__ __forceinline__ int block_reduce(int v, int* scratch) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                       // scratch free from a prior use
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = MAX ? SM_NEG : 0;
  for (int w = 0; w < SM_BLOCK / 32; ++w)
    v = MAX ? max(v, scratch[w]) : wadd(v, scratch[w]);
  return v;
}

// one block per row, three passes over the row
__global__ void __launch_bounds__(SM_BLOCK)
int_softmax_block_kernel(const int* __restrict__ x, int8_t* __restrict__ out,
                         int L, int vl, SoftmaxConsts p) {
  __shared__ int scratch[SM_BLOCK / 32];
  const long long row = blockIdx.x;
  const int* xr = x + row * L;
  int m = SM_NEG;
  for (int j = threadIdx.x; j < vl; j += SM_BLOCK) m = max(m, xr[j]);
  m = block_reduce<true>(m, scratch);
  int s = 0;
  for (int j = threadIdx.x; j < vl; j += SM_BLOCK)
    s = wadd(s, exp16(wsub(xr[j], m), p));
  const int r = recip30(block_reduce<false>(s, scratch));
  int8_t* orow = out + row * L;
  for (int j = threadIdx.x; j < L; j += SM_BLOCK)
    orow[j] = prob8(j < vl ? exp16(wsub(xr[j], m), p) : 0, r);
}

template <int VPT>
inline void launch_warp_rows(const int* x, int8_t* out, long long rows,
                             int L, int vl, int rows_per_block,
                             const SoftmaxConsts& p, cudaStream_t s) {
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  int_softmax_warp_kernel<VPT><<<(unsigned)blocks, 32 * rows_per_block, 0,
                                 s>>>(x, out, rows, L, vl, p);
}

}  // namespace r8

// scores (rows, L) int32 -> probabilities (rows, L) int8.  valid_len < 0:
// no mask.  rows_per_block: rows of a block on the register path (1..16).
extern "C" int r8_int_softmax(const void* scores, void* out, long long rows,
                              int L, int valid_len, int rows_per_block,
                              const r8::SoftmaxConsts* p, void* stream) {
  if (rows <= 0 || L <= 0 || L > (1 << 15) || rows_per_block < 1 ||
      rows_per_block > 16 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* x = static_cast<const int*>(scores);
  int8_t* o = static_cast<int8_t*>(out);
  const int vl = valid_len < 0 ? L : min(valid_len, L);
  if (L <= 32)
    r8::launch_warp_rows<1>(x, o, rows, L, vl, rows_per_block, *p, s);
  else if (L <= 64)
    r8::launch_warp_rows<2>(x, o, rows, L, vl, rows_per_block, *p, s);
  else if (L <= 128)
    r8::launch_warp_rows<4>(x, o, rows, L, vl, rows_per_block, *p, s);
  else if (L <= 256)
    r8::launch_warp_rows<8>(x, o, rows, L, vl, rows_per_block, *p, s);
  else if (L <= 512)
    r8::launch_warp_rows<16>(x, o, rows, L, vl, rows_per_block, *p, s);
  else if (L <= 1024)
    r8::launch_warp_rows<32>(x, o, rows, L, vl, rows_per_block, *p, s);
  else
    r8::int_softmax_block_kernel<<<(unsigned)rows, r8::SM_BLOCK, 0, s>>>(
        x, o, L, vl, *p);
  return (int)cudaGetLastError();
}
