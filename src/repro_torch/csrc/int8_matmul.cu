// K1: int8 x int8 -> int32 GEMM with the fused requant epilogue.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul_pallas
// (body _mm_kernel, epilogue _requant_tile).
//
// What bounds it on the H100: on the serving main path M is tiny (decode
// M = batch = 4 rows; a prefill chunk M = 128), so every launch streams a
// whole (K, N) int8 weight matrix for a handful of output rows — it is
// bound by device-memory bytes (e.g. w1: 58.7 MB, 17.5 us at 3.35 TB/s),
// not by int8 operations.
//
// Design: a tiled __dp4a GEMM.  Each block owns a BM x BN output tile and
// walks K in BK steps through shared memory.  Weight rows (K, N) are read
// as 4-byte words along N (coalesced), four K rows at a time, and
// transposed in registers with __byte_perm into "4 K values of one column"
// packs so one __dp4a does four multiply-adds.  Because the weight matrix
// dominates the traffic and a decode GEMM has few output tiles, K is split
// across blocks (grid.z) until the grid covers the SMs about twice: each
// split adds its partial tile into an int32 workspace with atomicAdd and
// the last split to arrive (a per-tile counter) runs the epilogue on the
// full sum.  Integer addition modulo 2^32 is associative and commutative,
// so the result does not depend on the arrival order and is bit-exact.
// Ragged M, N and K are masked inside the kernel (zero-filled loads,
// guarded stores); no divisibility is assumed.
//
// Epilogue (exactly _requant_tile): acc + bias, then raw int32 out, or the
// two-stage round-half-up dyadic (per-tensor b, or per-channel b_vec[n]
// with shared c, pre), clipped to out_bits, stored as int8 or int32.
#include "int_common.cuh"

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

// four w[k][n..n+3] bytes as one word, zero past kend / N
__device__ __forceinline__ int load_w_word(const int8_t* __restrict__ w,
                                           int N, int kend, int k, int n,
                                           bool vec) {
  if (k >= kend || n >= N) return 0;
  const int8_t* p = w + (size_t)k * N + n;
  if (vec && n + 3 < N) return *reinterpret_cast<const int*>(p);
  int v = 0;
  for (int j = 0; j < 4; ++j)
    if (n + j < N) v |= ((int)(uint8_t)p[j]) << (8 * j);
  return v;
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
int8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const int* __restrict__ bias,
                   const int* __restrict__ bvec, Requant rq,
                   void* __restrict__ out, int out_is_int8, int M, int N,
                   int K, int k_per_split, int* __restrict__ ws,
                   int* __restrict__ tile_count, int vec_x, int vec_w) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int BK4 = BK / 4;
  __shared__ int sx[BM][BK4 + 1];
  __shared__ __align__(16) int sw[BK4][BN];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int i = tid; i < BM * BK4; i += NT) {
      const int r = i / BK4, kk = i % BK4;
      sx[r][kk] = load_x_pack(x, M, K, kend, m0 + r, k0 + 4 * kk, vec_x);
    }
    for (int i = tid; i < BK4 * (BN / 4); i += NT) {
      const int kk = i / (BN / 4), nn = i % (BN / 4);
      const int k = k0 + 4 * kk, n = n0 + 4 * nn;
      const int r0 = load_w_word(w, N, kend, k + 0, n, vec_w);
      const int r1 = load_w_word(w, N, kend, k + 1, n, vec_w);
      const int r2 = load_w_word(w, N, kend, k + 2, n, vec_w);
      const int r3 = load_w_word(w, N, kend, k + 3, n, vec_w);
      // 4x4 byte transpose: column j's pack holds w[k+0..3][n+j]
      const int lo01 = __byte_perm(r0, r1, 0x5140);
      const int lo23 = __byte_perm(r2, r3, 0x5140);
      const int hi01 = __byte_perm(r0, r1, 0x7362);
      const int hi23 = __byte_perm(r2, r3, 0x7362);
      sw[kk][4 * nn + 0] = __byte_perm(lo01, lo23, 0x5410);
      sw[kk][4 * nn + 1] = __byte_perm(lo01, lo23, 0x7632);
      sw[kk][4 * nn + 2] = __byte_perm(hi01, hi23, 0x5410);
      sw[kk][4 * nn + 3] = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK4; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sx[ty + i * (BM / TM)][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sw[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (gridDim.z > 1) {
    // split-K: add this split's partial tile, the last split finishes
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * (BM / TM);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (m < M && n < N) atomicAdd(&ws[(size_t)m * N + n], acc[i][j]);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      is_last = atomicAdd(&tile_count[tile], 1) == (int)gridDim.z - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * (BM / TM);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (m < M && n < N) acc[i][j] = __ldcg(&ws[(size_t)m * N + n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      int v = acc[i][j];
      if (bias != nullptr) v = wadd(v, bias[n]);
      if (rq.kind != RQ_RAW) {
        const int b = rq.kind == RQ_PER_CHANNEL ? bvec[n] : rq.b;
        v = requant(v, rq, b);
      }
      const size_t o = (size_t)m * N + n;
      if (out_is_int8)
        reinterpret_cast<int8_t*>(out)[o] = (int8_t)v;
      else
        reinterpret_cast<int*>(out)[o] = v;
    }
  }
}

}  // namespace r8

// Small-M tile (decode: M = batch) and large-M tile (prefill chunks).
#define R8_SMALL 4, 256, 64, 1, 4
#define R8_LARGE 64, 64, 64, 4, 4

extern "C" int r8_int8_matmul(const void* x, const void* w, const void* bias,
                              const void* bvec, const r8::Requant* rq,
                              void* out, int out_is_int8, int M, int N,
                              int K, int large, int splits,
                              int k_per_split, void* ws, void* tile_count,
                              int vec_x, int vec_w, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int bm = large ? 64 : 4;
  const int bn = large ? 64 : 256;
  dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm, splits);
  if (large) {
    r8::int8_matmul_kernel<R8_LARGE><<<grid, 256, 0, s>>>(
        (const int8_t*)x, (const int8_t*)w, (const int*)bias,
        (const int*)bvec, *rq, out, out_is_int8, M, N, K, k_per_split,
        (int*)ws, (int*)tile_count, vec_x, vec_w);
  } else {
    r8::int8_matmul_kernel<R8_SMALL><<<grid, 256, 0, s>>>(
        (const int8_t*)x, (const int8_t*)w, (const int*)bias,
        (const int*)bvec, *rq, out, out_is_int8, M, N, K, k_per_split,
        (int*)ws, (int*)tile_count, vec_x, vec_w);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* r8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
