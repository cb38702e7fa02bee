// MSR-4 outlier correction with the staged requant epilogue: the second
// launch of K1 over MSR-4 weights.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul_pallas
// with packed=True over MSR-4 weights, together with K1's nibble launch
// (csrc/int8_matmul.cu): the msr4 branch of repro/ops/backends/
// pallas_fused.py::PallasFusedBackend.int8_matmul_packed (lines 118-134)
// runs a raw packed launch of that kernel, then adds
// repro/ops/packed.py::msr4_correction (x @ scatter(out_val), as plain
// array code that materializes an (M, K/g, n_out, N) int32 gather: ~30 GB
// for llama3-8b's w1 in a 128-row chunk), then the bias, then
// apply_dyadic / apply_dyadic_perchannel and clip_to_bits.  Here one
// kernel does all of it on the raw accumulator of K1's packed launch
// (csrc/int8_matmul.cu, PACKED, raw, no bias):
//
//   out[m][n] = epilogue(acc[m][n] + sum_grp sum_l
//                 x[m][grp * g + idx[grp][l][n]] * val[grp][l][n] + bias[n])
//
// Every sum wraps modulo 2^32 as JAX's int32 does; integer addition is
// associative, so the two launches give the dense product's integers.
//
// What bounds it: the lanes, 3 bytes (int16 index, int8 delta) per (group,
// lane, column), each read once; with per-channel abs-max int8 weights
// ~82 % of them are outliers, so n_out = g and the lanes are 3x the int8
// weight bytes (w1: 176 MB, 53 us at 3.35 TB/s).  Past a few rows the
// gathered multiply-adds bound it instead (M x lanes of them, on the CUDA
// cores).  Design, simple first: a block of 128 threads owns 128 columns
// (the lane loads coalesce along N) and MT rows (4 for decode, else 16),
// so a lane read from memory serves MT rows; it stages x of those rows for
// a run of whole groups in shared memory, transposed ([row][MT] bytes), so
// one 4- or 16-byte load fetches a gathered row's x for all MT rows.
// Where the output tiles cannot fill the card (decode), the K groups are
// split across blocks (grid.z): each split adds its partial sums into a
// zeroed int32 workspace with atomicAdd and the last split to arrive (a
// per-tile counter) runs the epilogue on acc + the sums, as K1's split-K
// does.  acc is only read.  A lane index outside [0, g) (never
// written by pack_msr4) adds nothing.  Folding the correction into K1's
// own launch, with no int32 round trip, is a later speed item.
#include "int_common.cuh"

namespace r8 {
namespace msr4 {

constexpr int THREADS = 128;   // columns a block

struct Args {
  const int* acc;              // (M, N) raw nibble accumulator
  const int8_t* x;             // (M, K)
  const int16_t* idx;          // (K / g, n_out, N) within-group rows
  const int8_t* val;           // (K / g, n_out, N) deltas
  const int* bias;             // (N) or null
  const int* bvec;             // (N) per-channel multipliers or null
  void* out;                   // (M, N) int8 or int32
  int* ws;                     // (M, N) zeroed; split-K only
  int* tile_count;             // (M tiles x N tiles), zeroed; split-K only
  int M, N, K, g, n_out, out_is_int8;
  int groups_per_split;        // K groups a split (grid.z)
  int kc;                      // K rows staged at a time (whole groups)
  Requant rq;
};

// c[j] += x byte j of w (sign-extended) * v, wrapping
__device__ __forceinline__ void mac4(unsigned* c, unsigned w, int v) {
  c[0] += (unsigned)(((int)(w << 24) >> 24) * v);
  c[1] += (unsigned)(((int)(w << 16) >> 24) * v);
  c[2] += (unsigned)(((int)(w << 8) >> 24) * v);
  c[3] += (unsigned)(((int)w >> 24) * v);
}

template <int MT>
__device__ __forceinline__ void mac_row(unsigned (&c)[MT],
                                        const unsigned char* xr, int v) {
  if constexpr (MT == 4) {
    mac4(c, *reinterpret_cast<const unsigned*>(xr), v);
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(xr);
    mac4(c + 0, w.x, v);
    mac4(c + 4, w.y, v);
    mac4(c + 8, w.z, v);
    mac4(c + 12, w.w, v);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
msr4_correct_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char xs[];   // [kc][MT]
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * MT;
  const int n = blockIdx.y * THREADS + tid;
  const int gpc = a.kc / a.g;                 // groups a staged chunk
  const int gbeg = blockIdx.z * a.groups_per_split;
  const int gend = min(a.K / a.g, gbeg + a.groups_per_split);

  unsigned corr[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) corr[j] = 0u;

  for (int c0 = gbeg; c0 < gend; c0 += gpc) {
    const int c1 = min(gend, c0 + gpc);
    const int rows = (c1 - c0) * a.g;
    const size_t k0 = (size_t)c0 * a.g;
    __syncthreads();                          // the last chunk is consumed
    for (int i = tid; i < MT * rows; i += THREADS) {
      const int mm = i / rows, r = i % rows;
      const int m = m0 + mm;
      xs[r * MT + mm] =
          m < a.M ? (unsigned char)a.x[(size_t)m * a.K + k0 + r] : 0;
    }
    __syncthreads();
    if (n >= a.N) continue;
    for (int grp = c0; grp < c1; ++grp) {
      const size_t lane0 = (size_t)grp * a.n_out * a.N + n;
      const unsigned char* xg = xs + (size_t)(grp - c0) * a.g * MT;
#pragma unroll 4
      for (int l = 0; l < a.n_out; ++l) {
        const size_t o = lane0 + (size_t)l * a.N;
        const int r = a.idx[o];
        const int v = a.val[o];
        if ((unsigned)r < (unsigned)a.g) mac_row<MT>(corr, xg + r * MT, v);
      }
    }
  }

  if (gridDim.z > 1) {
    // split K: add this split's sums, the last split finishes
    if (n < a.N) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
        if (m0 + j < a.M)
          atomicAdd(&a.ws[(size_t)(m0 + j) * a.N + n], (int)corr[j]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      is_last = atomicAdd(&a.tile_count[tile], 1) == (int)gridDim.z - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
  }
  if (n >= a.N) return;
  const int bias = a.bias != nullptr ? a.bias[n] : 0;
  const int b = a.rq.kind == RQ_PER_CHANNEL ? a.bvec[n] : a.rq.b;
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int m = m0 + j;
    if (m >= a.M) break;
    const size_t o = (size_t)m * a.N + n;
    int v = wadd(a.acc[o], gridDim.z > 1 ? __ldcg(&a.ws[o]) : (int)corr[j]);
    v = wadd(v, bias);
    if (a.rq.kind != RQ_RAW) v = requant(v, a.rq, b);
    if (a.out_is_int8)
      reinterpret_cast<int8_t*>(a.out)[o] = (int8_t)v;
    else
      reinterpret_cast<int*>(a.out)[o] = v;
  }
}

template <int MT>
int launch(const Args& a, int splits, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        msr4_correct_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.M + MT - 1) / MT, (a.N + THREADS - 1) / THREADS, splits);
  msr4_correct_kernel<MT><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace msr4
}  // namespace r8

// mt: rows a block (4 or 16), splits: grid.z, smem: bytes of the staged x
// (kernels/int8_matmul.py::msr4_plan)
extern "C" int r8_int8_matmul_msr4(const r8::msr4::Args* a, int mt,
                                   int splits, int smem, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mt == 4) return r8::msr4::launch<4>(*a, splits, smem, s);
  if (mt == 16) return r8::msr4::launch<16>(*a, splits, smem, s);
  return (int)cudaErrorInvalidValue;
}
