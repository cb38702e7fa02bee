// K1's grouped instantiation: the expert products of a mixture of experts,
// every expert's int8 GEMM with its own per-channel epilogue in one launch.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul_pallas
// where the reference's MoE runs the same product per expert outside any
// kernel: repro/models/intlayers.py::int_expert_linear, one einsum
// "geck,ekn->gecn" (int8 x int8 -> int32) with the epilogue
// rshift_round(rshift_round(acc, pre) * b_mult[e], c - pre), clipped to
// out_bits, which is K1's per-channel epilogue with expert e's multiplier
// (and bias) rows.  torch.matmul takes no int8 on CUDA and torch._int_mm
// is 2-D only, so this is the port's own.
//
// Operands (kernels/int8_matmul.py::int8_matmul_grouped): x (E, R, K) int8,
// w (E, K, N) int8 (N-major, QuantLinearParams.w8's layout), rows (E,)
// int32 on the card, bias (E, N) | null, bvec (E, N); out (E, R, N) int8
// or int32.  R is the fixed per-expert capacity (routing groups x cap);
// expert e's first rows[e] rows are its packed tokens, the rest is never
// read and never written.  The shapes never depend on the routing, so the
// launch reads nothing back to the host.
//
// Design: K1's tensor-core tile (csrc/int8_mma_tile.cuh, the tile of
// int8_matmul.cu) with the expert as grid z: grid (N / 128, R / BM, E),
// 8 warps, mma.sync.m16n8k32 s8 x s8 -> s32, X tiles through a 3-stage
// cp.async ring, W read one K step ahead into registers and stored
// byte-transposed as the .col B fragments.  A block reads rows[e] from
// global memory first and returns before it loads any weight if its row
// tile is empty, so only the experts that got rows read their weights:
// a decode step of qwen2-moe-a2.7b at B = 4, k = 4 reads at most 16 of its
// 64 experts.  Row tiles: BM = 16 (all 8 warps along N, 16 columns each)
// for R <= 16 (decode), else BM = 64 (2 x 4 warps, K1's 64-row layout).
// Ragged rows, N and K are masked as in K1 (zero-filled loads, guarded
// stores); where K, N or an address is not aligned for the vector copies,
// the same kernel takes scalar loads.  No split K: the experts' blocks fill
// the card.
//
// What bounds it: the weight bytes of the experts that got rows (one
// qwen2-moe w1 is 2048 x 1408 = 2.88 MB; 16 of them at 3.35 TB/s take
// 13.8 us), read once per row tile; at prefill (R = 160, three row
// tiles) the int8 operations.  A simple tile first: TMA and wgmma are a
// later step (ROADMAP S18).
//
// Epilogue (K1's _requant_tile, expert e's rows): acc + bias[e][n], then
// the two-stage round-half-up dyadic with bvec[e][n] and the shared
// (c, pre), clipped to out_bits, stored as int8 or int32; or raw int32.
#include "int_common.cuh"
#include "int_mma.cuh"
#include "int8_mma_tile.cuh"
#include "int_attrs.cuh"

namespace r8 {
namespace grp {

using tc::BK;
using tc::BK4;
using tc::BN;
using tc::SW;
using tc::SX;
using tc::THREADS;
using tc::XSTAGES;

struct Args {
  const int8_t* x;
  const int8_t* w;
  const int* rows;
  const int* bias;
  const int* bvec;
  void* out;
  Requant rq;
  int out_is_int8;
  int E;
  int R;
  int N;
  int K;
  int vec_x;
  int vec_w;
};

// one X stage: BM rows x BK bytes from k0 into sx (row stride SX words);
// BM * 4 16-byte chunks over the block's threads (BM = 16: a quarter of
// them copy)
template <int BM>
__device__ __forceinline__ void load_x_stage(int* sx,
                                             const int8_t* __restrict__ x,
                                             int M, int K, int m0, int k0,
                                             bool vec) {
  constexpr int CPR = BK / 16;
  for (int i = threadIdx.x; i < BM * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const int m = m0 + r, k = k0 + 16 * c;
    int* dst = sx + r * SX + 4 * c;
    if (vec) {
      const int valid = (m < M && k < K) ? min(16, K - k) : 0;
      tc::cp_async16(tc::smem_addr(dst), valid ? x + (size_t)m * K + k : x,
                     valid);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = load_x_pack(x, M, K, K, m, k + 4 * j, false);
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_grouped_kernel(const Args a) {
  constexpr int WM = BM >= 32 ? 2 : 1;   // warps along M
  constexpr int WN = 8 / WM;             // warps along N
  constexpr int WTM = BM / WM;           // rows a warp
  constexpr int MT = WTM / 16;           // m16n8 products along M a warp
  constexpr int WTN = BN / WN;           // columns a warp
  constexpr int NT = WTN / 8;            // m16n8 products along N a warp
  static_assert(WM * WN * 32 == THREADS && MT >= 1 && NT >= 1, "layout");
  __shared__ __align__(16) int sx_ring[XSTAGES][BM][SX];
  __shared__ __align__(16) int sw_pair[2][BK4][SW];

  const int e = blockIdx.z;
  const int M = min(a.rows[e], a.R);     // this expert's packed rows
  const int m0 = blockIdx.y * BM;
  if (m0 >= M) return;                   // an empty tile reads no weight
  const int N = a.N, K = a.K;
  const int8_t* __restrict__ x = a.x + (size_t)e * a.R * K;
  const int8_t* __restrict__ w = a.w + (size_t)e * K * N;
  int* sx0 = &sx_ring[0][0][0];
  int* sw0 = &sw_pair[0][0][0];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const bool vec_x = a.vec_x != 0, vec_w = a.vec_w != 0;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  // X of K-step s in slot s % XSTAGES; its W in sw[s & 1], stored from
  // registers loaded one step ahead (K1's schedule)
#pragma unroll
  for (int s = 0; s < XSTAGES - 1; ++s) {
    if (s < nk)
      load_x_stage<BM>(sx0 + s * BM * SX, x, M, K, m0, s * BK, vec_x);
    tc::cp_commit();
  }
  uint2 wr[4];
  tc::load_w_regs<false>(wr, w, N, K, 0, n0, vec_w);
  tc::store_w_regs<false>(sw0, wr);

  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk)
      tc::load_w_regs<false>(wr, w, N, K, (it + 1) * BK, n0, vec_w);
    tc::cp_wait<XSTAGES - 2>();
    __syncthreads();
    {
      const int s = it + XSTAGES - 1;
      if (s < nk)
        load_x_stage<BM>(sx0 + (s % XSTAGES) * BM * SX, x, M, K, m0, s * BK,
                         vec_x);
      tc::cp_commit();
    }
    const int* sx = sx0 + (it % XSTAGES) * BM * SX + (wm * WTM + g) * SX + t;
    const int* sw = sw0 + (it & 1) * BK4 * SW + t * SW + wn * WTN + g;
#pragma unroll 1
    for (int kb = 0; kb < BK4; kb += 8) {
      int b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b[j][0] = sw[kb * SW + 8 * j];
        b[j][1] = sw[(kb + 4) * SW + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int* r = sx + 16 * i * SX + kb;
        const int af[4] = {r[0], r[8 * SX], r[4], r[8 * SX + 4]};
#pragma unroll
        for (int j = 0; j < NT; ++j)
          tc::mma_s8(acc[i][j], af, b[j][0], b[j][1]);
      }
    }
    if (it + 1 < nk)
      tc::store_w_regs<false>(sw0 + ((it + 1) & 1) * BK4 * SW, wr);
  }

  // epilogue: expert e's bias and multipliers, rows m < rows[e]
  const int mw = m0 + wm * WTM + g;
  const int nw = n0 + wn * WTN + 2 * t;
  const int* bias = a.bias != nullptr ? a.bias + (size_t)e * N : nullptr;
  const int* bvec = a.bvec != nullptr ? a.bvec + (size_t)e * N : nullptr;
  const Requant rq = a.rq;
  const bool pair = (N % 2) == 0;
  const size_t base = (size_t)e * a.R * N;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = nw + 8 * j;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const int bias0 = bias != nullptr ? bias[n] : 0;
    const int bias1 = bias != nullptr && two ? bias[n + 1] : 0;
    int b0 = rq.b, b1 = rq.b;
    if (rq.kind == RQ_PER_CHANNEL) {
      b0 = bvec[n];
      b1 = two ? bvec[n + 1] : 0;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mw + 16 * i + 8 * h;
        if (m >= M) continue;
        int v0 = wadd(acc[i][j][2 * h], bias0);
        int v1 = wadd(acc[i][j][2 * h + 1], bias1);
        if (rq.kind != RQ_RAW) {
          v0 = requant(v0, rq, b0);
          v1 = requant(v1, rq, b1);
        }
        const size_t o = base + (size_t)m * N + n;
        if (a.out_is_int8) {
          int8_t* p = reinterpret_cast<int8_t*>(a.out) + o;
          if (pair) {
            *reinterpret_cast<char2*>(p) = make_char2((char)v0, (char)v1);
          } else {
            p[0] = (int8_t)v0;
            if (two) p[1] = (int8_t)v1;
          }
        } else {
          int* p = reinterpret_cast<int*>(a.out) + o;
          if (pair) {
            *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
          } else {
            p[0] = v0;
            if (two) p[1] = v1;
          }
        }
      }
  }
}

template <int BM>
int launch(const Args& a, cudaStream_t s) {
  dim3 grid((a.N + BN - 1) / BN, (a.R + BM - 1) / BM, a.E);
  int8_matmul_grouped_kernel<BM><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace grp
}  // namespace r8

// bm: the row tile, 16 (R <= 16) or 64
// (kernels/int8_matmul.py::grouped_plan)
extern "C" int r8_int8_matmul_grouped(const r8::grp::Args* a, int bm,
                                      void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bm == 16) return r8::grp::launch<16>(*a, s);
  if (bm == 64) return r8::grp::launch<64>(*a, s);
  return (int)cudaErrorInvalidValue;
}

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: BM 16 or 64); out[6]
extern "C" int r8_attrs_int8_matmul_grouped(const int* sel, int threads,
                                            int smem, int cluster, int* out) {
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  if (sel[0] == 16)
    return r8::attrs(r8::grp::int8_matmul_grouped_kernel<16>, threads, smem,
                     1, 1, out);
  if (sel[0] == 64)
    return r8::attrs(r8::grp::int8_matmul_grouped_kernel<64>, threads, smem,
                     1, 1, out);
  return (int)cudaErrorInvalidValue;
}
