// K1's M <= 16 tile (decode: M = batch), designed for Hopper.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul_pallas
// (body _mm_kernel, epilogue _requant_tile) wherever M <= 16, dense int8
// weights (K, N) and packed int4 nibble pairs (K / 2, N, K row 2i in the
// low nibble of byte row i) alike (PACKED, a template argument).  The
// M > 16 tiles stay in int8_matmul.cu.
//
// What bounds it: a decode GEMM streams a whole weight matrix for at most
// 16 rows, so it is bound by device-memory bytes (w1: 58.7 MB, 17.5 us at
// 3.35 TB/s; packed: half).  The card needs ~3.35 TB/s x ~1 us = 3.3 MB
// in flight, ~25 KB an SM.  Design:
//
// * One block owns BN = 128 or 64 columns and all 16 rows (rows >= M are
//   zero), so the weights are read once per launch for any M <= 16.
//
// * A producer warp streams the block's K range through a ring of STAGES
//   stages (64 KB of weights: 4 x 128 rows x 128 bytes, or 8 x 128 x 64)
//   with full / empty mbarriers: lane 0 issues one TMA 2-D load a stage
//   for the weight tile (TR = 128 rows x BN bytes, SWIZZLE_128B, or
//   SWIZZLE_64B for BN = 64) and one or two for x (16 rows x 128 bytes of
//   K a box, SWIZZLE_128B; packed stages cover 256 K).  The TMA zero-fills
//   rows past K (K / 2), columns past N and x rows past M.  Where a tensor
//   map cannot describe an operand (N or K not a multiple of 16, or w / x
//   not 16-byte aligned: kernels/int8_matmul.py::launch_plan decides from
//   the shape and the addresses) the same warp copies the same tiles with
//   masked 4-byte or byte loads into the same swizzled layout, and its 32
//   lanes arrive on the full barrier instead of the transaction count.
//
// * Four consumer warps multiply on the int8 tensor cores
//   (mma.sync.m16n8k32 s8, int_mma.cuh).  A stage holds 4 k32 steps
//   (dense) or 8 (packed, 16 byte rows each); warp w takes steps w and
//   w + 4.  In a k32 step a lane (g = lane / 4, t = lane % 4) reads NT =
//   BN / 8 bytes of one weight row at column NT g (one 16-byte or 8-byte
//   load) from rows 8 r + b0(t), r = 0..3, for b0 and 8 r + b1(t) for b1,
//   with b0(t) = {0, 4, 3, 7} and b1(t) = b0(t) ^ 1; packed: byte rows
//   8 r + b(t), r = 0..1.  A 4-row x 4-column unit of those bytes is
//   transposed with __byte_perm (tc::transpose4; packed: tc::expand_w4
//   over two byte rows) into four "4 K values of one column" words, which
//   are b0 (b1) of four n8 tiles: tile T = 0..NT-1 holds weight column
//   NT q + T at its column q, so no loaded byte is wasted and nothing is
//   stored to shared memory again.  The epilogue undoes that relabelling.
//   The product sums over K, so A takes the same K permutation: logical
//   k 4t + i of the step is physical row b0(t) + 8 i (b1(t) + 8 i for
//   16 + 4t + i); packed, byte rows b, b + 8 give K rows 2b, 2b + 1,
//   2b + 16, 2b + 17.  A lane builds its A words from four x words (two
//   packed) of row g (g + 8) with __byte_perm.
//
//   Banks (4-byte banks; a 16-byte load is served 8 lanes at a time, an
//   8-byte load 16 at a time; tests/test_torch_k1_plan.py checks every
//   case).  SWIZZLE_128B stores byte (row, col) of a 128-byte row at
//   row * 128 + 16 ((col / 16) ^ (row % 8)) + col % 16, SWIZZLE_64B of a
//   64-byte row at row * 64 + 16 ((col / 16) ^ ((row / 2) % 4)) + col % 16.
//   Rows 8 r + b keep row % 8 = b.  BN = 128: lanes 8h..8h+7 are g = 2h,
//   2h + 1 and t = 0..3; their chunks g ^ b0(t) run over g ^ {0, 4, 3, 7}
//   and (g ^ 1) ^ {0, 4, 3, 7}, all 8 chunks: 32 banks (b1 likewise, with
//   {1, 5, 2, 6}).  BN = 64: lanes 16h..16h+15 are g = 4h..4h+3; a row
//   of 64 bytes fills half the banks, (row % 2) picks the half, so the
//   bank pair of lane (g, t) is 8 (b % 2) + 2 ((g / 2) ^ (b / 2 % 4)) +
//   g % 2 over b = b0(t): parity 0 takes b / 2 in {0, 2}, parity 1 in
//   {1, 3}, so (g / 2) ^ (b / 2) runs over four values within each
//   parity: 16 pairs, 32 banks.  x words (4-byte loads): word u of row m
//   lies in bank 4 ((u / 4) ^ (m % 8)) + u % 4; a lane's word in a load
//   is u = 8 j + t % 2 + 2 r (packed: 8 j + {0, 2, 1, 3}(t) (+ 4)), so the
//   8 rows g take 8 chunks and t the word inside: distinct addresses,
//   distinct banks.
//
// * Split K across the blocks of a thread block cluster (up to 8, along
//   grid z), with no global workspace: each block sums its four warps'
//   partials (stored fragment by fragment into its own idle ring), then
//   the ranks > 0 store their 16 x BN int32 partial into rank 0's ring
//   through distributed shared memory (mapa / st.shared::cluster) between
//   two cluster barriers, and rank 0 adds them and runs the epilogue.
//   Integer addition modulo 2^32 is exact in any order.  launch_plan
//   picks BN and the cluster size from the shape alone (about one full
//   wave of SMs), each rank's K range a whole number of stages.
//
// The accumulator wraps modulo 2^32 (no .satfinite), as JAX's int32 and
// the M > 16 tiles do.  Epilogue (exactly _requant_tile, the same code as
// the M > 16 tiles'): acc + bias, then raw int32, or the two-stage dyadic
// (per-tensor b, or per-channel b_vec[n] with shared c, pre), clipped to
// out_bits, stored as int8 or int32.
//
// Why mma.sync and not wgmma: for 8-bit types wgmma reads B from shared
// memory K-major only (there is no transposed 8-bit operand as there is
// for 16-bit types), the weights are N-major, and M <= 16 is far below
// wgmma's 64 rows.
#include <cuda.h>
#include <cstring>

#include "int_cluster.cuh"
#include "int_common.cuh"
#include "int_mma.cuh"
#include "int8_ring.cuh"
#include "int_attrs.cuh"

namespace r8 {
namespace dec {

constexpr int XROWS = 16;                  // rows of an x box (M <= 16)
constexpr int XBOX = XROWS * 128;          // one x box: 16 rows x 128 K

template <int BN, bool PACKED>
struct Shape {
  static constexpr int CONSUMERS = 4;      // consumer warps
  static constexpr int THREADS = 32 * (CONSUMERS + 1);
  static constexpr int STAGES = BN == 128 ? 4 : 8;
  static constexpr int NT = BN / 8;        // n8 tiles (columns a lane)
  static constexpr int KS = PACKED ? 2 * TR : TR;   // K a stage
  static constexpr int WBYTES = TR * BN;
  static constexpr int XBYTES = XROWS * KS;
  static constexpr int STEPS = KS / 32;    // k32 steps a stage
  static constexpr int SMEM = STAGES * (WBYTES + XBYTES) + 1024;
};

struct Args {
  const int8_t* x;
  const int8_t* w;
  const int* bias;
  const int* bvec;
  void* out;
  Requant rq;
  int out_is_int8, M, N, K, k_per_split, use_tma, vec_x, vec_w;
};

// the copy route: stage i's weight tile and x boxes by the producer warp,
// the same bytes in the same swizzled layout as the TMA would write
template <int BN, bool PACKED>
__device__ __forceinline__ void copy_stage(uint8_t* wt, uint8_t* xt,
                                           const Args& a, int kbeg, int i,
                                           int lane) {
  using S = Shape<BN, PACKED>;
  const int rows = PACKED ? a.K / 2 : a.K;
  const int row0 = (kbeg + i * S::KS) / (PACKED ? 2 : 1);
  const int n0 = blockIdx.x * BN;
  for (int u = lane; u < TR * (BN / 4); u += 32) {
    const int r = u / (BN / 4), c = 4 * (u % (BN / 4));
    const int row = row0 + r, n = n0 + c;
    const unsigned v =
        row < rows ? load4(a.w + (size_t)row * a.N + n, a.N - n, a.vec_w)
                   : 0u;
    *reinterpret_cast<unsigned*>(wt + wswz<BN>(r, c)) = v;
  }
  const int k0 = kbeg + i * S::KS;
  for (int u = lane; u < XROWS * (S::KS / 4); u += 32) {
    const int m = u / (S::KS / 4), c = 4 * (u % (S::KS / 4));
    const int k = k0 + c;
    const unsigned v =
        m < a.M ? load4(a.x + (size_t)m * a.K + k, a.K - k, a.vec_x) : 0u;
    *reinterpret_cast<unsigned*>(xt + (c / 128) * XBOX + xswz(m, c % 128)) =
        v;
  }
}

// NT bytes of one weight row (the lane's columns) as NT / 4 words
template <int NW>
__device__ __forceinline__ void load_row(unsigned (&v)[NW],
                                         const uint8_t* p) {
  if constexpr (NW == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

__device__ __forceinline__ unsigned xword(const uint8_t* xt, int m, int u) {
  return *reinterpret_cast<const unsigned*>(xt + xswz(m, 4 * u));
}

// A fragments of k32 step j of a stage: a0 / a2 from row g, a1 / a3 from
// row g + 8, in the step's K permutation (see the note)
template <bool PACKED>
__device__ __forceinline__ void a_frags(int (&a)[4], const uint8_t* xt,
                                        int j, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = g + 8 * h;
    unsigned lo, hi;
    if constexpr (PACKED) {
      // byte rows b, b + 8 hold K rows 2b, 2b + 1, 2b + 16, 2b + 17: word
      // 2b / 4 and the one 16 bytes on, bytes 2b % 4 (a0) or its partner
      // 2b' % 4 = 2b % 4 ^ 2 (a2, b' = b ^ 1)
      const uint8_t* box = xt + (j >> 2) * XBOX;
      const int u = 8 * (j & 3) + (((t & 1) << 1) | (t >> 1));
      const unsigned o0 = (t >> 1) ? 2u : 0u, o1 = o0 ^ 2u;
      const unsigned xl = xword(box, m, u), xh = xword(box, m, u + 4);
      lo = __byte_perm(xl, xh, o0 | (o0 + 1) << 4 | (o0 + 4) << 8 |
                                   (o0 + 5) << 12);
      hi = __byte_perm(xl, xh, o1 | (o1 + 1) << 4 | (o1 + 4) << 8 |
                                   (o1 + 5) << 12);
    } else {
      // K rows b0(t) + 8r (a0) and b1(t) + 8r (a2): word t % 2 + 2r of
      // the step, bytes {0, 0, 3, 3}(t) and {1, 1, 2, 2}(t)
      const unsigned s0 = (t >> 1) ? 3u : 0u, s1 = (t >> 1) ? 2u : 1u;
      const unsigned sel = s0 | (s0 + 4) << 4 | s1 << 8 | (s1 + 4) << 12;
      const int u = 8 * j + (t & 1);
      const unsigned p01 =
          __byte_perm(xword(xt, m, u), xword(xt, m, u + 2), sel);
      const unsigned p23 =
          __byte_perm(xword(xt, m, u + 4), xword(xt, m, u + 6), sel);
      lo = __byte_perm(p01, p23, 0x5410);
      hi = __byte_perm(p01, p23, 0x7632);
    }
    a[h] = (int)lo;
    a[2 + h] = (int)hi;
  }
}

// one k32 step of a stage into the warp's 16 x BN accumulator
template <int BN, bool PACKED>
__device__ __forceinline__ void k32_step(int (&acc)[BN / 8][4],
                                         const uint8_t* wt,
                                         const uint8_t* xt, int j, int g,
                                         int t) {
  constexpr int NT = BN / 8, NW = NT / 4, R = PACKED ? 2 : 4;
  const int b0 = (4 * (t & 1)) ^ (3 * (t >> 1)), b1 = b0 ^ 1;
  const uint8_t* base = wt + j * (PACKED ? 16 : 32) * BN;
  unsigned w0[R][NW], w1[R][NW];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    load_row<NW>(w0[r], base + wswz<BN>(8 * r + b0, NT * g));
    load_row<NW>(w1[r], base + wswz<BN>(8 * r + b1, NT * g));
  }
  int a[4];
  a_frags<PACKED>(a, xt, j, g, t);
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    int4 c0, c1;
    if constexpr (PACKED) {
      c0 = tc::expand_w4(w0[0][q], w0[1][q]);
      c1 = tc::expand_w4(w1[0][q], w1[1][q]);
    } else {
      c0 = tc::transpose4(w0[0][q], w0[1][q], w0[2][q], w0[3][q]);
      c1 = tc::transpose4(w1[0][q], w1[1][q], w1[2][q], w1[3][q]);
    }
    tc::mma_s8(acc[4 * q + 0], a, c0.x, c1.x);
    tc::mma_s8(acc[4 * q + 1], a, c0.y, c1.y);
    tc::mma_s8(acc[4 * q + 2], a, c0.z, c1.z);
    tc::mma_s8(acc[4 * q + 3], a, c0.w, c1.w);
  }
}

template <int BN, bool PACKED>
__global__ void __launch_bounds__(Shape<BN, PACKED>::THREADS, 2)
int8_matmul_decode_kernel(const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap xmap,
                          const Args a) {
  using S = Shape<BN, PACKED>;
  constexpr int NT = S::NT, CONSUMERS = S::CONSUMERS;
  constexpr int PER = NT * 32 / (32 * CONSUMERS);   // int4 a thread sums
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t full[S::STAGES], empty[S::STAGES];
  // 1024-byte aligned ring (the swizzle patterns repeat every 1024 bytes)
  uint8_t* ring = dyn + ((1024 - (tc::smem_addr(dyn) & 1023)) & 1023);
  uint8_t* xring = ring + S::STAGES * S::WBYTES;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const unsigned rank = cluster_rank();
  const int nrank = gridDim.z;
  const int kbeg = (int)rank * a.k_per_split;
  const int kend = min(a.K, kbeg + a.k_per_split);
  const int nk = kend > kbeg ? (kend - kbeg + S::KS - 1) / S::KS : 0;
  const int n0 = blockIdx.x * BN;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(tc::smem_addr(&full[s]), a.use_tma ? 1u : 32u);
      mbar_init(tc::smem_addr(&empty[s]), 32u * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0;

  if (warp == CONSUMERS) {                     // the producer
    for (int i = 0; i < nk; ++i) {
      const int s = i % S::STAGES;
      const unsigned ph = ((i / S::STAGES) & 1) ^ 1u;
      uint8_t* wt = ring + s * S::WBYTES;
      uint8_t* xt = xring + s * S::XBYTES;
      if (a.use_tma) {
        if (lane == 0) {
          const unsigned bar = tc::smem_addr(&full[s]);
          mbar_wait(tc::smem_addr(&empty[s]), ph);
          mbar_expect_tx(bar, S::WBYTES + S::XBYTES);
          tma_load_2d(tc::smem_addr(wt), &wmap, n0,
                      (kbeg + i * S::KS) / (PACKED ? 2 : 1), bar);
#pragma unroll
          for (int b = 0; b < S::KS / 128; ++b)
            tma_load_2d(tc::smem_addr(xt + b * XBOX), &xmap,
                        kbeg + i * S::KS + 128 * b, 0, bar);
        }
      } else {
        mbar_wait(tc::smem_addr(&empty[s]), ph);
        copy_stage<BN, PACKED>(wt, xt, a, kbeg, i, lane);
        mbar_arrive(tc::smem_addr(&full[s]));
      }
    }
  } else {                                     // the consumers
    for (int i = 0; i < nk; ++i) {
      const int s = i % S::STAGES;
      mbar_wait(tc::smem_addr(&full[s]), (i / S::STAGES) & 1);
      const uint8_t* wt = ring + s * S::WBYTES;
      const uint8_t* xt = xring + s * S::XBYTES;
#pragma unroll
      for (int jj = 0; jj < S::STEPS / CONSUMERS; ++jj)
        k32_step<BN, PACKED>(acc, wt, xt, warp + CONSUMERS * jj, g, t);
      mbar_arrive(tc::smem_addr(&empty[s]));
    }
  }
  __syncthreads();                             // the ring is idle now
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // the block's partial: each consumer warp's fragments into the ring,
  // then summed fragment by fragment (the order the epilogue reads)
  int4* part = reinterpret_cast<int4*>(ring);
  if (warp < CONSUMERS) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
      part[(warp * NT + i) * 32 + lane] =
          make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  int4 v[PER];
  if (warp < CONSUMERS) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int f = tid + 32 * CONSUMERS * q;
      int4 s = part[f];
#pragma unroll
      for (int w = 1; w < CONSUMERS; ++w) {
        const int4 p = part[w * NT * 32 + f];
        s = make_int4(wadd(s.x, p.x), wadd(s.y, p.y), wadd(s.z, p.z),
                      wadd(s.w, p.w));
      }
      v[q] = s;
    }
  }
  if (nrank > 1) {
    // ranks > 0 store their partial into rank 0's ring (slot rank - 1)
    // once every rank has read its own partials, then rank 0 adds them
    __syncwarp();
    cluster_sync();
    if (rank != 0 && warp < CONSUMERS) {
      const unsigned dst =
          map_rank(tc::smem_addr(ring), 0) + (rank - 1) * NT * 32 * 16;
#pragma unroll
      for (int q = 0; q < PER; ++q)
        st_cluster(dst + 16 * (tid + 32 * CONSUMERS * q), v[q]);
    }
    __syncwarp();
    cluster_sync();
    if (rank != 0) return;
    if (warp < CONSUMERS) {
      for (int r = 1; r < nrank; ++r)
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const int4 p = part[(r - 1) * NT * 32 + tid + 32 * CONSUMERS * q];
          v[q] = make_int4(wadd(v[q].x, p.x), wadd(v[q].y, p.y),
                           wadd(v[q].z, p.z), wadd(v[q].w, p.w));
        }
    }
  }
  if (warp >= CONSUMERS) return;

  // epilogue: fragment f = (tile T, lane (gf, tf)), element e at row gf +
  // 8 (e / 2), n8 column 2 tf + e % 2, i.e. weight column NT (2 tf + e % 2)
  // + T; bias, requant, clip, store
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int f = tid + 32 * CONSUMERS * q;
    const int T = f / 32, gf = (f % 32) / 4, tf = f % 4;
    const int val[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = gf + 8 * (e / 2);
      const int n = n0 + NT * (2 * tf + e % 2) + T;
      if (m >= a.M || n >= a.N) continue;
      int r = val[e];
      if (a.bias != nullptr) r = wadd(r, a.bias[n]);
      if (a.rq.kind != RQ_RAW) {
        const int b = a.rq.kind == RQ_PER_CHANNEL ? a.bvec[n] : a.rq.b;
        r = requant(r, a.rq, b);
      }
      const size_t o = (size_t)m * a.N + n;
      if (a.out_is_int8)
        reinterpret_cast<int8_t*>(a.out)[o] = (int8_t)r;
      else
        reinterpret_cast<int*>(a.out)[o] = r;
    }
  }
}

template <int BN, bool PACKED>
int launch(const Args& a, const void* wmap, const void* xmap, int cluster,
           cudaStream_t s) {
  using S = Shape<BN, PACKED>;
  auto kern = int8_matmul_decode_kernel<BN, PACKED>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap wm, xm;
  std::memset(&wm, 0, sizeof wm);
  std::memset(&xm, 0, sizeof xm);
  if (wmap != nullptr) std::memcpy(&wm, wmap, sizeof wm);
  if (xmap != nullptr) std::memcpy(&xm, xmap, sizeof xm);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + BN - 1) / BN, 1, cluster);
  cfg.blockDim = dim3(S::THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = cluster;
  cfg.attrs = at;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, wm, xm, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the
// library links no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

}  // namespace dec
}  // namespace r8

namespace {

// an int8 tensor map of `rank` dimensions (dims innermost first, each
// outer stride the product of the inner dims) with boxes of `box` bytes and
// the 64- or 128-byte swizzle, into the 128 bytes at `out`; returns
// cuTensorMapEncodeTiled's CUresult (-1: no entry point)
int tensor_map(void* out, const void* base, int rank,
               const unsigned long long* dims, const unsigned* box,
               int swizzle) {
  const r8::dec::EncodeTiled fn = r8::dec::encode_tiled();
  if (fn == nullptr) return -1;
  CUtensorMap map;
  cuuint64_t d[3], strides[2];
  cuuint32_t b[3];
  const cuuint32_t elem[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i > 0) strides[i - 1] = (i == 1 ? 1ull : strides[i - 2]) * dims[i - 1];
  }
  const CUresult r = fn(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), d,
      strides, b, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) std::memcpy(out, &map, sizeof map);
  return (int)r;
}

}  // namespace

// a 2-D int8 tensor map (inner x outer bytes, row stride inner) with boxes
// of box_inner x box_outer bytes and the 64- or 128-byte swizzle, into the
// 128 bytes at `out`; returns cuTensorMapEncodeTiled's CUresult (-1: no
// entry point)
extern "C" int r8_tensor_map_2d(void* out, const void* base,
                                unsigned long long inner,
                                unsigned long long outer,
                                unsigned box_inner, unsigned box_outer,
                                int swizzle) {
  const unsigned long long dims[2] = {inner, outer};
  const unsigned box[2] = {box_inner, box_outer};
  return tensor_map(out, base, 2, dims, box, swizzle);
}

// the same over three dimensions (d0 innermost: a (d2, d1, d0) int8 array,
// e.g. the experts' (E, K, N) weights), boxes of b0 x b1 x 1
extern "C" int r8_tensor_map_3d(void* out, const void* base,
                                unsigned long long d0, unsigned long long d1,
                                unsigned long long d2, unsigned b0,
                                unsigned b1, int swizzle) {
  const unsigned long long dims[3] = {d0, d1, d2};
  const unsigned box[3] = {b0, b1, 1u};
  return tensor_map(out, base, 3, dims, box, swizzle);
}

// bn 128 or 64, cluster 1..8 (grid z), packed: w is (K / 2, N) nibble
// pairs; wmap / xmap: the 128-byte tensor maps of w and x (the TMA route)
// or both null (the copy route)
extern "C" int r8_int8_matmul_decode(const r8::dec::Args* a, const void* wmap,
                                     const void* xmap, int bn, int cluster,
                                     int packed, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((wmap == nullptr) != (xmap == nullptr) ||
      a->use_tma != (wmap != nullptr) || cluster < 1 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  if (bn == 128)
    return packed ? r8::dec::launch<128, true>(*a, wmap, xmap, cluster, s)
                  : r8::dec::launch<128, false>(*a, wmap, xmap, cluster, s);
  if (bn == 64)
    return packed ? r8::dec::launch<64, true>(*a, wmap, xmap, cluster, s)
                  : r8::dec::launch<64, false>(*a, wmap, xmap, cluster, s);
  return (int)cudaErrorInvalidValue;
}

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: BN 128 or 64, packed; the cluster
// splits K along grid z); out[6]
extern "C" int r8_attrs_int8_matmul_decode(const int* sel, int threads,
                                           int smem, int cluster, int* out) {
  const bool packed = sel[1] != 0;
  if (sel[0] == 128)
    return packed
               ? r8::attrs(r8::dec::int8_matmul_decode_kernel<128, true>,
                           threads, smem, 1, cluster, out)
               : r8::attrs(r8::dec::int8_matmul_decode_kernel<128, false>,
                           threads, smem, 1, cluster, out);
  if (sel[0] == 64)
    return packed
               ? r8::attrs(r8::dec::int8_matmul_decode_kernel<64, true>,
                           threads, smem, 1, cluster, out)
               : r8::attrs(r8::dec::int8_matmul_decode_kernel<64, false>,
                           threads, smem, 1, cluster, out);
  return (int)cudaErrorInvalidValue;
}
