// K1's grouped instantiation: the expert products of a mixture of experts,
// every expert's int8 GEMM with its own per-channel epilogue in one launch,
// designed for Hopper.
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
// written.  The launch depends on (E, R, K, N) alone and reads nothing back
// to the host.
//
// What bounds it: the weight bytes of the experts that got rows (one
// qwen2-moe w1 is 2048 x 1408 = 2.88 MB; 16 of them at 3.35 TB/s take
// 13.8 us), each read once; at prefill (qwen2-moe's 4 x 512 pass: R 160,
// 60 experts) the same bytes, with the int8 operations close behind.
// Design (kernels/int8_matmul.py::grouped_plan chooses the instantiation,
// the cluster and the grid):
//
// * Only live work.  The grid is about one wave of blocks whatever the
//   routing.  Each block reads rows[0..E) and compacts the experts that
//   got rows into a list in shared memory (one warp, a ballot a 32
//   experts); the items are (live expert, 128-column N tile), N tile
//   fastest, and the blocks (or split groups, below) stride over them.  A
//   decode step that routes to 4 of 64 experts costs 44 items, not 704
//   blocks.
//
// * A producer warp streams an item's K range through a ring of STAGES
//   stages (a 128 x 128 weight tile and an RT x 128 x box each; full /
//   empty mbarriers), one item after another with no drain between them:
//   lane 0 issues two 3-D TMA loads a stage, over maps of w as (E, K, N)
//   and x as (E, R, K), so a box past K or R inside expert e is zero-filled
//   and never reads expert e + 1.  Where a tensor map cannot describe an
//   operand (K or N not a multiple of 16, or x / w not 16-byte aligned) the
//   same warp copies the same images with masked word loads and its 32
//   lanes arrive on the full barrier instead (the copy route).
//
// * Consumer warps, WM along M x 2 along N (64 columns each), multiply on
//   the int8 tensor cores (mma.sync.m16n8k32 s8; wgmma reads 8-bit B only
//   K-major and w is N-major), in the plain K order.  A lane loads 8 bytes
//   of one weight row at column 64 wn + 8 g from rows 16 h + 4 t + r and
//   transposes 4 x 4 units in registers with __byte_perm into the B words
//   of eight n8 tiles: tile T's column q is weight column 64 wn + 8 q + T,
//   so nothing is stored to shared memory a second time, and a lane ends
//   with 16 consecutive columns of a row, which the epilogue stores as
//   vectors.  An m16 tile's A words are one ldmatrix.x4; a warp reuses
//   each k32 step's B words for its MT m16 tiles.  (The decode tile's K
//   permutation makes the B loads conflict-free but costs 8 loads and 8
//   byte permutes an m16 tile where ldmatrix takes one instruction; lanes
//   t and t + 2 now share a swizzle row, a 2-way conflict on B.)
//
// * R <= 16 (decode): WM = 1 (two consumer warps, RT 16) in clusters of
//   C ranks (the plan's C <= 2), one block an SM.  The split is chosen on
//   the card from the live items, alike in every block: S ranks a group
//   split an item's K (a power of two up to C, two stages a rank on
//   average, none empty), the largest S whose items x S ranks stay within
//   the grid's blocks; the C / S groups of a cluster take distinct items.
//   So 4 of qwen2-moe's 64 experts (44 items) run 88 ranks of 8 stages, 16
//   of them (176 items) no split at all: a split costs one cluster barrier
//   a round of items, worth it only where whole items leave blocks idle.
//   (Clusters of 4 leave SMs idle: 33 of them do not fit one block an SM.)
//   After an item each rank of a group sends its partial (16 consecutive
//   columns of two rows a lane) to the group's rank that owns that lane's
//   (wn, t) through distributed shared memory, into a buffer of two (by
//   round parity); one cluster barrier a round (the producer arrives once
//   it has issued the round's loads and waits before its next arrive, so
//   the ring keeps streaming the next round through it), then each owner
//   adds and runs the epilogue.  Integer addition mod 2^32 is exact in any
//   order.  No global workspace: nothing to zero.
//
// * R > 16: WM = 3 (six consumer warps: 3 x 2) and MT = 1, 2 or 4 m16
//   tiles a warp, a row tile RT = 48 MT of up to 192 rows (qwen2-moe's
//   pass: R 160); a block owns an item and all of the expert's rows, so
//   each weight tile is read once per expert (R past 192 loops over row
//   chunks inside the block); warps skip the m16 tiles past rows[e].
//   One block an SM: seven warps leave a thread 255 registers (MT 4: 128
//   of them accumulators); the weight tile's B words are built three
//   times a stage (once a warp along M), the x box's A words twice.
//
// Epilogue (K1's _requant_tile, expert e's rows): acc + bias[e][n], then
// the two-stage round-half-up dyadic with bvec[e][n] and the shared
// (c, pre), clipped to out_bits, stored as int8 or int32; or raw int32.
// Each warp's 64 columns of bias and multipliers reach shared memory by
// cp.async while the item's K loop runs.
// The accumulator wraps modulo 2^32 (no .satfinite), as JAX's int32 does.
#include <cuda.h>
#include <cstring>

#include "int_cluster.cuh"
#include "int_common.cuh"
#include "int_mma.cuh"
#include "int8_ring.cuh"
#include "int_attrs.cuh"

namespace r8 {
namespace grp {

constexpr int BN = 128;                    // columns an item
constexpr int KS = dec::TR;                // K rows a ring stage
constexpr int STAGES = 5;
constexpr int WN = 2;                      // consumer warps along N
constexpr int NT = 8;                      // n8 tiles a warp (64 columns)
constexpr int WBYTES = KS * BN;            // a weight tile: 16 KB
constexpr int PAIRS = 8;                   // (wn, t): a lane's 16 columns
// decode's exchange buffer: PAIRS x 8 g x NT int4 (8 KB), two of them
constexpr int XCHG_INT4 = PAIRS * 8 * NT;
constexpr int MAX_SMEM = 232448;

template <int WM, int MT>
struct Shape {
  static constexpr int CONSUMERS = WM * WN;
  static constexpr int THREADS = 32 * (CONSUMERS + 1);
  static constexpr int RT = 16 * WM * MT;  // rows a chunk
  static constexpr int XBYTES = RT * 128;
  static constexpr int STAGE = WBYTES + XBYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int XCHG = WM == 1 ? 2 * XCHG_INT4 * 16 : 0;
  static constexpr int COLS = CONSUMERS * 128 * 4;   // fetch_cols' bytes
};

struct Args {
  const int8_t* x;
  const int8_t* w;
  const int* rows;
  const int* bias;
  const int* bvec;
  void* out;
  Requant rq;
  int out_is_int8, E, R, N, K, cluster, use_tma, vec_x, vec_w;
};

// the copy route: one stage's weight tile (K rows k0.., columns n0.. of
// expert e) and x box (rows m0.., K k0..) by the producer warp, the same
// bytes in the same swizzled layout as the TMA writes them, zero past K,
// N and R
template <int RT>
__device__ __forceinline__ void copy_stage(uint8_t* wt, uint8_t* xt,
                                           const Args& a, int e, int n0,
                                           int k0, int m0, int lane) {
  const int8_t* w = a.w + (size_t)e * a.K * a.N;
  for (int u = lane; u < KS * (BN / 4); u += 32) {
    const int r = u / (BN / 4), c = 4 * (u % (BN / 4));
    const int k = k0 + r, n = n0 + c;
    const unsigned v =
        k < a.K ? dec::load4(w + (size_t)k * a.N + n, a.N - n, a.vec_w) : 0u;
    *reinterpret_cast<unsigned*>(wt + dec::wswz<BN>(r, c)) = v;
  }
  const int8_t* x = a.x + (size_t)e * a.R * a.K;
  for (int u = lane; u < RT * 32; u += 32) {
    const int r = u / 32, c = 4 * (u % 32);
    const int m = m0 + r, k = k0 + c;
    const unsigned v =
        m < a.R ? dec::load4(x + (size_t)m * a.K + k, a.K - k, a.vec_x) : 0u;
    *reinterpret_cast<unsigned*>(xt + dec::xswz(r, c)) = v;
  }
}

// a lane's A registers of k32 step j from an m16 tile of an x box (16 rows,
// 2048 bytes) with one ldmatrix.x4: matrix q is rows 8 (q & 1) .. + 7 of
// the step's 16-byte K chunk 2 j + (q >> 1), lane L giving the address of
// row L % 8 of matrix L / 8; a lane receives word t of row g of each, which
// is mma.sync's a0..a3 (A[g][4t..], A[g+8][4t..], A[g][16+4t..],
// A[g+8][16+4t..]) in the plain K order.  The rows of an 8-row group lie in
// 8 distinct swizzled chunks: no bank conflict.
__device__ __forceinline__ void a_tile(int (&a)[4], const uint8_t* tile,
                                       int j, int lane) {
  const int row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int chunk = 2 * j + (lane >> 4);
  const unsigned addr =
      tc::smem_addr(tile + row * 128 + (((chunk ^ row) & 7) << 4));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// one k32 step j of a stage into the warp's MT x 8 fragments, in the plain
// K order: the B words of its 64 columns once (lane (g, t) loads 8 bytes
// at column 64 wn + 8 g of rows 16 h + 4 t + r, r = 0..3, and transposes
// them in registers: tile T's b_h is weight column 64 wn + 8 g + T; lanes
// t and t + 2 share a swizzle row, a 2-way bank conflict), then each live
// m16 tile's A words (rows 16 (wm + WM i) of the box)
template <int WM, int MT>
__device__ __forceinline__ void k32_step(int (&acc)[MT][NT][4],
                                         const uint8_t* wt,
                                         const uint8_t* xt, int j, int wm,
                                         int wn, int lane, int live) {
  const int g = lane / 4, t = lane % 4;
  const int col = 64 * wn + 8 * g;
  const uint8_t* base = wt + j * 32 * BN + (col & 15);
  int bw[NT][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint2 w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * h + 4 * t + r;
      w[r] = *reinterpret_cast<const uint2*>(
          base + row * 128 + ((((col >> 4) ^ row) & 7) << 4));
    }
    const int4 lo = tc::transpose4(w[0].x, w[1].x, w[2].x, w[3].x);
    const int4 hi = tc::transpose4(w[0].y, w[1].y, w[2].y, w[3].y);
    bw[0][h] = lo.x; bw[1][h] = lo.y; bw[2][h] = lo.z; bw[3][h] = lo.w;
    bw[4][h] = hi.x; bw[5][h] = hi.y; bw[6][h] = hi.z; bw[7][h] = hi.w;
  }
  const uint8_t* xw = xt + 2048 * wm;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= live) break;
    int af[4];
    a_tile(af, xw + 2048 * WM * i, j, lane);
#pragma unroll
    for (int T = 0; T < NT; ++T) tc::mma_s8(acc[i][T], af, bw[T][0], bw[T][1]);
  }
}

// a consumer warp's 64 columns (from n0) of expert e's bias row (zero
// where absent) and multiplier row (rq.b where per-tensor), copied into
// its 128 ints of shared memory with cp.async when the item starts, so the
// loads' latency hides behind the K loop and the epilogue reads shared
// memory; columns past N are zero-filled
__device__ __forceinline__ void fetch_cols(int* wc, const Args& a, int e,
                                           int n0, int lane) {
  const int* bias = a.bias + (size_t)e * a.N;
  const int* bvec = a.bvec + (size_t)e * a.N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h, n = n0 + c;
    const int ok = n < a.N ? 4 : 0;
    if (a.bias != nullptr)
      tc::cp_async4(tc::smem_addr(wc + c), ok ? bias + n : bias, ok);
    else
      wc[c] = 0;
    if (a.rq.kind == RQ_PER_CHANNEL)
      tc::cp_async4(tc::smem_addr(wc + 64 + c), ok ? bvec + n : bvec, ok);
    else
      wc[64 + c] = a.rq.b;
  }
  tc::cp_commit();
}

// the epilogue of one output row m (< rows[e]) of expert e: v[c] is column
// n0 + c, c < 16, cols its bias (cols[c]) and multipliers (cols[64 + c]);
// bias, requant, clip, store, four columns at a time (a word or an int4
// where the row allows)
__device__ __forceinline__ void store_row(const Args& a, const int* cols,
                                          int e, int m, int n0,
                                          const int (&v)[16]) {
  const size_t o = ((size_t)e * a.R + m) * a.N + n0;
  const bool vec = n0 + 16 <= a.N && a.N % 4 == 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int last = a.N - 1 - n0 - 4 * q;     // >= 0: n0 + 4 q < N
    if (last < 0) break;
    const int4 b4 = *reinterpret_cast<const int4*>(cols + 4 * q);
    const int4 m4 = *reinterpret_cast<const int4*>(cols + 64 + 4 * q);
    int r[4] = {wadd(v[4 * q], b4.x), wadd(v[4 * q + 1], b4.y),
                wadd(v[4 * q + 2], b4.z), wadd(v[4 * q + 3], b4.w)};
    if (a.rq.kind != RQ_RAW) {
      r[0] = requant(r[0], a.rq, m4.x);
      r[1] = requant(r[1], a.rq, m4.y);
      r[2] = requant(r[2], a.rq, m4.z);
      r[3] = requant(r[3], a.rq, m4.w);
    }
    if (a.out_is_int8) {
      int8_t* p = reinterpret_cast<int8_t*>(a.out) + o + 4 * q;
      if (vec) {
        *reinterpret_cast<unsigned*>(p) =
            (unsigned)(uint8_t)r[0] | (unsigned)(uint8_t)r[1] << 8 |
            (unsigned)(uint8_t)r[2] << 16 | (unsigned)(uint8_t)r[3] << 24;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u <= last) p[u] = (int8_t)r[u];
      }
    } else {
      int* p = reinterpret_cast<int*>(a.out) + o + 4 * q;
      if (vec) {
        *reinterpret_cast<int4*>(p) = make_int4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u <= last) p[u] = r[u];
      }
    }
  }
}

// rows mt (lane row g) and mt + 8 of one m16 tile, columns n0.. of the
// lane: tile T's c0 / c1 are columns 8 (2 t) + T and 8 (2 t + 1) + T of row
// g (c2 / c3 of row g + 8), i.e. 16 consecutive columns from 16 t
__device__ __forceinline__ void store_tile(const Args& a, const int* cols,
                                           const int (&f)[NT][4], int e,
                                           int m_end, int mt, int n0) {
  if (n0 >= a.N) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mt + 8 * h;
    if (m >= m_end) continue;
    int v[16];
#pragma unroll
    for (int T = 0; T < NT; ++T) {
      v[T] = f[T][2 * h];
      v[8 + T] = f[T][2 * h + 1];
    }
    store_row(a, cols, e, m, n0, v);
  }
}

template <int WM, int MT>
__global__ void __launch_bounds__(Shape<WM, MT>::THREADS, WM == 1 ? 2 : 1)
int8_matmul_grouped_kernel(const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap xmap,
                           const Args a) {
  using S = Shape<WM, MT>;
  constexpr int CONSUMERS = S::CONSUMERS;
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int s_live;
  // 1024-byte aligned ring (the swizzle patterns repeat every 1024 bytes),
  // then decode's exchange buffers, the consumer warps' epilogue columns,
  // the experts' row counts and the list of the live ones
  uint8_t* ring = dyn + ((1024 - (tc::smem_addr(dyn) & 1023)) & 1023);
  int4* xchg = reinterpret_cast<int4*>(ring + S::RING);
  int* colbuf = reinterpret_cast<int*>(ring + S::RING + S::XCHG);
  int* cnt = colbuf + S::COLS / 4;
  int* live = cnt + a.E;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int C = a.cluster;
  const unsigned rank = C > 1 ? cluster_rank() : 0u;

  if (warp == CONSUMERS && lane == 0 && a.use_tma) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&wmap) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&xmap) : "memory");
  }
  for (int i = tid; i < a.E; i += S::THREADS)
    cnt[i] = min(max(a.rows[i], 0), a.R);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      dec::mbar_init(tc::smem_addr(&full[s]), a.use_tma ? 1u : 32u);
      dec::mbar_init(tc::smem_addr(&empty[s]), 32u * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {                             // compact the live experts
    int n = 0;
    for (int b = 0; b < a.E; b += 32) {
      const int i = b + lane;
      const bool on = i < a.E && cnt[i] > 0;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) live[n + __popc(m & ((1u << lane) - 1u))] = i;
      n += __popc(m);
    }
    if (lane == 0) s_live = n;
  }
  __syncthreads();

  // the split, from what every block of the cluster sees alike: S ranks a
  // group split an item's K (a power of two up to C), the largest whose
  // item ranks stay within the grid's blocks, two stages a rank on average
  // and none empty; the C / S groups of a cluster take distinct items
  const int ntiles = (a.N + BN - 1) / BN;
  const int items = s_live * ntiles;
  const int stages = (a.K + KS - 1) / KS;
  int split = 1;
  for (int c2 = 2; WM == 1 && c2 <= C; c2 *= 2)
    if (items * c2 <= (int)gridDim.x && 2 * c2 <= stages &&
        (c2 - 1) * ((stages + c2 - 1) / c2) < stages)
      split = c2;
  // a split group stores into its ranks' shared memory: every block of
  // the cluster runs before the first remote store
  if (split > 1) cluster_sync();
  const int groups = C / split, sub = (int)rank % split;
  const int worker = (blockIdx.x / C) * groups + (int)rank / split;
  const int workers = (gridDim.x / C) * groups;
  const int kper = (stages + split - 1) / split * KS;
  const int kbeg = sub * kper;
  const int nk = (min(a.K, kbeg + kper) - kbeg + KS - 1) / KS;
  // rounds of items: a split group's ranks meet once a round (all of the
  // cluster's, as many rounds as its first group has items)
  const int first = (blockIdx.x / C) * groups;
  const int rounds =
      split > 1 ? (items > first ? (items - first + workers - 1) / workers : 0)
                : (items > worker ? (items - worker + workers - 1) / workers
                                  : 0);

  if (warp == CONSUMERS) {                     // the producer
    int it = 0;
    for (int j = 0; j < rounds; ++j) {
      const int item = worker + j * workers;
      if (item < items) {
        const int e = live[item / ntiles], n0 = (item % ntiles) * BN;
        const int chunks = (cnt[e] + S::RT - 1) / S::RT;
        for (int ch = 0; ch < chunks; ++ch)
          for (int s = 0; s < nk; ++s, ++it) {
            const int slot = it % STAGES;
            const unsigned ph = ((it / STAGES) & 1) ^ 1u;
            uint8_t* wt = ring + slot * S::STAGE;
            uint8_t* xt = wt + WBYTES;
            const int k0 = kbeg + s * KS;
            if (a.use_tma) {
              if (lane == 0) {
                const unsigned bar = tc::smem_addr(&full[slot]);
                dec::mbar_wait(tc::smem_addr(&empty[slot]), ph);
                dec::mbar_expect_tx(bar, S::STAGE);
                dec::tma_load_3d(tc::smem_addr(wt), &wmap, n0, k0, e, bar);
                dec::tma_load_3d(tc::smem_addr(xt), &xmap, k0, ch * S::RT,
                                 e, bar);
              }
            } else {
              dec::mbar_wait(tc::smem_addr(&empty[slot]), ph);
              copy_stage<S::RT>(wt, xt, a, e, n0, k0, ch * S::RT, lane);
              dec::mbar_arrive(tc::smem_addr(&full[slot]));
            }
          }
      }
      if (split > 1) {            // round j's barrier, arrived early: the
        __syncwarp();             // ring streams round j + 1 meanwhile
        if (j > 0) cluster_wait();
        cluster_arrive();
      }
    }
    if (split > 1 && rounds > 0) {
      __syncwarp();
      cluster_wait();
    }
    return;
  }

  // the consumers
  const int wm = warp / WN, wn = warp % WN;
  const int pair = 4 * wn + t;                 // the lane's 16 columns
  int* wc = colbuf + 128 * warp;               // the warp's 64 columns
  int it = 0;
  // one item's (or row chunk's) K range from the ring into acc: the warp's
  // m16 tiles i (rows m0 + 16 (wm + WM i)) below m_e
  auto consume = [&](int (&acc)[MT][NT][4], int m0, int m_e) {
    const int left = m_e - m0 - 16 * wm;
    const int live_mt =
        left > 0 ? min(MT, (left + 16 * WM - 1) / (16 * WM)) : 0;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int T = 0; T < NT; ++T)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][T][q] = 0;
    for (int s = 0; s < nk; ++s, ++it) {
      const int slot = it % STAGES;
      dec::mbar_wait(tc::smem_addr(&full[slot]), (it / STAGES) & 1);
      const uint8_t* wt = ring + slot * S::STAGE;
      const uint8_t* xt = wt + WBYTES;
      if (live_mt > 0) {
        // decode: the stage's four k32 steps in flight together; row
        // tiles: one at a time (their accumulators take most registers)
        if constexpr (MT == 1) {
#pragma unroll
          for (int jj = 0; jj < KS / 32; ++jj)
            k32_step<WM, MT>(acc, wt, xt, jj, wm, wn, lane, live_mt);
        } else {
#pragma unroll 1
          for (int jj = 0; jj < KS / 32; ++jj)
            k32_step<WM, MT>(acc, wt, xt, jj, wm, wn, lane, live_mt);
        }
      }
      dec::mbar_arrive(tc::smem_addr(&empty[slot]));
    }
    return live_mt;
  };
  for (int j = 0; j < rounds; ++j) {
    const int item = worker + j * workers;
    const bool busy = item < items;
    const int e = busy ? live[item / ntiles] : 0;
    const int n0 = busy ? (item % ntiles) * BN : 0;
    const int m_e = busy ? cnt[e] : 0;
    const int ncol = n0 + 64 * wn + 16 * t;
    __syncwarp();                  // every lane is done with the last item's
    if (busy) fetch_cols(wc, a, e, n0 + 64 * wn, lane);          // columns
    int acc[MT][NT][4];
    if (split == 1) {
      for (int m0 = 0; m0 < m_e; m0 += S::RT) {
        const int live_mt = consume(acc, m0, m_e);
        tc::cp_wait<0>();
        __syncwarp();
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (i < live_mt)
            store_tile(a, wc + 16 * t, acc[i], e, m_e,
                       m0 + 16 * (wm + WM * i) + g, ncol);
      }
      continue;
    }
    // decode split across the group (WM = MT = 1): the lane's partial to
    // the group's rank that owns its (wn, t), the round's barrier, then
    // the owner adds the group's partials and stores
    const int owner = pair % split, idx = pair / split;
    int4* buf = xchg + (j & 1) * XCHG_INT4;
    if (busy) {
      consume(acc, 0, m_e);
      if (owner != sub) {
        const unsigned dst =
            map_rank(tc::smem_addr(buf), rank - sub + owner) +
            16 * (((sub * (PAIRS / split) + idx) * 8 + g) * NT);
#pragma unroll
        for (int T = 0; T < NT; ++T)
          st_cluster(dst + 16 * T, make_int4(acc[0][T][0], acc[0][T][1],
                                             acc[0][T][2], acc[0][T][3]));
      }
    }
    __syncwarp();
    cluster_arrive_release();
    cluster_wait();
    // every lane copied some of the warp's epilogue columns, and a lane's
    // cp.async wait covers its own copies only: all wait, then meet
    tc::cp_wait<0>();
    __syncwarp();
    if (!busy || owner != sub) continue;
    for (int r = 0; r < split; ++r) {
      if (r == sub) continue;
      const int4* p = buf + ((r * (PAIRS / split) + idx) * 8 + g) * NT;
#pragma unroll
      for (int T = 0; T < NT; ++T) {
        const int4 q = p[T];
        acc[0][T][0] = wadd(acc[0][T][0], q.x);
        acc[0][T][1] = wadd(acc[0][T][1], q.y);
        acc[0][T][2] = wadd(acc[0][T][2], q.z);
        acc[0][T][3] = wadd(acc[0][T][3], q.w);
      }
    }
    store_tile(a, wc + 16 * t, acc[0], e, m_e, g, ncol);
  }
}

template <int WM, int MT>
int launch(const Args& a, const void* wmap, const void* xmap, int blocks,
           int smem, cudaStream_t s) {
  using S = Shape<WM, MT>;
  auto kern = int8_matmul_grouped_kernel<WM, MT>;
  // the dynamic shared memory grows with E (the live list): raise the
  // kernel's limit when a launch needs more than the last one allowed
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  CUtensorMap wm, xm;
  std::memset(&wm, 0, sizeof wm);
  std::memset(&xm, 0, sizeof xm);
  if (wmap != nullptr) std::memcpy(&wm, wmap, sizeof wm);
  if (xmap != nullptr) std::memcpy(&xm, xmap, sizeof xm);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(S::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, wm, xm, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace grp
}  // namespace r8

// rt: the row tile, 16 (R <= 16: decode, in clusters of a->cluster blocks
// that split K as the live items allow) or 48, 96, 192; blocks: the grid
// (a whole number of clusters); smem: the dynamic shared memory
// (kernels/int8_matmul.py::grouped_plan); wmap / xmap: the 3-D tensor maps
// of w and x (the TMA route) or both null (the copy route)
extern "C" int r8_int8_matmul_grouped(const r8::grp::Args* a,
                                      const void* wmap, const void* xmap,
                                      int rt, int blocks, int smem,
                                      void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((wmap == nullptr) != (xmap == nullptr) ||
      a->use_tma != (wmap != nullptr) || a->cluster < 1 || a->cluster > 8 ||
      blocks < 1 || blocks % a->cluster != 0 ||
      (rt != 16 && a->cluster != 1) || smem > r8::grp::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  switch (rt) {
    case 16: return r8::grp::launch<1, 1>(*a, wmap, xmap, blocks, smem, s);
    case 48: return r8::grp::launch<3, 1>(*a, wmap, xmap, blocks, smem, s);
    case 96: return r8::grp::launch<3, 2>(*a, wmap, xmap, blocks, smem, s);
    case 192: return r8::grp::launch<3, 4>(*a, wmap, xmap, blocks, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: the row tile RT; the cluster
// lies along grid x); out[6]
extern "C" int r8_attrs_int8_matmul_grouped(const int* sel, int threads,
                                            int smem, int cluster, int* out) {
  using r8::grp::int8_matmul_grouped_kernel;
  switch (sel[0]) {
    case 16:
      return r8::attrs(int8_matmul_grouped_kernel<1, 1>, threads, smem,
                       cluster, 1, out);
    case 48:
      return r8::attrs(int8_matmul_grouped_kernel<3, 1>, threads, smem,
                       cluster, 1, out);
    case 96:
      return r8::attrs(int8_matmul_grouped_kernel<3, 2>, threads, smem,
                       cluster, 1, out);
    case 192:
      return r8::attrs(int8_matmul_grouped_kernel<3, 4>, threads, smem,
                       cluster, 1, out);
  }
  return (int)cudaErrorInvalidValue;
}
