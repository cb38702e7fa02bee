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
// Two routes, chosen by the wrapper from the shape alone
// (kernels/int8_matmul.py::msr4_plan): the tensor-core route for every
// group whose K step fits the shared memory (all of llama3-8b's leaves at
// group 64), the gather route for larger groups (the g = K fallback of a
// long K).
//
// What bounds it: the lanes, 3 bytes (int16 index, int8 delta) per (group,
// lane, column), each read once per output tile; with per-channel abs-max
// int8 weights ~82 % of them are outliers, so n_out = g and the lanes are
// 3x the int8 weight bytes (w1: 176 MB, 53 us at 3.35 TB/s).  As a dense
// product over the deltas the operations are 2 M K N on the int8 tensor
// cores (w1 at M = 128: 15 G, 7.6 us at 1979 T/s), far below the bytes.
//
// * Design, tensor-core route (msr4_correct_mma_kernel<BM>): the
//   correction is x times a dense (K, N) delta matrix D that the lanes
//   describe sparsely, so a block builds D's tile in shared memory from
//   the lanes and multiplies with mma.sync.m16n8k32 s8 x s8 -> s32.  A
//   block of 8 warps owns BM rows (16 for M <= 16, else 64 or 128) and
//   BN = 128 columns, and walks K in steps of whole groups (max(1, 64 / g)
//   groups, kc rows, the tile sp = kc rounded up to 32 rows), so each lane
//   is read once per output tile.  Per step:
//     - the lanes of the step's groups are contiguous rows of the (K / g *
//       n_out, N) lane arrays; they come in chunks of lc lane rows (64 at
//       most: 16 KB of idx, 8 KB of val) by cp.async 16-byte copies into
//       a ring of 2 slots, one chunk in flight while the last is
//       scattered; with the step's first chunk, x's BM x sp tile
//       (K-contiguous rows, zero-filled past M and past the step's rows)
//       goes by cp.async into one of 2 x buffers: K1's sx A fragments,
//       row stride sp / 4 + 4
//       words (sp / 4 is a multiple of 8, so a0's bank (stride * g + t)
//       mod 32 is distinct over the 32 lanes);
//     - each in-range lane writes its delta as one byte into a zeroed
//       tile at word (row / 4, column), byte row % 4: the "4 K values of
//       one column" words of K1's sw, which are mma's .col B fragments as
//       they stand.  The tile's word-row stride is 128 words (not K1's
//       136), so a word's bank depends on its column alone, and the
//       column is swizzled, c' = (c & ~3) | ((c + c / 32) & 3): a warp
//       scatters one lane row, lane i columns 4i..4i+3, and the 32 byte
//       stores of each of its 4 store instructions hit 32 distinct banks
//       whatever the rows (the rows are data).  The price: a B fragment
//       load of 8 columns x 4 word rows hits 8 banks (4-way), a quarter
//       as many loads as the scatter's stores.  Tiles are double-buffered:
//       a step zeroes the next step's tile while it scatters its own;
//     - after a barrier, the warps multiply x's tile by the delta tile
//       (fragments as in K1: a0 = sx[g][kb+t], b0 = tile[kb+t][col g]).
//   What bounds it as built (PERF.md): about 2x the lanes' bytes at M = 4
//   and 3.5x at M = 128.  A block's steps are latency-bound phases (wait
//   for the chunk, scatter, barrier, product) with 2 or 3 blocks an SM
//   to overlap them, and a split's fixed costs (the first chunk's
//   latency, the workspace atomics and the last-arriver handshake) are
//   paid by every block.  Tried and no faster on this card: a ring of 3
//   or 4 lane chunks of 16 to 64 rows, and three tiles with a step's
//   product deferred behind the next chunk's barrier (one barrier a
//   chunk, the product beside the next scatter).
//   The dense tile holds one delta per (row, column), so it is exact only
//   where a column's in-range lanes within a group name distinct rows:
//   pack_msr4 guarantees it (a stable-sort prefix) and interop checks it
//   once per leaf it carries across; nothing checks it per call.  A lane
//   index outside [0, g) adds nothing.  Where K, N or a pointer is not
//   aligned for the 16-byte copies (x_vec / idx_vec / val_vec), the same
//   kernel takes masked scalar copies.
// * Design, gather route (msr4_correct_kernel<MT>, the first design): a
//   block of 128 threads owns 128 columns (the lane loads coalesce along
//   N) and MT rows (4 for decode, else 16), so a lane read from memory
//   serves MT rows; it stages x of those rows for a run of whole groups in
//   shared memory, transposed ([row][MT] bytes), so one 4- or 16-byte load
//   fetches a gathered row's x for all MT rows, and runs every lane as a
//   gather and MT multiply-adds on the CUDA cores.  It needs no dense
//   tile, so it takes any group.
//
// Both routes split K across blocks (grid.z) where the output tiles
// cannot fill the card (decode): each split adds its partial sums into a
// zeroed int32 workspace with atomicAdd and the last split to arrive (a
// per-tile counter) runs the epilogue on acc + the sums, as K1's split-K
// does.  acc is only read.  Folding the correction into K1's own launch,
// with no int32 round trip, is a later, smaller speed item.
#include "int_common.cuh"
#include "int_mma.cuh"
#include "int_attrs.cuh"

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
  int kc;                      // K rows staged at a time (gather) or a
                               // step (tensor cores): whole groups
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

// ------------------------------------------------- tensor-core route ----

using tc::cp_async16;
using tc::cp_commit;
using tc::cp_wait;
using tc::mma_s8;
using tc::smem_addr;

constexpr int MMA_THREADS = 256;   // 8 warps
constexpr int BN = 128;            // columns a block
constexpr int SW = BN;             // delta tile word-row stride (words)
constexpr int LANE_ROW = 3 * BN;   // staged bytes a lane row (idx + val)
constexpr int STAGES = 2;          // lane chunks (and x tiles) in the ring

// the gather route's Args (kept as they were) and the tensor-core route's
// own (kernels/int8_matmul.py::msr4_plan)
struct MmaArgs : Args {
  int lc;                      // lane rows a staged chunk
  int sp;                      // rows of a step's delta tile (kc up to 32)
  int x_vec, idx_vec, val_vec; // 16-byte cp.async copies, else scalar
};

// the delta tile's word column of column c (see the note): the low two
// bits rotated by c / 32
__device__ __forceinline__ int swz(int c) {
  return (c & ~3) | ((c + (c >> 5)) & 3);
}

// one lane row's 4 columns of this thread (indices iw, deltas vw) into the
// delta tile tb at group row base: a byte at word (row / 4, swz(col)),
// byte row % 4 (colb: 4 swz(col)); an index outside [0, g) adds nothing
__device__ __forceinline__ void scatter4(unsigned char* tb, uint2 iw,
                                         unsigned vw, int base, int g,
                                         const int (&colb)[4]) {
  const int r4[4] = {(int)(short)(iw.x & 0xFFFFu), (int)iw.x >> 16,
                     (int)(short)(iw.y & 0xFFFFu), (int)iw.y >> 16};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if ((unsigned)r4[jj] < (unsigned)g) {
      const int row = base + r4[jj];
      tb[(row & ~3) * SW + (row & 3) + colb[jj]] =
          (unsigned char)(vw >> (8 * jj));
    }
  }
}

// lane rows [lrow0, lrow0 + rows) x columns n0..n0+127 into a ring slot:
// idx [rows][BN] int16, then val [lc][BN] int8; columns past N stage as
// index 0 / delta 0 (16-byte copies) or index -1 (scalar), adding nothing
__device__ __forceinline__ void copy_lanes(unsigned char* slot,
                                           const MmaArgs& a,
                                           size_t lrow0, int rows, int n0) {
  int16_t* sidx = reinterpret_cast<int16_t*>(slot);
  int8_t* sval = reinterpret_cast<int8_t*>(slot + 2 * BN * a.lc);
  const int16_t* gidx = a.idx + lrow0 * a.N + n0;
  const int8_t* gval = a.val + lrow0 * a.N + n0;
  const int ncol = a.N - n0;
  if (a.idx_vec) {                 // N % 8 == 0: 8 columns all in or out
    for (int i = threadIdx.x; i < rows * (BN / 8); i += MMA_THREADS) {
      const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
      const bool ok = c < ncol;
      cp_async16(smem_addr(sidx + r * BN + c),
                 ok ? gidx + (size_t)r * a.N + c : a.idx, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * BN; i += MMA_THREADS) {
      const int r = i / BN, c = i % BN;
      sidx[r * BN + c] = c < ncol ? gidx[(size_t)r * a.N + c] : (int16_t)-1;
    }
  }
  if (a.val_vec) {                 // N % 16 == 0
    for (int i = threadIdx.x; i < rows * (BN / 16); i += MMA_THREADS) {
      const int r = i / (BN / 16), c = 16 * (i % (BN / 16));
      const bool ok = c < ncol;
      cp_async16(smem_addr(sval + r * BN + c),
                 ok ? gval + (size_t)r * a.N + c : a.val, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * BN; i += MMA_THREADS) {
      const int r = i / BN, c = i % BN;
      sval[r * BN + c] = c < ncol ? gval[(size_t)r * a.N + c] : (int8_t)0;
    }
  }
}

// x rows m0..m0+BM-1, K columns [k0, k0 + kn) -> xs words [BM][sxw], zero
// past M and from kn up to the tile's sp columns
template <int BM>
__device__ __forceinline__ void copy_x(int* xs, const MmaArgs& a, int m0,
                                       int k0, int kn) {
  const int sxw = a.sp / 4 + 4;
  if (a.x_vec) {                   // K, k0 and x 16-byte aligned
    const int cpr = a.sp / 16;
    for (int i = threadIdx.x; i < BM * cpr; i += MMA_THREADS) {
      const int r = i / cpr, c = 16 * (i % cpr);
      const int m = m0 + r;
      const int valid = (m < a.M && c < kn) ? min(16, kn - c) : 0;
      cp_async16(smem_addr(xs + r * sxw + c / 4),
                 valid ? a.x + (size_t)m * a.K + k0 + c : a.x, valid);
    }
  } else {
    const int wpr = a.sp / 4;
    for (int i = threadIdx.x; i < BM * wpr; i += MMA_THREADS) {
      const int r = i / wpr, c = 4 * (i % wpr);
      const int m = m0 + r;
      unsigned v = 0u;
      if (m < a.M) {
        const int8_t* p = a.x + (size_t)m * a.K + k0 + c;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < kn) v |= (unsigned)(uint8_t)p[j] << (8 * j);
      }
      xs[r * sxw + c / 4] = (int)v;
    }
  }
}

// BM = 16: 8 warps along N (16 columns each); BM = 64 / 128: 2 along M x
// 4 along N (BM / 2 rows x 32 columns each)
template <int BM>
__global__ void __launch_bounds__(MMA_THREADS, BM == 16 ? 3 : 2)
msr4_correct_mma_kernel(const MmaArgs a) {
  constexpr int WM = BM == 16 ? 1 : 2, WN = 8 / WM;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int fg = lane / 4, ft = lane % 4;        // fragment row / k word
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int g = a.g, n_out = a.n_out, lc = a.lc;
  const int gps = a.kc / g;                      // groups a step
  const int sxw = a.sp / 4 + 4;                  // x row stride (words)
  const int tile_words = a.sp / 4 * SW;
  const int gbeg = blockIdx.z * a.groups_per_split;
  const int gend = min(a.K / g, gbeg + a.groups_per_split);
  const int cps = n_out ? (gps * n_out + lc - 1) / lc : 0;   // chunks a step
  const int nchunks = n_out ? (gend - gbeg + gps - 1) / gps * cps : 0;

  unsigned char* const lanes0 = smem;            // [STAGES][lc] lane rows
  int* const xs0 = reinterpret_cast<int*>(smem + STAGES * LANE_ROW * lc);
  int* const tl0 = xs0 + STAGES * BM * sxw;      // [2][sp / 4][SW]

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // chunk u: lane rows [j lc, ...) of step s = u / cps into slot u %
  // STAGES; with the step's first chunk, x of the step into xs[s %
  // STAGES] (free: step s - STAGES read it last in its product, at the end
  // of chunk (s - STAGES + 1) cps - 1; this copy is issued after the
  // barrier of chunk s cps - STAGES + 1, later since (STAGES - 1) cps >
  // STAGES - 2)
  auto issue = [&](int u) {
    if (u < nchunks) {
      const int s = u / cps, j = u - s * cps;
      const int grp0 = gbeg + s * gps, gl = min(gps, gend - grp0);
      const int rows = min(lc, gl * n_out - j * lc);
      if (rows > 0)
        copy_lanes(lanes0 + (u % STAGES) * LANE_ROW * lc, a,
                   (size_t)grp0 * n_out + (size_t)j * lc, rows, n0);
      if (j == 0) copy_x<BM>(xs0 + (s % STAGES) * BM * sxw, a, m0,
                             grp0 * g, gl * g);
    }
    cp_commit();
  };
  auto zero_tile = [&](int* tl) {
    int4* p = reinterpret_cast<int4*>(tl);
    for (int i = tid; i < tile_words / 4; i += MMA_THREADS)
      p[i] = make_int4(0, 0, 0, 0);
  };

  // this thread's scatter unit: columns 4 lane .. 4 lane + 3 of a lane
  // row (a warp a whole row), as byte offsets within a tile word row
  int colb[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) colb[jj] = 4 * swz(4 * lane + jj);
  // its B fragment columns, one per m16n8 product along N
  int bcol[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) bcol[j] = swz(wn * WTN + 8 * j + fg);

  if (nchunks > 0) {
    zero_tile(tl0);
#pragma unroll
    for (int u = 0; u < STAGES - 1; ++u) issue(u);
  }
  for (int u = 0; u < nchunks; ++u) {
    cp_wait<STAGES - 2>();         // chunk u has landed
    __syncthreads();               // ... for all; chunk u-1 scattered
    issue(u + STAGES - 1);         // into the slot chunk u-1 used
    const int s = u / cps, j = u - s * cps;
    const int grp0 = gbeg + s * gps, gl = min(gps, gend - grp0);
    int* const tl = tl0 + (s & 1) * tile_words;
    if (j == 0) zero_tile(tl0 + ((s + 1) & 1) * tile_words);
    {
      // scatter: lane rows warp, warp + 8, ... of the chunk
      const int rows = min(lc, gl * n_out - j * lc);
      const unsigned char* slot = lanes0 + (u % STAGES) * LANE_ROW * lc;
      const int16_t* sidx = reinterpret_cast<const int16_t*>(slot);
      const int8_t* sval = reinterpret_cast<const int8_t*>(slot + 2 * BN * lc);
      unsigned char* tb = reinterpret_cast<unsigned char*>(tl);
      const int lr = j * lc + warp;              // lane row of the step
      int q = lr / n_out, l = lr - q * n_out;    // its group, its lane
      for (int rr = warp; rr < rows; rr += 8) {
        scatter4(tb, *reinterpret_cast<const uint2*>(sidx + rr * BN + 4 * lane),
                 *reinterpret_cast<const unsigned*>(sval + rr * BN + 4 * lane),
                 q * g, g, colb);
        for (l += 8; l >= n_out; l -= n_out) ++q;
      }
    }
    if (j == cps - 1) {
      __syncthreads();             // the step's tile is whole
      const int* xs =
          xs0 + (s % STAGES) * BM * sxw + (wm * WTM + fg) * sxw + ft;
      const int* tw = tl + ft * SW;
#pragma unroll 1
      for (int kb = 0; kb < a.sp / 4; kb += 8) {
        int b[NT][2];
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          b[jn][0] = tw[kb * SW + bcol[jn]];
          b[jn][1] = tw[(kb + 4) * SW + bcol[jn]];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int* r = xs + 16 * i * sxw + kb;
          const int av[4] = {r[0], r[8 * sxw], r[4], r[8 * sxw + 4]};
#pragma unroll
          for (int jn = 0; jn < NT; ++jn)
            mma_s8(acc[i][jn], av, b[jn][0], b[jn][1]);
        }
      }
    }
  }

  // this thread's outputs: rows mw + 16 i + 8 h, columns nw + 8 j (+1)
  const int mw = m0 + wm * WTM + fg;
  const int nw = n0 + wn * WTN + 2 * ft;
  if (gridDim.z > 1) {
    // split K: add this split's sums, the last split finishes
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mw + 16 * i + 8 * (e / 2);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int n = nw + 8 * jn + (e % 2);
          if (m < a.M && n < a.N)
            atomicAdd(&a.ws[(size_t)m * a.N + n], acc[i][jn][e]);
        }
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
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mw + 16 * i + 8 * (e / 2);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int n = nw + 8 * jn + (e % 2);
          if (m < a.M && n < a.N)
            acc[i][jn][e] = __ldcg(&a.ws[(size_t)m * a.N + n]);
        }
      }
  }

  // epilogue: acc + the correction + bias, requant, clip, store (column
  // pairs where N is even: the output is a fresh, aligned tensor)
  const bool pair = (a.N % 2) == 0;
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    const int n = nw + 8 * jn;
    if (n >= a.N) continue;
    const bool two = n + 1 < a.N;
    const int bias0 = a.bias != nullptr ? a.bias[n] : 0;
    const int bias1 = a.bias != nullptr && two ? a.bias[n + 1] : 0;
    int b0 = a.rq.b, b1 = a.rq.b;
    if (a.rq.kind == RQ_PER_CHANNEL) {
      b0 = a.bvec[n];
      b1 = two ? a.bvec[n + 1] : 0;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mw + 16 * i + 8 * h;
        if (m >= a.M) continue;
        const size_t o = (size_t)m * a.N + n;
        int v0 = wadd(wadd(a.acc[o], acc[i][jn][2 * h]), bias0);
        int v1 = two ? wadd(wadd(a.acc[o + 1], acc[i][jn][2 * h + 1]), bias1)
                     : 0;
        if (a.rq.kind != RQ_RAW) {
          v0 = requant(v0, a.rq, b0);
          v1 = requant(v1, a.rq, b1);
        }
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
int launch_mma(const MmaArgs& a, int splits, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        msr4_correct_mma_kernel<BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, splits);
  msr4_correct_mma_kernel<BM><<<grid, MMA_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace msr4
}  // namespace r8

// the gather route: mt rows a block (4 or 16), splits: grid.z, smem:
// bytes of the staged x (kernels/int8_matmul.py::msr4_plan)
extern "C" int r8_int8_matmul_msr4(const r8::msr4::Args* a, int mt,
                                   int splits, int smem, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mt == 4) return r8::msr4::launch<4>(*a, splits, smem, s);
  if (mt == 16) return r8::msr4::launch<16>(*a, splits, smem, s);
  return (int)cudaErrorInvalidValue;
}

// the tensor-core route: bm rows a block (16, 64 or 128), splits: grid.z,
// smem: bytes of the lane ring, the x tiles and the delta tiles
// (kernels/int8_matmul.py::msr4_plan)
extern "C" int r8_int8_matmul_msr4_mma(const r8::msr4::MmaArgs* a, int bm,
                                       int splits, int smem, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bm == 16) return r8::msr4::launch_mma<16>(*a, splits, smem, s);
  if (bm == 64) return r8::msr4::launch_mma<64>(*a, splits, smem, s);
  if (bm == 128) return r8::msr4::launch_mma<128>(*a, splits, smem, s);
  return (int)cudaErrorInvalidValue;
}

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: route (1 the tensor cores, 0 the
// gather), rows a block); out[6]
extern "C" int r8_attrs_int8_matmul_msr4(const int* sel, int threads,
                                         int smem, int cluster, int* out) {
  using namespace r8::msr4;
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  if (sel[0]) {
    if (sel[1] == 16)
      return r8::attrs(msr4_correct_mma_kernel<16>, threads, smem, 1, 1, out);
    if (sel[1] == 64)
      return r8::attrs(msr4_correct_mma_kernel<64>, threads, smem, 1, 1, out);
    if (sel[1] == 128)
      return r8::attrs(msr4_correct_mma_kernel<128>, threads, smem, 1, 1,
                       out);
    return (int)cudaErrorInvalidValue;
  }
  if (sel[1] == 4)
    return r8::attrs(msr4_correct_kernel<4>, threads, smem, 1, 1, out);
  if (sel[1] == 16)
    return r8::attrs(msr4_correct_kernel<16>, threads, smem, 1, 1, out);
  return (int)cudaErrorInvalidValue;
}
