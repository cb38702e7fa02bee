// K3: integer decode attention over a paged or contiguous KV cache,
// bit-exact, designed for Hopper.
//
// Replaces the TPU kernel
// repro/kernels/int_decode_attention.py::int_decode_attention_fused
// (body _decode_kernel over _streaming_attn_body): Sq <= 8 query rows a
// lane (row i attends to the positions [0, valid_len - (Sq - 1 - i))),
// the three exact sweeps (row max, row sum of e16, P·V with p8 =
// clip(rshift_round(e16 * (2^30 // sum), 23), 0, 127)) and the
// RequantSpec epilogue.
//
// What bounds it on the H100: neither bytes nor operations, but latency.
// At the serving row (4 lanes, 32 query heads over 8 KV heads, D = 128,
// valid_len <= 512) the live K/V rows are under 2 MB (~0.6 us at
// 3.35 TB/s) and the integer work is far below the tensor cores' rate;
// what costs is the chain of dependent steps between the launch and the
// store: DRAM round trips, barriers, the three reductions.  Design, to
// shorten that chain:
//
// * One group of blocks per (lane b, KV head hk): its rows are those of
//   all G = H / Hkv query heads of the group, row r = (head in group) *
//   Sq + i, packed as the M of mma.sync.m16n8k32 s8 tiles (two m16 tiles,
//   32 rows, a block; zero past the live rows; a group of more than 32
//   rows takes ceil(G Sq / 32) block groups, grid y).  Each K/V row is
//   read from device memory once per group, not once per query head.  Q
//   fragments live in registers (zero past D: a D that is not a multiple
//   of 32 pads its k-steps, int_attention_tc.cuh).
//
// * The key range [0, min(valid_len, L)) is split across a thread block
//   cluster of C <= 8 blocks (grid x): rank rho owns a contiguous run of
//   32-key chunks, [rho P, (rho + 1) P) with P = ceil(t_hi / C) rounded
//   up to 32, so ranks balance whatever valid_len the card holds.  The
//   three sweeps become one read of the keys and three cluster-wide
//   reductions through distributed shared memory (int_cluster.cuh):
//     sweep 0: Q·Kᵀ on the tensor cores, int32 scores kept in shared
//       memory (fragment layout, one int4 a lane and n8 tile); each
//       rank's row max goes to a slot of every rank, one cluster barrier,
//       each rank takes the max of the C slots;
//     sweep 1: e16 = exp16(score - m) from the kept scores (masked to 0
//       past each row's range), kept in place; row sums likewise through
//       slots, then sR = 2^30 // max(s, 1);
//     sweep 2: p8 packed into A fragments, P·V on the tensor cores over
//       the rank's Vᵀ (each warp a quarter of the D columns, every chunk
//       of the rank); the partial (rows x D) int32 sums are added into
//       rank 0's shared memory (red.shared::cluster), one cluster barrier,
//       rank 0 runs the epilogue and stores (B, Sq, H, D).
//   An integer max and int32 sums do not depend on order, row sums stay
//   <= 2^30 under MAX_ROWSUM_LEN and p8 in [0, 127] is a valid s8
//   operand, so every reduction is exact.  A rank with no live key
//   contributes max -2^30, sum 0 and nothing to the P·V sum: a row with
//   no live key anywhere writes requant(0), as the reference does.  A
//   lane whose keys all fall to rank 0 (t_hi <= P: a short lane, or
//   none) skips the cluster: the other ranks leave at once and rank 0
//   reduces in its own shared memory, with no cluster barrier.
//
// * Keys in flight while the block computes: K and V rows of the rank
//   come by cp.async (16-byte granules, 8 where a row is only 8-byte
//   aligned, 4-byte copies where K or V is off that alignment:
//   kernels/int_decode_attention.py::k3_launch_plan), all issued before
//   the first wait (RESIDENT), K and V in two commit groups so sweep 0
//   starts when K has landed.  Paged, the table is read once per key,
//   before any copy, into a row index a key (the division by page_size
//   happens there, not in the copy loop); packed pools' page shifts are
//   read while the copies are in flight.  V lands row-major and is
//   transposed in shared memory (tc::load_v from shared rows, then
//   tc::store_v_at) into the key-permuted, swizzled Vᵀ that P·V reads,
//   over the K tile, free after sweep 0, while the cluster reduces the
//   max.
//
// * Streaming route (not RESIDENT), where a rank's keys, V and scores do
//   not fit the 227 KB a block may have (long caches, up to 2^15
//   positions): tiles of 128 keys (a 32-key chunk a warp) through a
//   double buffer, the next tile's copies in flight while the block
//   computes; Q·Kᵀ recomputed in each sweep (scores are not kept), the
//   three cluster reductions as above.
//
// * PACKED (int4 pools, kv_shifts; paged only): rows of D / 2 bytes and a
//   shift per page.  The packed rows are copied as they are, then
//   expanded in shared memory with each key's page shift into the same
//   int8 K tile (tc::load_kp / store_kp) and, for V, expanded on the way
//   into Vᵀ (tc::load_vp / expand_v): a key moves half the bytes, and
//   the sweeps are the int8 ones.
//
// The folded o-projection is the wrapper's K1 launch on this launch's
// int8 tile: it reduces over every KV group of a lane, a cluster of
// Hkv * C blocks, more than the 8 (16) a cluster may have.
#include "int_attention_tc.cuh"
#include "int_cluster.cuh"
#include "int_attrs.cuh"

namespace r8 {
namespace k3 {

constexpr int THREADS = 128;            // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;               // keys of a P·V k-step; ranks split in chunks
constexpr int TK = 128;                 // keys of a streaming tile: a chunk a warp
constexpr int ROWS = 32;                // query rows a block: two m16 tiles
constexpr int CMAX = 8;                 // blocks a cluster
constexpr int NEG = -(1 << 30);         // row max before any live key
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block

struct Args {
  const int8_t* q;          // (B, S, H, D)
  const int8_t* k;          // pools (num_pages, page_size, Hkv, RB), RB = D
  const int8_t* v;          //   (D / 2 packed), or contiguous (B, L, Hkv, D)
  const int* pages;         // (B, max_pages), or null: contiguous
  const int* vlen;          // (B,) valid_len
  const int* bvec;          // (H * D,) per-channel multipliers or null
  void* out;                // (B, S, H, D) int8 or int32
  const int* k_shift;       // (num_pages,) packed int4 pools, or null
  const int* v_shift;
  int B, S, H, Hkv, D, L;   // L: positions a lane (paged: max_pages * ps)
  int page_size, max_pages; // paged
  int out_is_int8;
  int cluster;              // C: blocks a cluster (grid x)
  int rank_keys;            // keys a rank can hold: ceil(L / C), up to 64s
  int mtb;                  // m16 tiles a block: 1, or 2 past 16 rows
  int resident;             // 1: every key of a rank in shared memory
  int vec;                  // wide copies (16 or 8 bytes), else 4-byte
  int smem;                 // dynamic shared memory (smem_layout().total)
  tc::Exp16 ex;
  Requant rq;
};

// words of a Vᵀ row for `keys` keys: 16 mod 32, so the 8-byte fragment
// loads of P·V (vswz) hit distinct banks
__host__ __device__ constexpr int svp(int keys) {
  return keys / 4 + ((keys / 4) % 32 == 0 ? 16 : 0);
}

__host__ __device__ constexpr int al16(int x) { return (x + 15) / 16 * 16; }

// byte offsets of a block's shared-memory regions (each 16-byte aligned)
struct Smem {
  int k;      // the int8 K tile(s); resident: also Vᵀ once sweep 0 is done
  int kraw;   // packed K rows as copied (PACKED)
  int vraw;   // V rows as copied
  int vt;     // Vᵀ of a streaming tile
  int frag;   // resident: scores / e16 / A fragments; streaming: A fragments
  int rows;   // paged: the pool row of each rank key; PACKED: + K, V shifts
  int red;    // block max and sum, and the C max and sum slots
  int acc;    // rank 0: the cluster's P·V sums, 16 mtb rows x D
  int total;
};

__host__ __device__ inline Smem smem_layout(int D, int keys, int mtb,
                                            bool paged, bool packed,
                                            bool resident) {
  const int skw = tc::sk_words(D), vc = tc::v_cols(D);
  const int rb = packed ? D / 2 : D;
  int kb, krb, vrb, vtb, fb;
  if (resident) {
    kb = 4 * keys * skw;
    kb = kb > 4 * vc * svp(keys) ? kb : 4 * vc * svp(keys);
    krb = packed ? keys * rb : 0;
    vrb = keys * rb;
    vtb = 0;
    fb = mtb * keys * 64;
  } else {
    kb = 4 * TK * skw * (packed ? 1 : 2);
    krb = packed ? 2 * TK * rb : 0;
    vrb = 2 * TK * rb;
    vtb = 4 * vc * svp(TK);
    fb = mtb * (TK / CHUNK) * 512;
  }
  Smem s;
  s.k = 0;
  s.kraw = s.k + al16(kb);
  s.vraw = s.kraw + al16(krb);
  s.vt = s.vraw + al16(vrb);
  s.frag = s.vt + al16(vtb);
  s.rows = s.frag + al16(fb);
  s.red = s.rows + al16(paged ? 4 * keys * (packed ? 3 : 1) : 0);
  s.acc = s.red + al16(4 * (2 * ROWS + 2 * CMAX * ROWS));
  s.total = s.acc + al16(4 * 16 * mtb * D);
  return s;
}

// the global address of rank key j's RB bytes in K or V: `base` is the
// tensor at the block's KV head (contiguous: and at the lane's first rank
// key); PAGED, key j is pool row rows[j] (a table read at setup)
template <bool PAGED>
struct GlobalRows {
  const int8_t* base;
  size_t stride;            // bytes from one pool / cache row to the next
  const int* rows;
  __device__ __forceinline__ const int8_t* operator()(int j) const {
    return base + (size_t)(PAGED ? rows[j] : j) * stride;
  }
};

// rows as copied into shared memory; page(j) indexes the per-key shift
// arrays (tc::load_kp / load_vp read shift[row.page(key)])
struct SharedRows {
  const int8_t* base;
  int stride;
  int koff;                 // rank key of row 0
  __device__ __forceinline__ const int8_t* operator()(int j) const {
    return base + j * stride;
  }
  __device__ __forceinline__ int page(int j) const { return koff + j; }
};

// rank keys j0 .. j0 + n - 1 (RB bytes each) by cp.async in G-byte
// granules into dst (shared address), dst_stride bytes a key
template <int RB, int G, class Row>
__device__ __forceinline__ void copy_rows(unsigned dst, int dst_stride,
                                          const Row& row, int j0, int n,
                                          int tid) {
  static_assert(RB % G == 0, "whole granules a row");
  constexpr int CH = RB / G;
  for (int i = tid; i < n * CH; i += THREADS) {
    const int j = i / CH, c = i % CH;
    const unsigned d = dst + j * dst_stride + G * c;
    const int8_t* s = row(j0 + j) + G * c;
    if constexpr (G == 16)
      tc::cp_async16(d, s, 16);
    else if constexpr (G == 8)
      tc::cp_async8(d, s, 8);
    else
      tc::cp_async4(d, s, 4);
  }
}

template <int D, bool PAGED, bool PACKED, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
int_decode_attention_kernel(const Args a) {
  static_assert(PAGED || !PACKED, "packed int4 pools are paged");
  constexpr int KS = tc::ksteps(D);
  constexpr int SKW = tc::sk_words(D);
  constexpr int RB = PACKED ? D / 2 : D;           // bytes of a stored row
  constexpr int GW = RB % 16 == 0 ? 16 : (RB % 8 == 0 ? 8 : 4);
  constexpr int ND = D / 8;                        // output n-tiles
  constexpr int PER = (ND + WARPS - 1) / WARPS;    // n-tiles a warp in P·V
  static_assert(D % 8 == 0, "output n-tiles of 8 columns");
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay = smem_layout(D, a.rank_keys, a.mtb, PAGED, PACKED,
                               RESIDENT);
  int* sK = reinterpret_cast<int*>(smem + lay.k);
  int8_t* sKraw = reinterpret_cast<int8_t*>(smem + lay.kraw);
  int8_t* sVraw = reinterpret_cast<int8_t*>(smem + lay.vraw);
  int* sVt = RESIDENT ? sK : reinterpret_cast<int*>(smem + lay.vt);
  int4* sF = reinterpret_cast<int4*>(smem + lay.frag);
  int* sRows = reinterpret_cast<int*>(smem + lay.rows);
  int* sKsh = sRows + a.rank_keys;
  int* sVsh = sKsh + a.rank_keys;
  int* sBM = reinterpret_cast<int*>(smem + lay.red);
  int* sBS = sBM + ROWS;
  int* sMS = sBS + ROWS;                           // C x ROWS max slots
  int* sSS = sMS + CMAX * ROWS;                    // C x ROWS sum slots
  int* sAcc = reinterpret_cast<int*>(smem + lay.acc);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const unsigned rank = cluster_rank();
  const int C = a.cluster;
  const int b = blockIdx.z / a.Hkv, hk = blockIdx.z % a.Hkv;
  const int G = a.H / a.Hkv;
  const int r0 = ROWS * blockIdx.y;                // the block's first row
  const int nrows = min(ROWS, G * a.S - r0);       // its live rows
  const int mtn = (nrows + 15) / 16;               // its live m16 tiles
  // Q fragments: rows g, g + 8 of each m16 tile x words 8s + 2t, + 1
  int qa[2][KS][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * mt + g + 8 * hf, rg = r0 + r;
      const bool live = r < nrows;
      const int h = hk * G + (live ? rg / a.S : 0), i = live ? rg % a.S : 0;
      const int* qr = reinterpret_cast<const int*>(
          a.q + (((size_t)b * a.S + i) * a.H + h) * D);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        // the word index is even, so word + 1 < D / 4 too
        const bool in = live && (D % 32 == 0 || 8 * s + 2 * t < D / 4);
        qa[mt][s][hf] = in ? qr[8 * s + 2 * t] : 0;
        qa[mt][s][2 + hf] = in ? qr[8 * s + 2 * t + 1] : 0;
      }
    }

  const int vl = a.vlen[b];
  const int t_hi = min(max(vl, 0), a.L);           // the lane's keys
  // this rank's keys [k_lo, k_lo + nk): whole chunks, evenly over C
  const int per = ((t_hi + C - 1) / C + CHUNK - 1) / CHUNK * CHUNK;
  const int k_lo = min((int)rank * per, t_hi);
  const int nk = min(k_lo + per, t_hi) - k_lo;
  const int nch = (nk + CHUNK - 1) / CHUNK;
  // every key of the lane in rank 0 (a short lane, or none): rank 0 works
  // alone, with no cluster barrier and no remote access, and the other
  // ranks leave at once.  The whole cluster reads the same valid_len, so
  // it takes the same branch.
  const bool solo = per >= t_hi;
  if (solo && rank != 0) return;
  const int CE = solo ? 1 : C;                     // ranks that reduce
  auto sync_ranks = [&]() {
    if (solo) __syncthreads();
    else cluster_sync();
  };

  // the key range of this thread's rows g, g + 8 of each m16 tile
  int hi[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * mt + g + 8 * hf;
      const int i = (r0 + r) % a.S;
      hi[mt][hf] = r < nrows ? min(max(vl - (a.S - 1 - i), 0), a.L) : 0;
    }

  for (int r = tid; r < ROWS; r += THREADS) {
    sBM[r] = NEG;
    sBS[r] = 0;
  }
  if (rank == 0)
    for (int i = tid; i < 16 * a.mtb * D; i += THREADS) sAcc[i] = 0;
  if constexpr (PAGED) {
    // the page table, once per key: each rank key's pool row
    const int* ptab = a.pages + (size_t)b * a.max_pages;
    for (int j = tid; j < nk; j += THREADS) {
      const unsigned tk = (unsigned)(k_lo + j), ps = (unsigned)a.page_size;
      sRows[j] = ptab[tk / ps] * a.page_size + (int)(tk % ps);
    }
  }
  if (!solo) cluster_arrive();  // waited for before the first remote store
  __syncthreads();

  const size_t kvstride = (size_t)a.Hkv * RB;
  const size_t off =
      PAGED ? (size_t)hk * RB : (((size_t)b * a.L + k_lo) * a.Hkv + hk) * RB;
  const GlobalRows<PAGED> k_at{a.k + off, kvstride, sRows};
  const GlobalRows<PAGED> v_at{a.v + off, kvstride, sRows};
  // rank keys j0 .. j0 + n - 1 of K (int8: into the K tile layout;
  // PACKED: as copied) or V (as copied) at buffer slot `buf`
  auto copy_k = [&](int j0, int n, int buf) {
    if constexpr (PACKED) {
      const unsigned dst = tc::smem_addr(sKraw + buf * TK * RB);
      if (a.vec) copy_rows<RB, GW>(dst, RB, k_at, j0, n, tid);
      else copy_rows<RB, 4>(dst, RB, k_at, j0, n, tid);
    } else {
      const unsigned dst = tc::smem_addr(sK + buf * TK * SKW);
      if (a.vec) copy_rows<RB, GW>(dst, 4 * SKW, k_at, j0, n, tid);
      else copy_rows<RB, 4>(dst, 4 * SKW, k_at, j0, n, tid);
    }
  };
  auto copy_v = [&](int j0, int n, int buf) {
    const unsigned dst = tc::smem_addr(sVraw + buf * TK * RB);
    if (a.vec) copy_rows<RB, GW>(dst, RB, v_at, j0, n, tid);
    else copy_rows<RB, 4>(dst, RB, v_at, j0, n, tid);
  };
  // PACKED: each rank key's K and V shift, read once the copies are in
  // flight (the expansions wait for the copies and a barrier anyway)
  auto load_shifts = [&]() {
    if constexpr (PACKED) {
      for (int j = tid; j < nk; j += THREADS) {
        const int pg = sRows[j] / a.page_size;
        sKsh[j] = a.k_shift[pg];
        sVsh[j] = a.v_shift[pg];
      }
    }
  };
  // PACKED: n packed K rows (rank keys koff ..) expanded into the K tile
  auto expand_k = [&](const int8_t* raw, int koff, int n) {
    const SharedRows at{raw, RB, koff};
    for (int s0 = 0; s0 < n; s0 += 64) {
      unsigned kr[tc::kp_units<D, 64, THREADS>()];
      int ks[tc::kp_units<D, 64, THREADS>()];
      tc::load_kp<D, 64, THREADS>(kr, ks, at, sKsh, s0, n, tid);
      tc::store_kp<D, 64, THREADS>(sK + s0 * SKW, kr, ks, tid);
    }
  };
  // n V rows as copied (rank keys koff ..) into Vᵀ of sv-word rows; keys
  // up to the next multiple of 64 are staged as zeros
  auto stage_vt = [&](int sv, const int8_t* raw, int koff, int n) {
    const SharedRows at{raw, RB, koff};
    for (int s0 = 0; s0 < n; s0 += 64) {
      unsigned vr[tc::v_units<D, 64, THREADS>()][4];
      if constexpr (PACKED) {
        int vs[tc::v_units<D, 64, THREADS>()][4];
        tc::load_vp<D, 64, THREADS>(vr, vs, at, sVsh, s0, n, tid);
        tc::expand_v<D, 64, THREADS>(vr, vs);
      } else {
        tc::load_v<D, 64, THREADS>(vr, at, s0, n, tid);
      }
      tc::store_v_at<D, 64, THREADS>(sVt, vr, tid, sv, s0 / 8);
    }
  };

  // Q·Kᵀ of the 32 keys of chunk `ch` of the K tile kt, m16 tile mt:
  // c[jj] is n8 tile 4 ch + jj (C layout)
  auto chunk_scores = [&](const int* kt, int ch, int mt, int (&c)[4][4]) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      tc::qk_ntile<D>(kt, 4 * ch + jj, qa[mt], g, t, c[jj]);
  };
  // whether element e of n8 tile jj of the chunk at rank key kl0 is live
  auto live = [&](int mt, int e, int kl0, int jj) {
    return k_lo + kl0 + 8 * jj + 2 * t + (e & 1) < hi[mt][e >> 1];
  };

  int m[2][2] = {{NEG, NEG}, {NEG, NEG}};
  int sum[2][2] = {{0, 0}, {0, 0}};
  auto max_of = [&](const int (&c)[4][4], int mt, int kl0) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (live(mt, e, kl0, jj)) m[mt][e >> 1] = max(m[mt][e >> 1], c[jj][e]);
  };
  // e16 of the chunk's scores in place (0 where not live), summed
  auto e16_of = [&](int (&c)[4][4], int mt, int kl0) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = tc::exp16_mma(wsub(c[jj][e], m[mt][e >> 1]), a.ex);
        c[jj][e] = live(mt, e, kl0, jj) ? x : 0;
        sum[mt][e >> 1] += c[jj][e];
      }
  };
  // the chunk's e16 as p8 in one A fragment (n8 tiles 0..3 of the chunk)
  int rcp[2][2];
  auto a_frag = [&](const int (&c)[4][4], int mt) {
    unsigned pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      unsigned p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (unsigned)clampi(
            rshift_round(wmul(c[jj][e], rcp[mt][e >> 1]), 23), 0, 127);
      tc::pack_p(pa, jj, p);
    }
    return make_int4((int)pa[0], (int)pa[1], (int)pa[2], (int)pa[3]);
  };

  // the block's per-row max (sum) over its warps, then to slot `rank` of
  // every rank of the cluster
  auto reduce_push = [&](int (&v)[2][2], bool is_max, int* blk, int* slots) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        int x = v[mt][hf];
        const int y1 = __shfl_xor_sync(0xffffffffu, x, 1);
        x = is_max ? max(x, y1) : x + y1;
        const int y2 = __shfl_xor_sync(0xffffffffu, x, 2);
        x = is_max ? max(x, y2) : x + y2;
        if (t == 0 && mt < mtn) {
          if (is_max) atomicMax(&blk[16 * mt + g + 8 * hf], x);
          else atomicAdd(&blk[16 * mt + g + 8 * hf], x);
        }
      }
    __syncthreads();
    if (is_max && !solo) cluster_wait();  // every block has started
    for (int i = tid; i < CE * ROWS; i += THREADS) {
      const int dst = i / ROWS, r = i % ROWS;
      if (solo)
        slots[r] = blk[r];
      else
        st_cluster(map_rank(tc::smem_addr(slots + rank * ROWS + r), dst),
                   blk[r]);
    }
  };
  // after the cluster barrier: the row max over the C slots; then the
  // row sum, as the reciprocal sR = 2^30 // max(s, 1)
  auto global_max = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        int x = NEG;
        for (int rr = 0; rr < CE; ++rr)
          x = max(x, sMS[rr * ROWS + 16 * mt + g + 8 * hf]);
        m[mt][hf] = x;
      }
  };
  auto global_rcp = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        int x = 0;
        for (int rr = 0; rr < CE; ++rr)
          x += sSS[rr * ROWS + 16 * mt + g + 8 * hf];
        // s >= 0 (sum of non-negative e16, <= 2^30): truncation == floor
        rcp[mt][hf] = (1 << 30) / max(x, 1);
      }
  };

  int acc[2][PER][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < PER; ++q)
      acc[mt][q][0] = acc[mt][q][1] = acc[mt][q][2] = acc[mt][q][3] = 0;
  // acc += P (A fragment af of chunk ch of the staged Vᵀ, sv-word rows)
  // x V over this warp's output n-tiles
  auto pv = [&](int mt, const int4& af, int ch, int sv) {
    const int afr[4] = {af.x, af.y, af.z, af.w};
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int nd = warp * PER + q;
      if (nd < ND) {
        const int d = 8 * nd + g;
        const int2 bw = *reinterpret_cast<const int2*>(
            sVt + d * sv + 2 * ((4 * ch + t) ^ tc::vswz(d)));
        tc::mma_s8(acc[mt][q], afr, bw.x, bw.y);
      }
    }
  };

  if constexpr (RESIDENT) {
    // every copy of the rank in flight at once: K, then V
    copy_k(0, nk, 0);
    tc::cp_commit();
    copy_v(0, nk, 0);
    tc::cp_commit();
    load_shifts();
    tc::cp_wait<1>();
    __syncthreads();
    if constexpr (PACKED) {
      expand_k(sKraw, 0, nk);
      __syncthreads();
    }
    const int NCH = a.rank_keys / CHUNK;
    auto slot = [&](int mt, int ch, int jj) {
      return sF + ((mt * NCH + ch) * 4 + jj) * 32 + lane;
    };
    // sweep 0: scores kept, row max
    for (int ch = warp; ch < nch; ch += WARPS)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < mtn) {
          int c[4][4];
          chunk_scores(sK, ch, mt, c);
          max_of(c, mt, CHUNK * ch);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            *slot(mt, ch, jj) = make_int4(c[jj][0], c[jj][1], c[jj][2],
                                          c[jj][3]);
        }
    reduce_push(m, true, sBM, sMS);
    // V has landed (or lands now): Vᵀ over the K tile, which sweep 0 no
    // longer reads, while the other ranks reach the barrier
    tc::cp_wait<0>();
    __syncthreads();
    stage_vt(svp(a.rank_keys), sVraw, 0, nk);
    sync_ranks();
    global_max();
    // sweep 1: e16 in place of the scores, row sum
    for (int ch = warp; ch < nch; ch += WARPS)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < mtn) {
          int c[4][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int4 x = *slot(mt, ch, jj);
            c[jj][0] = x.x; c[jj][1] = x.y; c[jj][2] = x.z; c[jj][3] = x.w;
          }
          e16_of(c, mt, CHUNK * ch);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            *slot(mt, ch, jj) = make_int4(c[jj][0], c[jj][1], c[jj][2],
                                          c[jj][3]);
        }
    reduce_push(sum, false, sBS, sSS);
    sync_ranks();
    global_rcp();
    // sweep 2: p8 as A fragments (slot 0 of each chunk), then P·V
    for (int ch = warp; ch < nch; ch += WARPS)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < mtn) {
          int c[4][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int4 x = *slot(mt, ch, jj);
            c[jj][0] = x.x; c[jj][1] = x.y; c[jj][2] = x.z; c[jj][3] = x.w;
          }
          *slot(mt, ch, 0) = a_frag(c, mt);
        }
    __syncthreads();
    for (int ch = 0; ch < nch; ++ch)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < mtn) pv(mt, *slot(mt, ch, 0), ch, svp(a.rank_keys));
  } else {
    const int ntl = (nk + TK - 1) / TK;
    // every tile of the rank once: tile ti + 1's copies in flight while
    // body(ti, K tile, keys of the tile, buffer) runs
    auto sweep = [&](bool use_v, auto&& body) {
      if (ntl > 0) {
        copy_k(0, min(TK, nk), 0);
        if (use_v) copy_v(0, min(TK, nk), 0);
      }
      tc::cp_commit();
      for (int ti = 0; ti < ntl; ++ti) {
        const int nt = min(TK, nk - ti * TK), buf = ti & 1;
        if (ti + 1 < ntl) {
          const int nn = min(TK, nk - (ti + 1) * TK);
          copy_k((ti + 1) * TK, nn, buf ^ 1);
          if (use_v) copy_v((ti + 1) * TK, nn, buf ^ 1);
        }
        tc::cp_commit();
        tc::cp_wait<1>();
        __syncthreads();
        const int* kt = sK + buf * TK * SKW;
        if constexpr (PACKED) {
          expand_k(sKraw + buf * TK * RB, ti * TK, nt);
          __syncthreads();
          kt = sK;
        }
        body(ti, kt, nt, buf);
        __syncthreads();
      }
    };
    load_shifts();                       // seen after sweep's barriers
    const int kw0 = CHUNK * warp;        // this warp's chunk of a tile
    // sweep 0: row max
    sweep(false, [&](int ti, const int* kt, int nt, int) {
      if (kw0 < nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < mtn) {
            int c[4][4];
            chunk_scores(kt, warp, mt, c);
            max_of(c, mt, ti * TK + kw0);
          }
    });
    reduce_push(m, true, sBM, sMS);
    sync_ranks();
    global_max();
    // sweep 1: row sum (Q·Kᵀ again)
    sweep(false, [&](int ti, const int* kt, int nt, int) {
      if (kw0 < nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < mtn) {
            int c[4][4];
            chunk_scores(kt, warp, mt, c);
            e16_of(c, mt, ti * TK + kw0);
          }
    });
    reduce_push(sum, false, sBS, sSS);
    sync_ranks();
    global_rcp();
    // sweep 2: Q·Kᵀ again, p8 as A fragments, the tile's Vᵀ, P·V
    sweep(true, [&](int ti, const int* kt, int nt, int buf) {
      if (kw0 < nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < mtn) {
            int c[4][4];
            chunk_scores(kt, warp, mt, c);
            e16_of(c, mt, ti * TK + kw0);
            sF[(mt * (TK / CHUNK) + warp) * 32 + lane] = a_frag(c, mt);
          }
      stage_vt(svp(TK), sVraw + buf * TK * RB, ti * TK, nt);
      __syncthreads();
      for (int ch = 0; ch < (nt + CHUNK - 1) / CHUNK; ++ch)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < mtn)
            pv(mt, sF[(mt * (TK / CHUNK) + ch) * 32 + lane], ch, svp(TK));
    });
  }

  // the rank's P·V sums into rank 0, then rank 0's epilogue
  if (nk > 0) {
    const unsigned acc0 = map_rank(tc::smem_addr(sAcc), 0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < PER; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nd = warp * PER + q, r = 16 * mt + g + 8 * (e >> 1);
          const int o = r * D + 8 * nd + 2 * t + (e & 1);
          if (mt < mtn && nd < ND && r < nrows) {
            if (solo) atomicAdd(&sAcc[o], acc[mt][q][e]);
            else red_add_cluster(acc0 + 4 * o, acc[mt][q][e]);
          }
        }
  }
  sync_ranks();
  if (rank != 0) return;
  for (int idx = tid; idx < nrows * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, rg = r0 + r;
    const int h = hk * G + rg / a.S, i = rg % a.S;
    int v = sAcc[idx];
    if (a.rq.kind != RQ_RAW) {
      const int bm = a.rq.kind == RQ_PER_CHANNEL ? a.bvec[h * D + d] : a.rq.b;
      v = requant(v, a.rq, bm);
    }
    const size_t o = (((size_t)b * a.S + i) * a.H + h) * D + d;
    if (a.out_is_int8)
      reinterpret_cast<int8_t*>(a.out)[o] = (int8_t)v;
    else
      reinterpret_cast<int*>(a.out)[o] = v;
  }
}

template <int D, bool PAGED, bool PACKED, bool RESIDENT>
int launch(const Args& a, cudaStream_t s) {
  auto kern = int_decode_attention_kernel<D, PAGED, PACKED, RESIDENT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, (a.H / a.Hkv * a.S + ROWS - 1) / ROWS,
                     a.B * a.Hkv);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Args& a, cudaStream_t s) {
  if (a.k_shift)
    return a.resident ? launch<D, true, true, true>(a, s)
                      : launch<D, true, true, false>(a, s);
  if (a.pages)
    return a.resident ? launch<D, true, false, true>(a, s)
                      : launch<D, true, false, false>(a, s);
  return a.resident ? launch<D, false, false, true>(a, s)
                    : launch<D, false, false, false>(a, s);
}

}  // namespace k3
}  // namespace r8

// the dynamic shared memory of a K3 block; kernels/int_decode_attention.py
// ::k3_smem_bytes is the same
extern "C" long long r8_k3_smem_bytes(int D, int rank_keys, int mtb,
                                      int paged, int packed, int resident) {
  return r8::k3::smem_layout(D, rank_keys, mtb, paged != 0, packed != 0,
                             resident != 0)
      .total;
}

extern "C" int r8_int_decode_attention(const r8::k3::Args* a, void* stream) {
  using namespace r8::k3;
  // the launch must be the one kernels/int_decode_attention.py::
  // k3_launch_plan computes for the shape
  if (a->B <= 0 || a->S < 1 || a->S > 8 || a->Hkv <= 0 || a->H <= 0 ||
      a->H % a->Hkv || a->L < 0 || a->L > 32768 || !a->vlen || !a->q ||
      !a->k || !a->v || !a->out)
    return (int)cudaErrorInvalidValue;
  const bool paged = a->pages != nullptr, packed = a->k_shift != nullptr;
  const int rows = a->H / a->Hkv * a->S;
  const int c = a->cluster;
  const int want_keys = ((a->L + c - 1) / c + 63) / 64 * 64;
  const int rb = packed ? a->D / 2 : a->D;
  const int gw = rb % 16 == 0 ? 16 : (rb % 8 == 0 ? 8 : 4);
  if ((c != 1 && c != 2 && c != 4 && c != 8) ||
      a->rank_keys != (want_keys > 64 ? want_keys : 64) ||
      a->mtb != (rows > 16 ? 2 : 1) || !a->k_shift != !a->v_shift ||
      (packed && !paged) ||
      (paged && (a->page_size <= 0 || a->max_pages < 0 ||
                 a->L != a->max_pages * a->page_size)) ||
      (a->vec && ((uintptr_t)a->k % gw || (uintptr_t)a->v % gw)) ||
      (uintptr_t)a->k % 4 || (uintptr_t)a->v % 4 || (uintptr_t)a->q % 4 ||
      (a->rq.kind == r8::RQ_PER_CHANNEL && !a->bvec) ||
      a->ex.z_shift < 0 || a->ex.z_shift > 31 ||
      (long long)a->B * a->Hkv > 65535 ||
      a->smem != smem_layout(a->D, a->rank_keys, a->mtb, paged, packed,
                             a->resident != 0)
                     .total ||
      a->smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 32:
      return launch_d<32>(*a, s);
    case 64:
      return launch_d<64>(*a, s);
    case 120:
      return launch_d<120>(*a, s);
    case 128:
      return launch_d<128>(*a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

namespace r8 {
namespace k3 {

template <int D>
int attrs_d(int paged, int packed, int resident, int threads, int smem,
            int cluster, int* out) {
  if (packed && !paged) return (int)cudaErrorInvalidValue;
  if (packed)
    return resident
               ? attrs(int_decode_attention_kernel<D, true, true, true>,
                       threads, smem, cluster, 1, out)
               : attrs(int_decode_attention_kernel<D, true, true, false>,
                       threads, smem, cluster, 1, out);
  if (paged)
    return resident
               ? attrs(int_decode_attention_kernel<D, true, false, true>,
                       threads, smem, cluster, 1, out)
               : attrs(int_decode_attention_kernel<D, true, false, false>,
                       threads, smem, cluster, 1, out);
  return resident
             ? attrs(int_decode_attention_kernel<D, false, false, true>,
                     threads, smem, cluster, 1, out)
             : attrs(int_decode_attention_kernel<D, false, false, false>,
                     threads, smem, cluster, 1, out);
}

}  // namespace k3
}  // namespace r8

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: D, paged, packed, resident; the
// cluster splits the keys along grid x); out[6]
extern "C" int r8_attrs_int_decode_attention(const int* sel, int threads,
                                             int smem, int cluster,
                                             int* out) {
  using namespace r8::k3;
  switch (sel[0]) {
    case 32:
      return attrs_d<32>(sel[1], sel[2], sel[3], threads, smem, cluster, out);
    case 64:
      return attrs_d<64>(sel[1], sel[2], sel[3], threads, smem, cluster, out);
    case 120:
      return attrs_d<120>(sel[1], sel[2], sel[3], threads, smem, cluster,
                          out);
    case 128:
      return attrs_d<128>(sel[1], sel[2], sel[3], threads, smem, cluster,
                          out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
