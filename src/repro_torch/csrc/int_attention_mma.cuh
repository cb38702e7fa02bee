// The body of K5 (exact full-sequence attention) and K4 (paged
// chunked-prefill attention): exact integer attention on the int8 tensor
// cores (mma.sync.m16n8k32 s8 x s8 -> s32), bit-exact.
//
// Twin of repro/kernels/int_attention_fused.py::_streaming_attn_body, the
// same three exact sweeps as K3's (int_decode_attention.cu):
//
//   sweep 0  row max   m = max_t score(r, t)
//   sweep 1  row sum   s = sum_t e16(score(r, t) - m)
//   sweep 2  p8 = clip(rshift_round(e16 * (2^30 // s), 23), 0, 127);
//            acc[r][d] += p8 * v8[t][d]
//
// then the RequantSpec epilogue.  Why the integers stay exact: Q·Kᵀ in
// s8 x s8 -> s32 is exact (|score| <= 128 * 128 * D <= 2^21), an integer
// max does not depend on order, e16 is elementwise, row sums stay within
// 2^30 (MAX_ROWSUM_LEN), and p8 lies in [0, 127], a valid s8 operand whose
// products with v8 sum in s32 in any order.
//
// Block: 64 query rows of one (sequence, head), 4 warps of 16 rows, for
// K5 and K4 alike.  Each warp keeps its Q A-fragments in registers for
// the whole launch (ceil(D / 32) k-steps, zero past D), so the block reads
// Q once.  D is any multiple of 8: 32, 64, 120 and 128 are instantiated.  Keys come
// in tiles of 64 over the block's key range [t_lo, t_hi) (the union of its
// rows' live ranges; tiles outside it are never loaded, and a warp skips
// the work of a tile outside its own rows' range); partial tiles are
// masked per element, and keys past t_hi are zero-filled and never live.
//
//   K tiles: cp.async into a double buffer, row-major (key, D bytes) with
//   a row stride of tc::sk_words(D) words.  Wide copies (16 bytes, 8 at a
//   D that is not a multiple of 16) where K is aligned to them, else
//   4-byte copies (the wrapper takes any 4-byte aligned operand).  Key t of lane b is row b * Skv + t of K (K5), or
//   (PAGED) row pages[b, t / page_size] * page_size + t % page_size of
//   the pool: each key's D bytes are contiguous, so a tile gathers its
//   rows from up to ceil(64 / page_size) + 1 pages with the same copies.
//
//   Row max and row sum live in registers: each thread owns rows g and
//   g + 8 of its warp and reduces over its own keys, then over the quad
//   (__shfl_xor 1, 2).  No atomics.
//
//   e16 store (STORE): sweep 1 keeps e16 (0..32755 for every plan; the
//   wrapper checks the plan's range fits 16 bits) as 16-bit pairs in
//   shared memory, one word per (tile, n-tile, row half, lane), so sweep 2
//   neither recomputes Q·Kᵀ nor exp16 and reads no K.  It needs 8 KB a
//   key tile; the launch plan takes it where the widest block's range
//   fits the 227 KB a block may have (kernels/int_attention_fused.py::
//   k5_launch_plan, k4_launch_plan: K4 sizes it for the page table's
//   whole span, max_pages * page_size, since the host never reads
//   pos_end), else sweep 2 recomputes.
//
//   Q·Kᵀ's k order, the padding of a D that is not a multiple of 32, P·V
//   without shuffles (p8 packed from the score
//   accumulators into A fragments against a key-permuted, swizzled Vᵀ
//   read one tile ahead) and the branch-free exp16 are the shared pieces
//   of int_attention_tc.cuh, whose note says how they work.
//
// PACKED (K4 over int4 pools, kv_shifts): keys and values are rows of
// D / 2 packed bytes a key, each page with its own shift; K goes through
// registers one tile ahead (tc::load_kp / store_kp) instead of cp.async,
// V's units load 2 packed bytes a key and expand before store_v
// (tc::load_vp / expand_v).  The tiles the sweeps read are the int8 ones,
// so every sweep is the int8 instantiation's.
//
// Masks (row_range): K5 none, or causal with an optional window; K4 the
// stepped mask hi_i = pos_end[b] - (Sq - 1 - i), lo_i = 0, read from
// pos_end by the kernel itself.  A row with no live key keeps max -2^30,
// sum 0 and acc 0, so it writes requant(0), as the reference's
// all-masked row does.  GQA: head h reads KV head h / (H / Hkv).
#pragma once

#include "int_attention_tc.cuh"

namespace r8 {
namespace k5 {

constexpr int THREADS = 128;            // 4 warps
constexpr int ROWS = 64;                // query rows a block, 16 a warp
constexpr int KEYS = 64;                // keys a tile
constexpr int NEG = -(1 << 30);         // row max before any live key
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block

// dynamic shared memory of one block: the K double buffer, one Vᵀ tile
// and, with the e16 store, 2 KB a warp a key tile
__host__ __device__ constexpr long long smem_bytes(int D, int tiles,
                                                   bool store) {
  return 4LL * (2 * KEYS * tc::sk_words(D) + tc::v_cols(D) * (KEYS / 4)) +
         (store ? 4LL * (THREADS / 32) * tiles * (KEYS / 8) * 2 * 32 : 0);
}

// [lo, hi) of query row i (empty past Sq), clamped to [0, Skv]: K5's
// masks, or STEPPED (K4) hi = vl - (Sq - 1 - i) with vl the lane's pos_end
template <bool STEPPED = false>
__host__ __device__ inline void row_range(int Sq, int Skv, int causal,
                                          int window, int vl, int i,
                                          int& lo, int& hi) {
  lo = 0;
  hi = Skv;
  if (i >= Sq) {
    hi = 0;
  } else if (STEPPED) {
    hi = vl - (Sq - 1 - i);
  } else if (causal) {
    hi = i + 1;
    if (window > 0) lo = i - window + 1;
  }
  hi = hi < 0 ? 0 : (hi > Skv ? Skv : hi);
  lo = lo < 0 ? 0 : (lo > hi ? hi : lo);
}

// key tiles of the widest block's range (kernels/int_attention_fused.py::
// k5_tiles computes the same)
inline int max_tiles(int Sq, int Skv, int causal, int window) {
  int most = 0;
  for (int q0 = 0; q0 < Sq; q0 += ROWS) {
    int lo, hi, l2, h2;
    row_range(Sq, Skv, causal, window, 0, q0, lo, hi);
    row_range(Sq, Skv, causal, window, 0,
              (q0 + ROWS < Sq ? q0 + ROWS : Sq) - 1, l2, h2);
    const int n = h2 > lo ? (h2 - lo + KEYS - 1) / KEYS : 0;
    most = n > most ? n : most;
  }
  return most;
}

// the arguments of a K5 or K4 launch
struct Args {
  const int8_t* q;          // (B, Sq, H, D)
  const int8_t* k;          // K5 (B, Skv, Hkv, D); K4 (num_pages,
  const int8_t* v;          //   page_size, Hkv, D) pools
  const int* bvec;          // (H * D,) per-channel multipliers or null
  void* out;                // (B, Sq, H, D) int8 or int32
  int B, Sq, Skv, H, Hkv, D;  // K4: Sq = C, Skv = max_pages * page_size
  int causal, window;       // K5: hi_i = i + 1; with window, lo_i = i-w+1
  int out_is_int8;
  int tiles;                // key tiles of the widest block's range
  int store_e16;
  int vec_k;                // 16-byte copies of K, else 4-byte
  int smem;                 // dynamic shared memory (smem_bytes)
  tc::Exp16 ex;
  Requant rq;
  const int* pages;         // K4: (B, max_pages) page table (K5: null)
  const int* pos_end;       // K4: (B,) (K5: null)
  int page_size, max_pages;   // K4
  const int* k_shift;       // K4 over packed int4 pools: (num_pages,)
  const int* v_shift;       //   per-page shifts; null for int8 pools
};

// the address of key `key`'s D bytes in K or V: `base` is the tensor at
// the block's KV head (and, contiguous, its lane); PAGED, the key sits at
// row key % ps of page ptab[key / ps] of the pool
template <bool PAGED>
struct KeyRows {
  const int8_t* base;
  size_t stride;            // bytes from one key row to the next (Hkv * D)
  const int* ptab;          // the lane's page table (PAGED)
  int ps;
  __device__ __forceinline__ const int8_t* operator()(int key) const {
    if (!PAGED) return base + (size_t)key * stride;
    return base + ((size_t)ptab[(unsigned)key / ps] * ps +
                   (unsigned)key % ps) * stride;
  }
  // the page of key `key` (PAGED)
  __device__ __forceinline__ int page(int key) const {
    return ptab[(unsigned)key / ps];
  }
};

// LO: rows may start past key 0 (a window); STORE: sweep 1 keeps e16;
// PAGED: K4 (keys through the page table, the stepped mask), else K5;
// PACKED: K4 over packed int4 pools
template <int D, bool LO, bool STORE, bool PAGED, bool PACKED = false>
__device__ __forceinline__ void attend(const Args& a) {
  static_assert(PAGED || !PACKED, "packed int4 pools are paged");
  constexpr int KS = tc::ksteps(D);          // k-steps of Q·Kᵀ
  constexpr int SK = tc::sk_words(D);
  constexpr int SV = KEYS / 4;               // words of a Vᵀ row
  constexpr int NJ = KEYS / 8;               // score n-tiles of a tile
  constexpr int ND = D / 8;                  // output n-tiles
  constexpr int DW = D / 4;                  // words of a K / V row
  constexpr int VU = tc::v_units<D, KEYS, THREADS>();
  static_assert(D % 8 == 0, "output n-tiles of 8 columns");
  extern __shared__ __align__(16) int smem[];
  int* sK = smem;                            // 2 x KEYS x SK
  int* sVt = sK + 2 * KEYS * SK;             // v_cols(D) x SV
  unsigned* sE = reinterpret_cast<unsigned*>(sVt + tc::v_cols(D) * SV);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  constexpr int RB = PACKED ? D / 2 : D;     // bytes of a stored K/V row
  const size_t kvstride = (size_t)a.Hkv * RB;
  const size_t lane_off = PAGED ? 0 : (size_t)b * a.Skv * kvstride;
  const int* ptab = PAGED ? a.pages + (size_t)b * a.max_pages : nullptr;
  // key rows of K and V (read only for keys of the block's range)
  const KeyRows<PAGED> k_at{a.k + lane_off + (size_t)hk * RB, kvstride,
                            ptab, a.page_size};
  const KeyRows<PAGED> v_at{a.v + lane_off + (size_t)hk * RB, kvstride,
                            ptab, a.page_size};
  const int vl = PAGED ? a.pos_end[b] : 0;
  auto range = [&](int i, int& lo, int& hi) {
    row_range<PAGED>(a.Sq, a.Skv, a.causal, a.window, vl, i, lo, hi);
  };

  // the block's key range, this warp's, and this thread's two rows'
  int t_lo, t_hi, x0, x1;
  range(q0, t_lo, x0);
  range(min(q0 + ROWS, a.Sq) - 1, x1, t_hi);
  const int wr0 = q0 + 16 * warp;
  int w_lo, w_hi;
  range(wr0, w_lo, x0);
  range(min(wr0 + 15, a.Sq - 1), x1, w_hi);
  if (wr0 >= a.Sq) w_lo = w_hi = 0;
  int lo[2], hi[2];
  range(wr0 + g, lo[0], hi[0]);
  range(wr0 + g + 8, lo[1], hi[1]);
  const int nt = t_hi > t_lo ? (t_hi - t_lo + KEYS - 1) / KEYS : 0;

  // Q fragments: rows g, g+8 x words 8s + 2t, 8s + 2t + 1, zero past D
  int qa[KS][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = wr0 + g + 8 * hf;
    const int* qr = reinterpret_cast<const int*>(
        a.q + (((size_t)b * a.Sq + r) * a.H + h) * D);
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      // the word index is even, so word + 1 < DW too
      const bool in = r < a.Sq && (D % 32 == 0 || 8 * s + 2 * t < DW);
      qa[s][hf] = in ? qr[8 * s + 2 * t] : 0;
      qa[s][2 + hf] = in ? qr[8 * s + 2 * t + 1] : 0;
    }
  }

  // PACKED: the next K tile's packed units, expanded by store_k
  constexpr int KU = PACKED ? tc::kp_units<D, KEYS, THREADS>() : 1;
  unsigned kr[KU];
  int ks[KU];
  auto load_k = [&](int t0, int buf) {
    int* dst = sK + buf * KEYS * SK;
    if constexpr (PACKED) {
      tc::load_kp<D, KEYS, THREADS>(kr, ks, k_at, a.k_shift, t0, t_hi, tid);
    } else if (a.vec_k) {
      tc::load_k_wide<D, KEYS, THREADS>(dst, k_at, t0, t_hi, tid, a.k);
    } else {
#pragma unroll 4
      for (int i = tid; i < KEYS * DW; i += THREADS) {
        const int j = i / DW, w = i % DW, key = t0 + j;
        const bool ok = key < t_hi;
        tc::cp_async4(tc::smem_addr(dst + j * SK + w),
                      ok ? k_at(key) + 4 * w : a.k, ok ? 4 : 0);
      }
    }
  };

  auto store_k = [&](int buf) {
    if constexpr (PACKED)
      tc::store_kp<D, KEYS, THREADS>(sK + buf * KEYS * SK, kr, ks, tid);
  };

  unsigned vr[VU][4];
  int vs[PACKED ? VU : 1][4];               // PACKED: each key's shift
  auto load_v = [&](int t0) {
    if constexpr (PACKED)
      tc::load_vp<D, KEYS, THREADS>(vr, vs, v_at, a.v_shift, t0, t_hi, tid);
    else
      tc::load_v<D, KEYS, THREADS>(vr, v_at, t0, t_hi, tid);
  };
  auto store_v = [&]() {
    if constexpr (PACKED) tc::expand_v<D, KEYS, THREADS>(vr, vs);
    tc::store_v<D, KEYS, THREADS>(sVt, vr, tid);
  };

  // V is read one tile ahead, except where sweep 2 also carries the next
  // packed K tile in registers (PACKED without the e16 store): there the
  // two prefetches together would spill, so V is read at its own step
  constexpr bool V_AHEAD = STORE || !PACKED;
  // every tile of the block's range once; body(ti, t0, K tile) runs only
  // where the tile meets this warp's rows (PACKED: K tile ti is stored
  // from registers at the top of its step, as V is)
  auto sweep = [&](bool use_k, bool use_v, auto&& body) {
    if (nt > 0) {
      if (use_k) load_k(t_lo, 0);
      if (use_v && V_AHEAD) load_v(t_lo);
    }
    tc::cp_commit();
    for (int ti = 0; ti < nt; ++ti) {
      const int t0 = t_lo + ti * KEYS;
      if (use_k) store_k(ti & 1);
      if (use_v) {
        if (!V_AHEAD) load_v(t0);
        store_v();
      }
      if (ti + 1 < nt) {
        if (use_k) load_k(t0 + KEYS, (ti + 1) & 1);
        if (use_v && V_AHEAD) load_v(t0 + KEYS);
      }
      tc::cp_commit();
      tc::cp_wait<1>();
      __syncthreads();
      if (t0 < w_hi && t0 + KEYS > w_lo)
        body(ti, t0, sK + (ti & 1) * KEYS * SK);
      __syncthreads();
    }
  };

  auto scores = [&](const int* sKb, int j, int (&c)[4]) {
    tc::qk_ntile<D>(sKb, j, qa, g, t, c);
  };
  auto live = [&](int col, int hf, int t0) {
    const int key = t0 + col;
    return (!LO || key >= lo[hf]) && key < hi[hf];
  };

  // sweep 0: row max
  int m[2] = {NEG, NEG};
  sweep(true, false, [&](int, int t0, const int* sKb) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      int c[4];
      scores(sKb, j, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, col = 8 * j + 2 * t + (e & 1);
        if (live(col, hf, t0)) m[hf] = max(m[hf], c[e]);
      }
    }
  });
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    m[hf] = max(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
    m[hf] = max(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
  }

  // e16 of n-tile j's four scores (0 where not live)
  auto e16_of = [&](const int* sKb, int j, int t0, int (&e16)[4]) {
    int c[4];
    scores(sKb, j, c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1, col = 8 * j + 2 * t + (e & 1);
      const int x = tc::exp16_mma(wsub(c[e], m[hf]), a.ex);
      e16[e] = live(col, hf, t0) ? x : 0;
    }
  };
  auto e16_slot = [&](int ti, int j, int hf) {
    return sE + (((warp * a.tiles + ti) * NJ + j) * 2 + hf) * 32 + lane;
  };

  // sweep 1: row sum (and the e16 store)
  int sum[2] = {0, 0};
  sweep(true, false, [&](int ti, int t0, const int* sKb) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      int e16[4];
      e16_of(sKb, j, t0, e16);
      sum[0] += e16[0] + e16[1];
      sum[1] += e16[2] + e16[3];
      if (STORE) {
        *e16_slot(ti, j, 0) = (unsigned)e16[0] | ((unsigned)e16[1] << 16);
        *e16_slot(ti, j, 1) = (unsigned)e16[2] | ((unsigned)e16[3] << 16);
      }
    }
  });
  int rcp[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
    // s >= 0 (sum of non-negative e16, <= 2^30): truncation == floor
    rcp[hf] = (1 << 30) / max(sum[hf], 1);
  }

  // sweep 2: p8 packed into A fragments, P·V on the tensor cores
  int acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0;
  sweep(!STORE, true, [&](int ti, int t0, const int* sKb) {
#pragma unroll
    for (int s = 0; s < KEYS / 32; ++s) {
      unsigned pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * s + jj;
        int e16[4];
        if (STORE) {
          const unsigned w0 = *e16_slot(ti, j, 0), w1 = *e16_slot(ti, j, 1);
          e16[0] = (int)(w0 & 0xFFFFu);
          e16[1] = (int)(w0 >> 16);
          e16[2] = (int)(w1 & 0xFFFFu);
          e16[3] = (int)(w1 >> 16);
        } else {
          e16_of(sKb, j, t0, e16);
        }
        unsigned p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = (unsigned)clampi(rshift_round(wmul(e16[e], rcp[e >> 1]), 23),
                                  0, 127);
        tc::pack_p(pa, jj, p);
      }
      const int afr[4] = {(int)pa[0], (int)pa[1], (int)pa[2], (int)pa[3]};
      tc::pv_chunk<D, KEYS>(acc, afr, sVt, s, g, t);
    }
  });

  // epilogue: rows g, g + 8, columns 8 nd + 2t, +1
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = wr0 + g + 8 * hf;
    if (r >= a.Sq) continue;
    const size_t row = (((size_t)b * a.Sq + r) * a.H + h) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int d = 8 * nd + 2 * t;
      int v0 = acc[nd][2 * hf], v1 = acc[nd][2 * hf + 1];
      if (a.rq.kind != RQ_RAW) {
        const bool pc = a.rq.kind == RQ_PER_CHANNEL;
        v0 = requant(v0, a.rq, pc ? a.bvec[h * D + d] : a.rq.b);
        v1 = requant(v1, a.rq, pc ? a.bvec[h * D + d + 1] : a.rq.b);
      }
      if (a.out_is_int8)
        *reinterpret_cast<char2*>(reinterpret_cast<int8_t*>(a.out) + row + d) =
            make_char2((char)v0, (char)v1);
      else
        *reinterpret_cast<int2*>(reinterpret_cast<int*>(a.out) + row + d) =
            make_int2(v0, v1);
    }
  }
}

// K5's kernel: 64 query rows of one (sequence, head) a block
template <int D, bool LO, bool STORE>
__global__ void __launch_bounds__(THREADS)
int_attention_mma_kernel(Args a) {
  attend<D, LO, STORE, false>(a);
}

template <int D, bool LO, bool STORE>
inline int launch(const Args& a, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      int_attention_mma_kernel<D, LO, STORE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + ROWS - 1) / ROWS, a.H, a.B);
  int_attention_mma_kernel<D, LO, STORE><<<grid, THREADS, a.smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
inline int launch_d(const Args& a, cudaStream_t s) {
  const bool lo = a.causal && a.window > 0;
  if (a.store_e16)
    return lo ? launch<D, true, true>(a, s) : launch<D, false, true>(a, s);
  return lo ? launch<D, true, false>(a, s) : launch<D, false, false>(a, s);
}

}  // namespace k5
}  // namespace r8
