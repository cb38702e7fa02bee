// K8: one-pass online integer-softmax attention (the `pallas` backend's
// attention) on the int8 tensor cores (mma.sync.m16n8k32 s8 x s8 -> s32),
// bit-exact against the TPU kernel at the same logical blocks.
//
// Replaces the TPU kernel repro/kernels/int_attention.py::
// int_attention_pallas (body _attn_kernel).
//
// What bounds it on the H100: at the encoder's shape (B = 32, S = 512,
// H = 12, D = 64) device-memory bytes, barely: q, k and v read once and
// the int8 output written once are 50 MB, 15 us at 3.35 TB/s, while one
// Q·Kᵀ and one P·V are 26 G operations, 13 us at the int8 tensor-core
// peak.  Both products run on the tensor cores here, so what is left is
// the elementwise Shiftmax on the CUDA cores: one exp16 (some 25-30 int32
// instructions) per live (row, key) pair, as in K5 with its e16 store.
//
// Semantics.  The TPU kernel's grid walks the logical KV blocks of size
// bkv in order for each logical query block of size bq, carrying per row
// the running max m (raw score scale), the running sum s of e16 and the
// int32 accumulator acc[D].  Per processed block, in this order: masked
// scores, the block max, m_new = max(m, block max), corr16 = exp16(m -
// m_new), e16 = exp16(score - m_new) (0 where masked), u8 = e16 >> 8
// (stored as int8), s = rescale32(s, corr16) + sum e16, acc =
// rescale32(acc, corr16) + u8·v.  exp16(0) is 32755, not 2^15, so every
// processed block shrinks s and acc even when the max does not move: the
// integers depend on the block partition.  Hence bq and bkv are runtime
// arguments here, the logical blocks of the TPU kernel, independent of
// this kernel's own tiles: each row decides the causal skip (block j is
// processed iff j*bkv <= (r/bq)*bq + bq - 1) from its own logical query
// block, also where one warp holds rows of several (bq < 16), and the
// rescales happen at the logical block boundaries.  A window never skips
// a block.  The finalize is exact floor division of acc (which may be
// negative) by s8 = max(s >> 8, 1), 7 fraction bits, then the two-stage
// dyadic and the clip; the result is stored as int8.
//
// Design: one block of 4 warps per (64 query rows, head, sequence), 16
// rows a warp, Q A-fragments in registers for the whole launch.  Key
// tiles of 64 start at each logical block's first key (t0 = j * bkv), so
// no n8 or k32 tile straddles two logical blocks: a block of bkv keys is
// ceil(bkv / 64) tiles, the last one partial, its keys past the block
// zero-filled and never live.  The block max must be complete before any
// e16, so a block of one tile takes one step (its Q·Kᵀ twice from the
// same K tile: max, then e16), and a longer block 2T steps: T of the max
// pass, then T of the e16 pass, Q·Kᵀ recomputed (cheap on the tensor
// cores) rather than 64 keys of scores a tile held in registers beside
// acc.  Every step's K tile comes by cp.async into a double buffer, and
// the e16 steps' V one step ahead into registers, staged as the
// key-permuted, swizzled Vᵀ of int_attention_tc.cuh.  After the max pass
// each row's corr16 rescales its C fragments in registers, and the e16
// pass's P·V accumulates into them (wrapping s32): rescale, then add.
// u8 goes from the score accumulators straight into A fragments.  Row m
// and s live in quad registers (__shfl_xor 1, 2), no atomics.  Activity
// is per row: an inactive row's u8 is 0 and its m, s and acc stay.  A
// warp whose rows have no live key in a tile skips its products (its u8
// would be 0 and its block max is NEG), and the block's leading blocks
// where no row has a live key yet are not visited: there s = acc = 0 and
// m = NEG, which such a block leaves as it is.  GQA: head h reads KV head
// h / (H / Hkv).  Head dims 32, 64, 120 and 128: a D that is not a
// multiple of 32 takes K5's zero-padded k-steps and 8-byte K copies
// (int_attention_tc.cuh).
#include "int_attention_tc.cuh"
#include "int_attrs.cuh"

namespace r8 {
namespace k8 {

constexpr int THREADS = 128;            // 4 warps
constexpr int ROWS = 64;                // query rows a block, 16 a warp
constexpr int KEYS = 64;                // keys a tile
constexpr int NEG = -(1 << 30);         // masked score; m before a live key

struct Args {
  const int8_t* q;          // (B, Sq, H, D)
  const int8_t* k;          // (B, Skv, Hkv, D)
  const int8_t* v;          // (B, Skv, Hkv, D)
  int8_t* out;              // (B, Sq, H, D)
  int B, Sq, Skv, H, Hkv, D;
  int bq, bkv;              // logical blocks (divide Sq and Skv)
  int causal, window;       // ki <= qi; ki > qi - window (each on its own)
  int tiles;                // key tiles of a logical block
  int smem;                 // dynamic shared memory (smem_bytes)
  int dn_b, dn_c, dn_pre;   // the per-tensor output dyadic
  int lo, hi;               // clip to out_bits
  tc::Exp16 ex;
};

// dynamic shared memory of one block: the K double buffer and one Vᵀ tile
__host__ __device__ constexpr long long smem_bytes(int D) {
  return 4LL * (2 * KEYS * tc::sk_words(D) + tc::v_cols(D) * (KEYS / 4));
}

// row i's live keys [live_lo, live_hi), and the last query row of its
// logical query block (the causal block skip)
__device__ __forceinline__ int live_lo(const Args& a, int i) {
  return a.window > 0 ? max(i - a.window + 1, 0) : 0;
}
__device__ __forceinline__ int live_hi(const Args& a, int i) {
  return a.causal ? min(i + 1, a.Skv) : a.Skv;
}
__device__ __forceinline__ int block_last(const Args& a, int i) {
  return (i / a.bq) * a.bq + a.bq - 1;
}

// (x * corr16) >> 15 through a hi/lo split (core.softmax.rescale_sum):
// arithmetic >> 15 of a possibly negative x, plus the rounded low half
__device__ __forceinline__ int rescale32(int x, int corr16) {
  return wadd(wmul(x >> 15, corr16),
              rshift_round(wmul(x & 0x7FFF, corr16), 15));
}

// floor(acc / s8) * 128 + 7 exact fraction bits, requantized and clipped
__device__ __forceinline__ int finalize(int acc, int s8, const Args& a) {
  int whole = acc / s8;                    // truncates toward zero ...
  int rem = acc - whole * s8;
  if (rem < 0) {                           // ... so floor a negative acc
    whole -= 1;
    rem += s8;
  }
  const int frac7 = (rem << 7) / s8;       // 0 <= rem < s8 <= 2^23
  const int out7 = wadd(wmul(whole, 128), frac7);
  return clampi(dyadic(out7, a.dn_b, a.dn_c, a.dn_pre), a.lo, a.hi);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
int_attention_online_kernel(Args a) {
  constexpr int KS = tc::ksteps(D);          // k-steps of Q·Kᵀ
  constexpr int SK = tc::sk_words(D);
  constexpr int NJ = KEYS / 8;               // score n-tiles of a tile
  constexpr int ND = D / 8;                  // output n-tiles
  constexpr int VU = tc::v_units<D, KEYS, THREADS>();
  extern __shared__ __align__(16) int smem[];
  int* sK = smem;                            // 2 x KEYS x SK
  int* sVt = sK + 2 * KEYS * SK;             // v_cols(D) x KEYS / 4

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const size_t kvstride = (size_t)a.Hkv * D;
  const int8_t* kbase = a.k + (size_t)b * a.Skv * kvstride + (size_t)hk * D;
  const int8_t* vbase = a.v + (size_t)b * a.Skv * kvstride + (size_t)hk * D;
  auto k_at = [&](int key) { return kbase + key * kvstride; };
  auto v_at = [&](int key) { return vbase + key * kvstride; };
  const int bkv = a.bkv, T = a.tiles;

  // this thread's rows g and g + 8; the warp's rows are in order, so its
  // live keys lie in [live_lo(first), live_hi(last)) and its last row
  // processes the most logical blocks
  const int wr0 = q0 + 16 * warp, wlast = min(wr0 + 15, a.Sq - 1);
  const bool wrows = wr0 < a.Sq;
  const int w_lo = live_lo(a, wr0), w_hi = live_hi(a, wlast);
  const int w_qlast = block_last(a, wlast);
  int row[2], lo[2], hi[2], qlast[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = wr0 + g + 8 * hf;
    lo[hf] = live_lo(a, row[hf]);
    hi[hf] = live_hi(a, row[hf]);
    qlast[hf] = block_last(a, row[hf]);
  }

  // the logical KV blocks [j0, j1) of this block's rows: none reaches
  // past its logical query block when causal, and blocks below every
  // row's window are leading blocks with no live key
  const int n_kv = a.Skv / bkv;
  const int j0 = min(live_lo(a, q0) / bkv, n_kv);
  const int j1 = a.causal
      ? min(n_kv, block_last(a, min(q0 + ROWS, a.Sq) - 1) / bkv + 1)
      : n_kv;
  const int per = T == 1 ? 1 : 2 * T;        // steps a logical block
  const int nsteps = j1 > j0 ? (j1 - j0) * per : 0;

  // Q fragments: rows g, g+8 x words 8s + 2t, 8s + 2t + 1, zero past D
  int qa[KS][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int* qr = reinterpret_cast<const int*>(
        a.q + (((size_t)b * a.Sq + row[hf]) * a.H + h) * D);
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const bool in =
          row[hf] < a.Sq && (D % 32 == 0 || 8 * s + 2 * t < D / 4);
      qa[s][hf] = in ? qr[8 * s + 2 * t] : 0;
      qa[s][2 + hf] = in ? qr[8 * s + 2 * t + 1] : 0;
    }
  }

  // step st: logical block j, pass (0 max, 1 e16, 2 both), keys [k0, k1)
  auto step = [&](int st, int& j, int& pass, int& k0, int& k1) {
    j = j0 + st / per;
    const int r = st % per;
    pass = T == 1 ? 2 : r / T;
    k0 = j * bkv + (r % T) * KEYS;
    k1 = min(k0 + KEYS, (j + 1) * bkv);
  };
  unsigned vr[VU][4];
  auto issue = [&](int st) {
    int j, pass, k0, k1;
    step(st, j, pass, k0, k1);
    tc::load_k_wide<D, KEYS, THREADS>(sK + (st & 1) * KEYS * SK, k_at, k0,
                                      k1, tid, a.k);
    if (pass) tc::load_v<D, KEYS, THREADS>(vr, v_at, k0, k1, tid);
  };

  int m[2] = {NEG, NEG}, s[2] = {0, 0};
  int acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0;
  // the current logical block's row state
  bool act[2] = {false, false};
  int mc[2] = {NEG, NEG}, mn[2] = {NEG, NEG}, corr[2] = {0, 0};
  int bsum[2] = {0, 0};

  if (nsteps > 0) issue(0);
  tc::cp_commit();
  for (int st = 0; st < nsteps; ++st) {
    int j, pass, k0, k1;
    step(st, j, pass, k0, k1);
    if (pass) tc::store_v<D, KEYS, THREADS>(sVt, vr, tid);
    if (st + 1 < nsteps) issue(st + 1);
    tc::cp_commit();
    tc::cp_wait<1>();
    __syncthreads();
    const int t0 = j * bkv, nk = k1 - k0;
    if (wrows && (!a.causal || t0 <= w_qlast)) {
      const int* sKb = sK + (st & 1) * KEYS * SK;
      const bool tile_live = k0 < w_hi && k1 > w_lo;
      if (pass != 1 && k0 == t0) {           // the block's first step
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          act[hf] = row[hf] < a.Sq && (!a.causal || t0 <= qlast[hf]);
          mc[hf] = NEG;
          bsum[hf] = 0;
        }
      }
      // each row's live columns of the tile, [c_lo, c_hi) (empty when the
      // row is inactive)
      int c_lo[2], c_hi[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        c_lo[hf] = max(lo[hf] - k0, 0);
        c_hi[hf] = act[hf] ? min(hi[hf], k1) - k0 : 0;
      }
      auto live = [&](int col, int hf) {
        return col >= c_lo[hf] && col < c_hi[hf];
      };
      if (pass != 1 && tile_live) {          // the block max
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          if (8 * jn >= nk) break;
          int c[4];
          tc::qk_ntile<D>(sKb, jn, qa, g, t, c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1, col = 8 * jn + 2 * t + (e & 1);
            if (live(col, hf)) mc[hf] = max(mc[hf], c[e]);
          }
        }
      }
      if (pass != 1 && k1 == t0 + bkv) {     // the max pass is complete
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mc[hf] = max(mc[hf], __shfl_xor_sync(0xffffffffu, mc[hf], 1));
          mc[hf] = max(mc[hf], __shfl_xor_sync(0xffffffffu, mc[hf], 2));
          mn[hf] = max(m[hf], mc[hf]);
          corr[hf] = tc::exp16_mma(wsub(m[hf], mn[hf]), a.ex);
        }
        // rescale, then add: the block's P·V accumulates into these
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (act[e >> 1]) acc[nd][e] = rescale32(acc[nd][e], corr[e >> 1]);
      }
      if (pass != 0 && tile_live) {          // e16, u8 and P·V
#pragma unroll
        for (int sc = 0; sc < KEYS / 32; ++sc) {
          if (32 * sc >= nk) break;
          unsigned pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int jn = 4 * sc + jj;
            if (8 * jn >= nk) break;
            int c[4];
            tc::qk_ntile<D>(sKb, jn, qa, g, t, c);
            unsigned p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hf = e >> 1, col = 8 * jn + 2 * t + (e & 1);
              const int x = tc::exp16_mma(wsub(c[e], mn[hf]), a.ex);
              const int e16 = live(col, hf) ? x : 0;
              bsum[hf] = wadd(bsum[hf], e16);
              p[e] = (unsigned)(e16 >> 8) & 0xFFu;   // u8 as int8 bits
            }
            tc::pack_p(pa, jj, p);
          }
          const int afr[4] = {(int)pa[0], (int)pa[1], (int)pa[2], (int)pa[3]};
          tc::pv_chunk<D, KEYS>(acc, afr, sVt, sc, g, t);
        }
      }
      if (pass != 0 && k1 == t0 + bkv) {     // the block is complete
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          bsum[hf] = wadd(bsum[hf],
                          __shfl_xor_sync(0xffffffffu, bsum[hf], 1));
          bsum[hf] = wadd(bsum[hf],
                          __shfl_xor_sync(0xffffffffu, bsum[hf], 2));
          if (act[hf]) {
            s[hf] = wadd(rescale32(s[hf], corr[hf]), bsum[hf]);
            m[hf] = mn[hf];
          }
        }
      }
    }
    __syncthreads();
  }

  // finalize: rows g, g + 8, columns 8 nd + 2t, +1
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (row[hf] >= a.Sq) continue;
    const int s8 = max(s[hf] >> 8, 1);
    int8_t* orow = a.out + (((size_t)b * a.Sq + row[hf]) * a.H + h) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<char2*>(orow + 8 * nd + 2 * t) =
          make_char2((char)finalize(acc[nd][2 * hf], s8, a),
                     (char)finalize(acc[nd][2 * hf + 1], s8, a));
  }
}

template <int D>
inline int launch(const Args& a, cudaStream_t s) {
  dim3 grid((a.Sq + ROWS - 1) / ROWS, a.H, a.B);
  int_attention_online_kernel<D><<<grid, THREADS, a.smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace k8
}  // namespace r8

// the dynamic shared memory of a K8 block of head dim D, or -1 for a head
// dim the kernel is not compiled for; kernels/int_attention.py::
// k8_smem_bytes is the same
extern "C" long long r8_online_smem_bytes(int D) {
  if (D != 32 && D != 64 && D != 120 && D != 128) return -1;
  return r8::k8::smem_bytes(D);
}

extern "C" int r8_int_attention_online(const r8::k8::Args* a, void* stream) {
  // the launch plan must be the one this library computes for the shape
  if (a->B <= 0 || a->Sq <= 0 || a->Skv <= 0 || a->Hkv <= 0 ||
      a->H % a->Hkv || a->bq < 1 || a->bkv < 1 || a->Sq % a->bq ||
      a->Skv % a->bkv || a->Skv > (1 << 16) ||
      a->tiles != (a->bkv + r8::k8::KEYS - 1) / r8::k8::KEYS ||
      a->smem != r8_online_smem_bytes(a->D) || a->ex.z_shift < 0 ||
      a->ex.z_shift > 31)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 32:
      return r8::k8::launch<32>(*a, s);
    case 64:
      return r8::k8::launch<64>(*a, s);
    case 120:
      return r8::k8::launch<120>(*a, s);
    case 128:
      return r8::k8::launch<128>(*a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: D); out[6]
extern "C" int r8_attrs_int_attention_online(const int* sel, int threads,
                                             int smem, int cluster,
                                             int* out) {
  using r8::k8::int_attention_online_kernel;
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  switch (sel[0]) {
    case 32:
      return r8::attrs(int_attention_online_kernel<32>, threads, smem, 1, 1,
                       out);
    case 64:
      return r8::attrs(int_attention_online_kernel<64>, threads, smem, 1, 1,
                       out);
    case 120:
      return r8::attrs(int_attention_online_kernel<120>, threads, smem, 1, 1,
                       out);
    case 128:
      return r8::attrs(int_attention_online_kernel<128>, threads, smem, 1, 1,
                       out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
