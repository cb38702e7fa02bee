// K8: one-pass online integer-softmax attention (the `pallas` backend's
// attention), bit-exact against the TPU kernel at the same logical blocks.
//
// Replaces the TPU kernel repro/kernels/int_attention.py::
// int_attention_pallas (body _attn_kernel).
//
// What bounds it on the H100: at the encoder's shape (B = 32, S = 512,
// H = 12, D = 64) device-memory bytes, barely: q, k and v read once and
// the int8 output written once are 50 MB, 15 us at 3.35 TB/s, while one
// Q·Kᵀ and one P·V are 26 G operations, 13 us at the int8 tensor-core
// peak.  This kernel runs both products on the CUDA cores (__dp4a), once
// each -- K5 runs Q·Kᵀ three times -- so it is bound by integer
// instruction throughput and shared-memory bandwidth, far above 15 us.
//
// Semantics.  The TPU kernel's grid walks the logical KV blocks of size
// bkv in order for each logical query block of size bq, carrying per row
// the running max m (raw score scale), the running sum s of e16 and the
// int32 accumulator acc[D].  Per processed block, in this order: masked
// scores, the block max, m_new = max(m, block max), corr16 = exp16(m -
// m_new), e16 = exp16(score - m_new) (0 where masked), u8 = e16 >> 8,
// s = rescale32(s, corr16) + sum e16, acc = rescale32(acc, corr16) +
// u8·v.  exp16(0) is 32755, not 2^15, so every processed block shrinks s
// and acc even when the max does not move: the integers depend on the
// block partition.  Hence bq and bkv are runtime arguments here, the
// logical blocks of the TPU kernel, independent of this kernel's own
// 32-row tile: each row decides the causal skip (block j is processed
// iff j*bkv <= (r/bq)*bq + bq - 1) from its own logical query block, and
// the rescale happens at the logical block boundaries.  A window never
// skips a block.  The finalize is exact floor division of acc (which may
// be negative) by s8 = max(s >> 8, 1), 7 fraction bits, then the
// two-stage dyadic and the clip; the result is stored as int8.
//
// Design: one block of 128 threads per (32 query rows, head, sequence).
// Per logical KV block the K rows are staged in shared memory as 16-byte
// chunks and V transposed (keys packed four to a word), so that both
// products are __dp4a over 16-byte shared-memory loads: scores with one
// (row, key) pair per thread, then one warp per row for the block max,
// corr16, e16, the row sum and the packed u8 weights, then P·V with each
// thread owning (row, d) accumulators in registers.  Row strides are an
// odd number of 16-byte chunks, so the 16-byte loads of a quarter-warp
// hit distinct banks.  GQA: head h reads KV head h / (H / Hkv).
#include "int_common.cuh"

namespace r8 {

struct OnlineArgs {
  const int8_t* q;          // (B, Sq, H, D)
  const int8_t* k;          // (B, Skv, Hkv, D)
  const int8_t* v;          // (B, Skv, Hkv, D)
  int8_t* out;              // (B, Sq, H, D)
  int B, Sq, Skv, H, Hkv, D;
  int bq, bkv;              // logical blocks (divide Sq and Skv)
  int causal, window;
  int dn_b, dn_c, dn_pre;   // the per-tensor output dyadic
  int lo, hi;               // clip to out_bits
  SoftmaxConsts sm;
};

constexpr int ONLINE_THREADS = 128;
constexpr int ONLINE_ROWS = 32;             // query rows of a block
constexpr int ONLINE_NEG = -(1 << 30);      // masked-score sentinel
// dynamic shared memory a block may take: the H100's 227 KB less the
// per-row state below
constexpr int ONLINE_MAX_DYN_SMEM = 232448 - 4 * 4 * ONLINE_ROWS;

// words per row of Q/K (D bytes) and of Vᵀ/P (bkv keys, padded to 16):
// an odd number of 16-byte chunks
__host__ __device__ constexpr int online_wk(int D) {
  return 4 * ((D / 16) | 1);
}
__host__ __device__ constexpr int online_wv(int bkv) {
  return 4 * (((bkv + 15) / 16) | 1);
}
__host__ __device__ constexpr long long online_smem_bytes(int bkv, int D) {
  return 4LL * ((long long)(ONLINE_ROWS + bkv) * online_wk(D) +
                (long long)(D + ONLINE_ROWS) * online_wv(bkv) +
                (long long)ONLINE_ROWS * bkv);
}

// (x * corr16) >> 15 through a hi/lo split (core.softmax.rescale_sum):
// arithmetic >> 15 of a possibly negative x, plus the rounded low half
__device__ __forceinline__ int rescale32(int x, int corr16) {
  return wadd(wmul(x >> 15, corr16),
              rshift_round(wmul(x & 0x7FFF, corr16), 15));
}

__device__ __forceinline__ int dp4a16(const int4& a, const int4& b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

__device__ __forceinline__ bool online_live(const OnlineArgs& a, int qi,
                                            int t) {
  return (!a.causal || t <= qi) && (a.window <= 0 || t > qi - a.window);
}

template <int D>
__global__ void __launch_bounds__(ONLINE_THREADS)
int_attention_online_kernel(OnlineArgs a) {
  constexpr int NT = ONLINE_THREADS, TQ = ONLINE_ROWS;
  constexpr int D4 = D / 4, D16 = D / 16;
  constexpr int WK = online_wk(D);
  constexpr int RSTEP = NT / D;            // rows between a thread's accs
  constexpr int ACC = TQ / RSTEP;          // accumulators per thread
  const int bkv = a.bkv;
  const int WV = online_wv(bkv);
  const int bkv16 = (bkv + 15) & ~15;
  extern __shared__ int4 smem4[];
  int* sQ = reinterpret_cast<int*>(smem4);  // TQ x WK
  int* sK = sQ + TQ * WK;                   // bkv x WK
  int* sVt = sK + bkv * WK;                 // D x WV, 4 keys a word
  int* sP = sVt + D * WV;                   // TQ x WV, u8 weights
  int* sS = sP + TQ * WV;                   // TQ x bkv scores
  __shared__ int sM[TQ], sSum[TQ], sCorr[TQ], sAct[TQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int nrows = min(TQ, a.Sq - q0);

  for (int i = tid; i < TQ * D16; i += NT) {
    const int r = i / D16, c = i % D16;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < nrows) {
      const size_t off = (((size_t)b * a.Sq + q0 + r) * a.H + h) * D;
      v = reinterpret_cast<const int4*>(a.q + off)[c];
    }
    reinterpret_cast<int4*>(sQ + r * WK)[c] = v;
  }
  for (int r = tid; r < TQ; r += NT) {
    sM[r] = ONLINE_NEG;
    sSum[r] = 0;
  }

  // logical query blocks never decrease down the rows: the tile's last
  // row processes the most KV blocks, and the rest stop no later
  const int n_kv = a.Skv / bkv;
  int j_end = n_kv;
  if (a.causal) {
    const int qb_last = (q0 + nrows - 1) / a.bq;
    j_end = min(n_kv, (qb_last * a.bq + a.bq - 1) / bkv + 1);
  }

  const int d = tid % D;
  const int r0 = tid / D;
  int acc[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0;

  for (int jb = 0; jb < j_end; ++jb) {
    const int t0 = jb * bkv;
    __syncthreads();      // the previous block's tiles are consumed
    for (int i = tid; i < bkv * D16; i += NT) {
      const int j = i / D16, c = i % D16;
      const size_t off = (((size_t)b * a.Skv + t0 + j) * a.Hkv + hk) * D;
      reinterpret_cast<int4*>(sK + j * WK)[c] =
          reinterpret_cast<const int4*>(a.k + off)[c];
    }
    // V transposed: a warp takes 8 key quads x 4 words (16-byte global
    // segments), transposes each 4x4 byte square in registers and stores
    // sVt[d][quad] (two-way bank conflicts); keys past bkv are zero
    const int nquads = bkv16 / 4;
    const int nq8 = (nquads + 7) / 8;
    for (int i = tid; i < nq8 * 8 * D4; i += NT) {
      const int hi = i >> 5;
      const int jq = (hi / D16) * 8 + (i & 7);
      const int w = (hi % D16) * 4 + ((i >> 3) & 3);
      if (jq >= nquads) continue;
      int x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * jq + k;
        x[k] = 0;
        if (t < bkv) {
          const size_t off =
              (((size_t)b * a.Skv + t0 + t) * a.Hkv + hk) * D;
          x[k] = reinterpret_cast<const int*>(a.v + off)[w];
        }
      }
      const int t0w = __byte_perm(x[0], x[1], 0x5140);
      const int t1w = __byte_perm(x[0], x[1], 0x7362);
      const int t2w = __byte_perm(x[2], x[3], 0x5140);
      const int t3w = __byte_perm(x[2], x[3], 0x7362);
      sVt[(4 * w + 0) * WV + jq] = __byte_perm(t0w, t2w, 0x5410);
      sVt[(4 * w + 1) * WV + jq] = __byte_perm(t0w, t2w, 0x7632);
      sVt[(4 * w + 2) * WV + jq] = __byte_perm(t1w, t3w, 0x5410);
      sVt[(4 * w + 3) * WV + jq] = __byte_perm(t1w, t3w, 0x7632);
    }
    __syncthreads();

    // masked scores of the block (raw scale, -2^30 where masked)
    for (int p = tid; p < TQ * bkv; p += NT) {
      const int r = p / bkv, j = p % bkv;
      int s = ONLINE_NEG;
      if (r < nrows && online_live(a, q0 + r, t0 + j)) {
        const int4* qv = reinterpret_cast<const int4*>(sQ + r * WK);
        const int4* kv = reinterpret_cast<const int4*>(sK + j * WK);
        s = 0;
#pragma unroll
        for (int c = 0; c < D16; ++c) s = dp4a16(qv[c], kv[c], s);
      }
      sS[p] = s;
    }
    __syncthreads();

    // one warp per row: block max, m_new, corr16, e16, u8, the row sum
    for (int r = warp; r < TQ; r += NT / 32) {
      const int qi = q0 + r;
      const bool act = r < nrows &&
                       (!a.causal || t0 <= (qi / a.bq) * a.bq + a.bq - 1);
      if (!act) {
        if (lane == 0) sAct[r] = 0;
        continue;
      }
      const int* srow = sS + r * bkv;
      int mc = ONLINE_NEG;
      for (int j = lane; j < bkv; j += 32) mc = max(mc, srow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mc = max(mc, __shfl_xor_sync(~0u, mc, o));
      const int m_old = sM[r];
      const int m_new = max(m_old, mc);
      const int corr = exp16(wsub(m_old, m_new), a.sm);
      unsigned char* prow = reinterpret_cast<unsigned char*>(sP + r * WV);
      int sum = 0;
      for (int j = lane; j < bkv16; j += 32) {
        int e = 0;
        if (j < bkv && online_live(a, qi, t0 + j))
          e = exp16(wsub(srow[j], m_new), a.sm);
        sum = wadd(sum, e);
        prow[j] = (unsigned char)(e >> 8);    // e16 <= 32755: u8 <= 127
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum = wadd(sum, __shfl_xor_sync(~0u, sum, o));
      if (lane == 0) {
        sSum[r] = wadd(rescale32(sSum[r], corr), sum);
        sM[r] = m_new;
        sCorr[r] = corr;
        sAct[r] = 1;
      }
    }
    __syncthreads();

    // P·V: thread (r0 + e * RSTEP, d); rows that skip this block keep acc
    int dot[ACC];
#pragma unroll
    for (int e = 0; e < ACC; ++e) dot[e] = 0;
    const int4* vv = reinterpret_cast<const int4*>(sVt + d * WV);
    for (int c = 0; c < bkv16 / 16; ++c) {
      const int4 y = vv[c];
#pragma unroll
      for (int e = 0; e < ACC; ++e)
        dot[e] = dp4a16(
            reinterpret_cast<const int4*>(sP + (r0 + e * RSTEP) * WV)[c], y,
            dot[e]);
    }
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      const int r = r0 + e * RSTEP;
      if (sAct[r]) acc[e] = wadd(rescale32(acc[e], sCorr[r]), dot[e]);
    }
  }
  __syncthreads();

  // finalize: out7 = floor(acc / s8) * 128 + 7 exact fraction bits
#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    const int r = r0 + e * RSTEP;
    if (r >= nrows) continue;
    const int s8 = max(sSum[r] >> 8, 1);
    int whole = acc[e] / s8;                 // truncates toward zero ...
    int rem = acc[e] - whole * s8;
    if (rem < 0) {                           // ... so floor a negative acc
      whole -= 1;
      rem += s8;
    }
    const int frac7 = (rem << 7) / s8;       // 0 <= rem < s8 <= 2^23
    const int out7 = wadd(wmul(whole, 128), frac7);
    const int o = clampi(dyadic(out7, a.dn_b, a.dn_c, a.dn_pre), a.lo, a.hi);
    a.out[(((size_t)b * a.Sq + q0 + r) * a.H + h) * D + d] = (int8_t)o;
  }
}

template <int D>
inline int launch_online(const OnlineArgs& a, int smem, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      int_attention_online_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + ONLINE_ROWS - 1) / ONLINE_ROWS, a.H, a.B);
  int_attention_online_kernel<D><<<grid, ONLINE_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace r8

// the dynamic shared memory a block of (bkv, D) takes, or -1 for a head
// dim the kernel is not compiled for; the wrapper's refusals read these
extern "C" long long r8_online_smem_bytes(int bkv, int D) {
  if (D != 32 && D != 64 && D != 128) return -1;
  return r8::online_smem_bytes(bkv, D);
}

// the most dynamic shared memory a block may take
extern "C" long long r8_online_smem_limit() {
  return r8::ONLINE_MAX_DYN_SMEM;
}

extern "C" int r8_int_attention_online(const r8::OnlineArgs* a,
                                       void* stream) {
  if (a->B <= 0 || a->Sq <= 0 || a->Skv <= 0 || a->Hkv <= 0 ||
      a->H % a->Hkv || a->bq < 1 || a->bkv < 1 || a->Sq % a->bq ||
      a->Skv % a->bkv || a->Skv > (1 << 16))
    return (int)cudaErrorInvalidValue;
  const long long smem = r8_online_smem_bytes(a->bkv, a->D);
  if (smem < 0 || smem > r8::ONLINE_MAX_DYN_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 32:
      return r8::launch_online<32>(*a, (int)smem, s);
    case 64:
      return r8::launch_online<64>(*a, (int)smem, s);
    case 128:
      return r8::launch_online<128>(*a, (int)smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
