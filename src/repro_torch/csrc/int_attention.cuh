// K3's body (decode attention over a paged or contiguous cache,
// int_decode_attention.cu): the exact three-sweep integer attention on the
// CUDA cores (__dp4a).  K4 and K5
// compute the same sweeps on the int8 tensor cores (int_attention_mma.cuh).
//
// Twin of repro/kernels/int_attention_fused.py::_streaming_attn_body:
//
//   sweep 0  row max   m = max_t score(r, t)                (atomicMax)
//   sweep 1  row sum   s = sum_t e16(score(r, t) - m)       (atomicAdd)
//   sweep 2  p8 = clip(rshift_round(e16 * (2^30 // s), 23), 0, 127);
//            acc[r][d] += p8 * v8[t][d]
//
// then the RequantSpec epilogue.  Integer max and modular integer sums
// are associative and commutative, so the parallel reductions give the
// reference's bits exactly.  Q·Kᵀ is recomputed per sweep (three __dp4a
// dot products per live position instead of a stored score row), so any
// key length up to the 2^15 row-sum budget fits the same shared memory.
//
// Per-row limits: query row i (of S rows) attends to the positions
// [0, hi_i), hi_i = valid_len - (S - 1 - i), clamped to the key length
// L = max_pages * page_size (valid_len is the lane's occupancy).  A
// sliding window's rolling buffer holds its positions in any order; the
// max and the sums do not depend on the order, so it needs nothing more.  hi_i
// never decreases with i, so a block of rows visits [0, hi of its last
// row) and no key block past it.  A row whose range is empty keeps max
// -2^30, sum 0 and a zero accumulator, as the reference's all-masked row
// does.
//
// Addressing: paged, the pools are (num_pages, page_size, Hkv, D) and
// position t of lane b lives at page pages[b, t / page_size], row
// t % page_size; contiguous (pages null), the cache is (B, L, Hkv, D),
// passed as one page of L rows a lane, and position t of lane b is row
// b * L + t.  D is any multiple of 4 (rows are read as words).  GQA:
// query head h reads KV head h / (H / Hkv).
//
// PACKED (paged only): int4 pools (num_pages, page_size, Hkv, D / 2), two
// head-dim lanes a byte, with per-page shifts k_shift / v_shift
// (num_pages,).  The copy loop reads 2 packed bytes where it read a word
// and expands them to the word's four int8 lanes with the shift of the
// key's page (unpack_kv4, int_common.cuh); the sweeps read the same int8
// tiles as the int8 instantiations.  Packed rows start on 2-byte
// boundaries (D / 2 is even), so the 2-byte loads are aligned for every D.
#pragma once

#include "int_common.cuh"

namespace r8 {

struct AttnArgs {
  const int8_t* q;          // (B, S, H, D)
  const int8_t* k;          // (num_pages, page_size, Hkv, D) or
  const int8_t* v;          //   contiguous (B, L, Hkv, D)
  const int* pages;         // (B, max_pages), or null: contiguous
  const int* vlen;          // (B,) valid_len
  const int* bvec;          // (H * D,) per-channel multipliers or null
  void* out;                // (B, S, H, D) int8 or int32
  int B, S, H, Hkv, D, page_size, max_pages;  // contiguous: L, 1
  int out_is_int8;
  SoftmaxConsts sm;
  Requant rq;
  const int* k_shift;       // (num_pages,) packed int4 pools, or null:
  const int* v_shift;       //   int8 pools
};

// hi of query row i (its keys are [0, hi)), clamped to [0, L]
__device__ __forceinline__ int row_hi(const AttnArgs& a, int vl, int L,
                                      int i) {
  return min(max(vl - (a.S - 1 - i), 0), L);
}

constexpr int ATTN_THREADS = 128;

// dynamic shared memory of one block (bytes)
__host__ __device__ constexpr int attn_smem_bytes(int BQ, int TK, int D) {
  return (BQ * (D / 4 + 1) + TK * (D / 4 + 1)) * 4 + TK * D + BQ * TK * 4;
}

// BQ query rows a block, key tiles of TK; PAGED: keys through the page
// table, else the contiguous cache; PACKED: int4 pools
template <int BQ, int TK, int D, bool PAGED, bool PACKED = false>
__global__ void __launch_bounds__(ATTN_THREADS)
int_attention_kernel(AttnArgs a) {
  static_assert(PAGED || !PACKED, "packed int4 pools are paged");
  constexpr int NT = ATTN_THREADS;
  constexpr int D4 = D / 4;
  constexpr int QS = D4 + 1;               // padded word stride (banks)
  constexpr int ACC = (BQ * D + NT - 1) / NT;
  extern __shared__ int smem[];
  int* sQ = smem;                          // BQ x QS packed q words
  int* sK = sQ + BQ * QS;                  // TK x QS packed k words
  int8_t* sV = reinterpret_cast<int8_t*>(sK + TK * QS);   // TK x D
  int* sP = reinterpret_cast<int*>(sV + TK * D);          // BQ x TK
  __shared__ int sMax[BQ], sSum[BQ], sR[BQ], sHi[BQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int L = a.max_pages * a.page_size;
  const int nrows = min(BQ, a.S - q0);
  const int vl = a.vlen[b];
  const int* ptab = PAGED ? a.pages + (size_t)b * a.max_pages : nullptr;

  for (int i = tid; i < BQ * D4; i += NT) {
    const int r = i / D4, w = i % D4;
    int v = 0;
    if (r < nrows) {
      const size_t off = (((size_t)b * a.S + q0 + r) * a.H + h) * D;
      v = reinterpret_cast<const int*>(a.q + off)[w];
    }
    sQ[r * QS + w] = v;
  }
  for (int r = tid; r < BQ; r += NT) {
    sHi[r] = r < nrows ? row_hi(a, vl, L, q0 + r) : 0;
    sMax[r] = -(1 << 30);
    sSum[r] = 0;
  }
  __syncthreads();
  // ranges never shrink down the rows: the block's keys are [0, t_hi)
  const int t_hi = sHi[nrows - 1];

  int acc[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0;

  for (int sweep = 0; sweep < 3; ++sweep) {
    if (sweep == 2) {
      for (int r = tid; r < BQ; r += NT)
        // s >= 0 (sum of non-negative e16, <= 2^30): truncation == floor
        sR[r] = (1 << 30) / max(sSum[r], 1);
      __syncthreads();
    }
    for (int t0 = 0; t0 < t_hi; t0 += TK) {
      for (int i = tid; i < TK * D4; i += NT) {
        const int j = i / D4, w = i % D4;
        const int t = t0 + j;
        int kv = 0, vv = 0;
        if (t < t_hi) {
          const size_t row =
              PAGED ? (size_t)ptab[t / a.page_size] * a.page_size +
                          t % a.page_size
                    : (size_t)b * L + t;
          if constexpr (PACKED) {
            const int page = ptab[t / a.page_size];
            const size_t off = (row * a.Hkv + hk) * (D / 2);
            kv = (int)unpack_kv4(
                reinterpret_cast<const unsigned short*>(a.k + off)[w],
                a.k_shift[page]);
            if (sweep == 2)
              vv = (int)unpack_kv4(
                  reinterpret_cast<const unsigned short*>(a.v + off)[w],
                  a.v_shift[page]);
          } else {
            const size_t off = (row * a.Hkv + hk) * D;
            kv = reinterpret_cast<const int*>(a.k + off)[w];
            if (sweep == 2) vv = reinterpret_cast<const int*>(a.v + off)[w];
          }
        }
        sK[j * QS + w] = kv;
        if (sweep == 2) reinterpret_cast<int*>(sV)[j * D4 + w] = vv;
      }
      __syncthreads();
      for (int p = tid; p < BQ * TK; p += NT) {
        const int r = p / TK, j = p % TK;
        const int t = t0 + j;
        const bool live = t < sHi[r];
        int score = 0;
        if (live) {
#pragma unroll 8
          for (int w = 0; w < D4; ++w)
            score = __dp4a(sQ[r * QS + w], sK[j * QS + w], score);
        }
        if (sweep == 0) {
          if (live) atomicMax(&sMax[r], score);
        } else if (sweep == 1) {
          if (live) atomicAdd(&sSum[r], exp16(wsub(score, sMax[r]), a.sm));
        } else {
          int pr = 0;
          if (live) {
            const int e16 = exp16(wsub(score, sMax[r]), a.sm);
            pr = clampi(rshift_round(wmul(e16, sR[r]), 23), 0, 127);
          }
          sP[r * TK + j] = pr;
        }
      }
      __syncthreads();
      if (sweep == 2) {
#pragma unroll
        for (int e = 0; e < ACC; ++e) {
          const int idx = tid + e * NT;
          if (idx < BQ * D) {
            const int r = idx / D, d = idx % D;
            int s = acc[e];
            for (int j = 0; j < TK; ++j)
              s += sP[r * TK + j] * (int)sV[j * D + d];
            acc[e] = s;
          }
        }
        __syncthreads();
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    const int idx = tid + e * NT;
    if (idx >= BQ * D) continue;
    const int r = idx / D, d = idx % D;
    if (r >= nrows) continue;
    int v = acc[e];
    if (a.rq.kind != RQ_RAW) {
      const int bm = a.rq.kind == RQ_PER_CHANNEL ? a.bvec[h * D + d] : a.rq.b;
      v = requant(v, a.rq, bm);
    }
    const size_t o = (((size_t)b * a.S + q0 + r) * a.H + h) * D + d;
    if (a.out_is_int8)
      reinterpret_cast<int8_t*>(a.out)[o] = (int8_t)v;
    else
      reinterpret_cast<int*>(a.out)[o] = v;
  }
}

template <int BQ, int TK, int D>
inline void launch_layout(const AttnArgs& a, dim3 grid, cudaStream_t s) {
  constexpr int smem = attn_smem_bytes(BQ, TK, D);
  if (a.k_shift)
    int_attention_kernel<BQ, TK, D, true, true>
        <<<grid, ATTN_THREADS, smem, s>>>(a);
  else if (a.pages)
    int_attention_kernel<BQ, TK, D, true><<<grid, ATTN_THREADS, smem, s>>>(a);
  else
    int_attention_kernel<BQ, TK, D, false><<<grid, ATTN_THREADS, smem, s>>>(a);
}

// launch one instantiation; D must be 32, 64, 120 or 128
template <int BQ, int TK>
inline int launch_attention(const AttnArgs& a, cudaStream_t s) {
  if (!a.vlen || (!a.pages && a.max_pages != 1) ||
      !a.k_shift != !a.v_shift || (a.k_shift && !a.pages))
    return (int)cudaErrorInvalidValue;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  switch (a.D) {
    case 32:
      launch_layout<BQ, TK, 32>(a, grid, s);
      break;
    case 64:
      launch_layout<BQ, TK, 64>(a, grid, s);
      break;
    case 120:
      launch_layout<BQ, TK, 120>(a, grid, s);
      break;
    case 128:
      launch_layout<BQ, TK, 128>(a, grid, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace r8
