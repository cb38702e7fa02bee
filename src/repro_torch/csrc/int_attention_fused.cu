// K5: full-sequence integer attention, bit-exact (the encoder's and every
// full-sequence prefill's attention).
//
// Replaces the TPU kernel
// repro/kernels/int_attention_fused.py::int_attention_fused
// (body _fused_kernel over _streaming_attn_body).
//
// What bounds it on the H100: at the encoder's shape (B = 32, S = 512,
// H = 12, D = 64) the card's own bound is device-memory bytes, barely:
// q, k and v read once and the int8 output written once are 50 MB, 15 us
// at 3.35 TB/s, while one Q·Kᵀ and one P·V are 26 G operations, 13 us at
// the int8 tensor-core peak.  Both products run on the tensor cores here
// (int_attention_mma.cuh), so what is left is the elementwise Shiftmax on
// the CUDA cores: exp16, some 25-30 int32 instructions with its division
// as a multiply-high, once per live (row, key) pair with the e16 store,
// twice without, over 100.7 M live pairs at the encoder's shape.
//
// Design (int_attention_mma.cuh): one block of 4 warps per (64 query rows,
// head, sequence); Q fragments in registers for the whole launch; K tiles
// of 64 keys by cp.async into a double buffer; row max and row sum in
// registers; e16 kept in shared memory where the block's key range fits,
// so sweep 2 reads no K; p8 packed straight from the score accumulators
// into A fragments against a Vᵀ staged with the same key permutation.
// The TPU kernel's grid walked the KV blocks in order, three times,
// carrying the row max and sum in scratch; here one block owns its rows
// for all three sweeps.  Head dims 32, 64, 120 and 128; at D = 120 (h2o-
// danube-3-4b) Q·Kᵀ takes four k-steps over rows padded to 128 bytes (Q
// zero past D, in registers), K tiles come in 8-byte granules (a head's
// row is 120 bytes, 8-byte aligned), and P·V keeps 15 output n-tiles.
#include "int_attention_mma.cuh"
#include "int_attrs.cuh"

// the dynamic shared memory of a K5 block (head dim D, `tiles` key tiles
// of e16 store when `store`), or -1 for a head dim the kernel is not
// compiled for; kernels/int_attention_fused.py::k5_smem_bytes is the same
extern "C" long long r8_k5_smem_bytes(int D, int tiles, int store) {
  if (D != 32 && D != 64 && D != 120 && D != 128) return -1;
  return r8::k5::smem_bytes(D, tiles, store != 0);
}

extern "C" int r8_int_attention_fused(const r8::k5::Args* a, void* stream) {
  // the launch plan must be the one this library computes for the shape
  if (a->B <= 0 || a->Sq <= 0 || a->Skv < 0 || a->Hkv <= 0 ||
      a->H % a->Hkv || a->ex.z_shift < 0 || a->ex.z_shift > 31 ||
      a->tiles != r8::k5::max_tiles(a->Sq, a->Skv, a->causal, a->window) ||
      a->smem != r8_k5_smem_bytes(a->D, a->tiles, a->store_e16) ||
      a->smem > r8::k5::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 32:
      return r8::k5::launch_d<32>(*a, s);
    case 64:
      return r8::k5::launch_d<64>(*a, s);
    case 120:
      return r8::k5::launch_d<120>(*a, s);
    case 128:
      return r8::k5::launch_d<128>(*a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

namespace r8 {
namespace k5 {

// exp16's division on every n in [0, n_max]: bad counts the n where the
// multiply-high and `/` differ
__global__ void div_check_kernel(int n_max, int q_ln2, unsigned magic,
                                 int shift, int* bad) {
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n <= n_max;
       n += gridDim.x * blockDim.x)
    if (tc::div_ln2(n, magic, shift) != n / q_ln2) atomicAdd(bad, 1);
}

}  // namespace k5
}  // namespace r8

// exp16's multiply-high division (K5's and K8's) against `/` on every n
// in [0, n_max]; *bad (zeroed by the caller) receives the count of
// differences
extern "C" int r8_exp16_div_check(int n_max, int q_ln2, unsigned magic,
                                  int shift, int* bad, void* stream) {
  if (q_ln2 <= 0 || n_max < 0 || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int blocks = n_max / 256 + 1;
  r8::k5::div_check_kernel<<<blocks < 4096 ? blocks : 4096, 256, 0, s>>>(
      n_max, q_ln2, magic, shift, bad);
  return (int)cudaGetLastError();
}

namespace r8 {
namespace k5 {

template <int D>
int attrs_d(int lo, int store, int threads, int smem, int* out) {
  if (lo)
    return store ? attrs(int_attention_mma_kernel<D, true, true>, threads,
                         smem, 1, 1, out)
                 : attrs(int_attention_mma_kernel<D, true, false>, threads,
                         smem, 1, 1, out);
  return store ? attrs(int_attention_mma_kernel<D, false, true>, threads,
                       smem, 1, 1, out)
               : attrs(int_attention_mma_kernel<D, false, false>, threads,
                       smem, 1, 1, out);
}

}  // namespace k5
}  // namespace r8

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: D, LO (a window), STORE); out[6]
extern "C" int r8_attrs_int_attention_fused(const int* sel, int threads,
                                            int smem, int cluster, int* out) {
  using namespace r8::k5;
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  switch (sel[0]) {
    case 32: return attrs_d<32>(sel[1], sel[2], threads, smem, out);
    case 64: return attrs_d<64>(sel[1], sel[2], threads, smem, out);
    case 120: return attrs_d<120>(sel[1], sel[2], threads, smem, out);
    case 128: return attrs_d<128>(sel[1], sel[2], threads, smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
