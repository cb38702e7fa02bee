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
// the int8 tensor-core peak.  This kernel runs on the CUDA cores instead
// (__dp4a for Q·Kᵀ, scalar int32 multiply-adds for P·V) and recomputes
// Q·Kᵀ in each of its three sweeps, so in practice it is bound by integer
// instruction throughput and shared-memory bandwidth, far above 15 us.
//
// Design: one block per (16-row query block, head, sequence), so the
// encoder launch has 32 x 12 x 32 = 12 288 blocks.  K/V are read in
// their contiguous (B, Skv, Hkv, D) layout (no page table, no copy), in
// 64-key tiles through shared memory.  The mask is a per-row live range
// [lo_i, hi_i) computed in the block: none, causal (hi_i = i + 1) or
// causal with a sliding window (lo_i = i - window + 1); key tiles outside
// the block's rows' ranges are never loaded, so a causal launch does
// about half the work of a full one.  The three exact sweeps (row max,
// row sum of e16, normalised P·V) and the per-tensor / per-channel / raw
// epilogue are the body shared with K3 and K4 in int_attention.cuh.  The
// TPU kernel's grid walked the KV blocks in order, three times, carrying
// the row max and sum in scratch; here one block owns its rows for all
// three sweeps, so the carried state is shared memory and no pass over
// device memory is added.
#include "int_attention.cuh"

extern "C" int r8_int_attention_fused(const r8::AttnArgs* a, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (a->mask == r8::MASK_STEPPED) return (int)cudaErrorInvalidValue;
  if (a->window > 0 && a->mask == r8::MASK_CAUSAL)
    return r8::launch_attention<16, 64, false, true>(*a, s);
  return r8::launch_attention<16, 64, false, false>(*a, s);
}
