// K4: paged chunked-prefill integer attention, bit-exact.
//
// Replaces the TPU kernel
// repro/kernels/int_attention_fused.py::int_paged_prefill_fused
// (body _paged_prefill_kernel over _streaming_attn_body).
//
// What bounds it on the H100: int8 operations and latency, not bytes.  A
// chunk of C query rows per lane attends to history plus chunk (causal to
// pos_end), so each live K row is reused by up to C query rows and each
// (lane, head) block does about 3 * C * pos_end * hd multiply-adds for
// Q·Kᵀ (recomputed per sweep) plus C * pos_end * hd for P·V.
//
// Design: one block per (16-row query block, head, lane), so a 32-token
// chunk of 4 lanes at 32 heads gives 256 blocks.  The chunk's K/V were
// already scattered into the pools (ops.paged.scatter_chunk); the block
// walks the live logical positions of its lane up to its last row's
// causal limit, translating each through the page table, and runs the
// shared three-sweep body of int_attention.cuh with the stepped mask
// t < pos_end - (C - 1 - i), which is causal attention over history +
// chunk.  As in K3, the folded o-projection is the wrapper's K1 launch on
// this launch's int8 tile (blocks of different heads run in parallel, so
// no accumulator can be carried across the head axis as on the TPU).
#include "int_attention.cuh"

extern "C" int r8_int_paged_prefill(const r8::AttnArgs* a, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return r8::launch_attention<16, 64, true, false>(*a, s);
}
