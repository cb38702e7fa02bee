// K3: integer decode attention over a paged or contiguous KV cache,
// bit-exact.
//
// Replaces the TPU kernel
// repro/kernels/int_decode_attention.py::int_decode_attention_fused
// (body _decode_kernel over _streaming_attn_body).
//
// What bounds it on the H100: device-memory bytes of the live KV rows.
// Each (lane, query head) reads valid_len K and V rows of its KV head
// (D bytes each) and does two int8 dot products per row and sweep; at
// decode batch 4 a 512-position cache moves well under a megabyte, so in
// practice it is bound by launch latency and the three dependent sweeps,
// not by the card's rates (a full 4096-position window moves 31.5 MB).
//
// Design: one block per (query-row block, head, lane): S <= 8 query rows
// (one for plain decode, up to MAX_SQ for a stepped speculative launch).
// The block walks only the live logical positions of its lane — dead KV
// positions past valid_len are never touched — translating each position
// through the page table itself (the TPU kernel did this in its
// scalar-prefetch index map), or, with no table, reading row b * L + t of
// the contiguous (B, L, Hkv, D) cache.  The three exact sweeps and the
// epilogue are the shared body in int_attention.cuh.  Over packed int4
// pools (kv_shifts) the body is instantiated PACKED: its copy loop reads
// half the bytes and expands them with each key's page shift.  The folded
// o-projection is not carried across heads here: TPU grid steps run in
// order and carried a (Sq, N) accumulator across the head axis, but GPU
// blocks run in parallel, so the wrapper writes this launch's int8
// (B, Sq, H, D) tile and runs the o-projection as one K1 launch — integer
// sums do not depend on order, so the result is bit-exact either way.
#include "int_attention.cuh"

extern "C" int r8_int_decode_attention(const r8::AttnArgs* a, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (a->S == 1) return r8::launch_attention<1, 128>(*a, s);
  if (a->S <= 8) return r8::launch_attention<8, 128>(*a, s);
  return (int)cudaErrorInvalidValue;
}
