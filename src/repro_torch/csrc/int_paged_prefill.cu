// K4: paged chunked-prefill integer attention, bit-exact.
//
// Replaces the TPU kernel
// repro/kernels/int_attention_fused.py::int_paged_prefill_fused
// (body _paged_prefill_kernel over _streaming_attn_body).
//
// What bounds it on the H100: neither bytes nor operations, but latency.
// A chunk of C query rows a lane attends to history plus chunk (causal to
// pos_end): at the serving shape (4 lanes, C = 32, H = 32, Hkv = 8,
// D = 128, pos_end <= 512) the live K/V rows and the queries are under
// 3 MB (~1 us at 3.35 TB/s) and the integer work of the 0.92 M live
// (row, key) pairs of all heads, ~40 int32 operations each, is ~2 us of
// the CUDA cores, while the longest lane walks 8 key tiles three times,
// one after the other.
//
// Design: the K5 body of int_attention_mma.cuh, instantiated PAGED: Q·Kᵀ
// and P·V on mma.sync s8, K tiles by cp.async into a double buffer, row
// max and sum in registers, e16 kept in shared memory where the page
// table's span fits (sweep 2 then reads no K), the branch-free exp16.
// What K4 adds to K5:
//   - keys through the page table: key t of lane b is row t % page_size
//     of page pages[b, t / page_size]; the chunk's own K/V were already
//     scattered into the pools (ops.paged.scatter_chunk);
//   - the stepped mask t < pos_end[b] - (C - 1 - i), which is causal
//     attention over history + chunk; the kernel reads pos_end itself, so
//     the launch needs no value from the device;
//   - packed int4 pools (kv_shifts, the kv_dtype="int4" tier): one more
//     instantiation, int_paged_prefill_kv4_kernel, selected by a template
//     argument so the int8 instantiations keep their code.  cp.async
//     cannot expand nibbles, so K rows come through registers one tile
//     ahead (4 packed bytes a load) and are expanded with each key's page
//     shift into the same int8 K tile; V's units load 2 packed bytes a key
//     and expand before the Vᵀ store (int_attention_tc.cuh).  A key moves
//     half the bytes of the int8 pools.  Copying the packed rows by
//     cp.async into a staging tile and expanding them shared-to-shared
//     (one more barrier a tile) was measured 1.3x slower at the serving
//     shape (PERF.md);
// A block is K5's: 64 chunk rows of one (lane, head), grid
// (ceil(C / 64), H, B).  At the serving C = 32 its last two warps have no
// rows; packing 2 or 4 query heads of a KV group into a block, so that
// they share its K/V tiles, was measured at that shape and was no faster
// (PERF.md).
// As in K3, the folded o-projection is the wrapper's K1 launch on this
// launch's int8 tile (blocks of different heads run in parallel, so no
// accumulator can be carried across the head axis as on the TPU).
#include "int_attention_mma.cuh"
#include "int_attrs.cuh"

namespace r8 {
namespace k4 {

// one block an SM is all the launch asks for (128 blocks at the serving
// shape): without that bound ptxas trades registers for occupancy and
// spills the D = 32 / 64 e16-store instantiations
template <int D, bool STORE>
__global__ void __launch_bounds__(k5::THREADS, 1)
int_paged_prefill_mma_kernel(k5::Args a) {
  k5::attend<D, false, STORE, true>(a);
}

// the same over packed int4 pools
template <int D, bool STORE>
__global__ void __launch_bounds__(k5::THREADS, 1)
int_paged_prefill_kv4_kernel(k5::Args a) {
  k5::attend<D, false, STORE, true, true>(a);
}

// (not `launch`: ADL on k5::Args would also find k5::launch)
template <int D, bool STORE, bool PACKED>
inline int launch_k4(const k5::Args& a, cudaStream_t s) {
  void (*kernel)(k5::Args) = PACKED ? int_paged_prefill_kv4_kernel<D, STORE>
                                    : int_paged_prefill_mma_kernel<D, STORE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + k5::ROWS - 1) / k5::ROWS, a.H, a.B);
  kernel<<<grid, k5::THREADS, a.smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
inline int launch_d(const k5::Args& a, cudaStream_t s) {
  if (a.k_shift)
    return a.store_e16 ? launch_k4<D, true, true>(a, s)
                       : launch_k4<D, false, true>(a, s);
  return a.store_e16 ? launch_k4<D, true, false>(a, s)
                     : launch_k4<D, false, false>(a, s);
}

}  // namespace k4
}  // namespace r8

extern "C" int r8_int_paged_prefill(const r8::k5::Args* a, void* stream) {
  // the launch plan must be the one kernels/int_attention_fused.py::
  // k4_launch_plan computes for the shape: the page table's whole span in
  // key tiles
  const long long span = (long long)a->max_pages * a->page_size;
  if (a->B <= 0 || a->Sq <= 0 || a->Hkv <= 0 || a->H % a->Hkv ||
      a->page_size <= 0 || a->max_pages < 0 ||
      !a->pages || !a->pos_end || span != a->Skv ||
      a->tiles != (a->Skv + r8::k5::KEYS - 1) / r8::k5::KEYS ||
      a->ex.z_shift < 0 || a->ex.z_shift > 31 ||
      a->smem != r8::k5::smem_bytes(a->D, a->tiles, a->store_e16 != 0) ||
      a->smem > r8::k5::SMEM_LIMIT || !a->k_shift != !a->v_shift ||
      (a->k_shift && a->vec_k))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (a->D) {
    case 32:
      return r8::k4::launch_d<32>(*a, s);
    case 64:
      return r8::k4::launch_d<64>(*a, s);
    case 120:
      return r8::k4::launch_d<120>(*a, s);
    case 128:
      return r8::k4::launch_d<128>(*a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

namespace r8 {
namespace k4 {

template <int D>
int attrs_d(int store, int packed, int threads, int smem, int* out) {
  if (packed)
    return store ? attrs(int_paged_prefill_kv4_kernel<D, true>, threads,
                         smem, 1, 1, out)
                 : attrs(int_paged_prefill_kv4_kernel<D, false>, threads,
                         smem, 1, 1, out);
  return store ? attrs(int_paged_prefill_mma_kernel<D, true>, threads, smem,
                       1, 1, out)
               : attrs(int_paged_prefill_mma_kernel<D, false>, threads, smem,
                       1, 1, out);
}

}  // namespace k4
}  // namespace r8

// The card's attributes of one instantiation at a launch's threads, shared
// memory and cluster (int_attrs.cuh; sel: D, STORE, packed); out[6]
extern "C" int r8_attrs_int_paged_prefill(const int* sel, int threads,
                                          int smem, int cluster, int* out) {
  using namespace r8::k4;
  if (cluster != 1) return (int)cudaErrorInvalidValue;
  switch (sel[0]) {
    case 32: return attrs_d<32>(sel[1], sel[2], threads, smem, out);
    case 64: return attrs_d<64>(sel[1], sel[2], threads, smem, out);
    case 120: return attrs_d<120>(sel[1], sel[2], threads, smem, out);
    case 128: return attrs_d<128>(sel[1], sel[2], threads, smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
