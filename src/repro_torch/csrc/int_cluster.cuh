// Thread block cluster pieces shared by the kernels that split work across
// the blocks of a cluster and reduce through distributed shared memory:
// K1's decode tile (int8_matmul_decode.cu: split K), K1's grouped
// instantiation (int8_matmul_grouped.cu: split K, one barrier an item)
// and K3 (int_decode_attention.cu: split keys).
//
// A block may touch another block's shared memory only once every block
// of the cluster has started (cluster_arrive at the top of the kernel,
// cluster_wait before the first remote access, or one cluster_sync), and
// must not exit while another block may still access its own.  Remote
// stores and reductions are ordered before a cluster_sync by its release,
// and visible after it by its acquire.  Every block of a cluster runs the
// same sequence of cluster barriers, so none can wait for a block that
// never arrives.
#pragma once

#include <cuda_runtime.h>

namespace r8 {

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the two halves of cluster_sync, for a barrier split around work that
// needs no other block (the first remote access waits)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// the arrive half with release semantics: this thread's earlier stores,
// remote ones included, are visible to every block after its wait
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the same shared-memory offset in the block of cluster rank `rank`
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(unsigned addr, int4 v) {
  asm volatile("st.shared::cluster.v4.s32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster(unsigned addr, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// *addr += v in another block's (or this block's) shared memory, modulo
// 2^32: integer sums do not depend on the order the blocks add in
__device__ __forceinline__ void red_add_cluster(unsigned addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;\n" ::"r"(
                   addr),
               "r"(v)
               : "memory");
}

}  // namespace r8
