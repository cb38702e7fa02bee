// What the card says of one compiled kernel instantiation: its registers,
// spills and thread limit (cudaFuncGetAttributes), and how many CTAs of a
// launch's size an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// or, for a thread block cluster, how many clusters the card holds
// (cudaOccupancyMaxActiveClusters).  Each kernel file exports one
// r8_attrs_<kernel> entry that picks the instantiation from its template
// selectors and calls attrs() below; analysis/contracts.py's LaunchReport
// names the entry and the selectors (``kernel``), chip_smoke.py's
// ``analysis`` phase calls it at the report's threads, shared memory and
// cluster.  Nothing here launches a kernel.
#pragma once

#include <cuda_runtime.h>

namespace r8 {

// out[0] registers a thread, [1] local (spill) bytes a thread, [2] the
// kernel's maxThreadsPerBlock, [3] its static shared bytes, [4] occupancy
// (CTAs an SM, or clusters on the card when the cluster has more than one
// CTA), [5] the dynamic shared bytes the kernel may take after this call.
// The kernel's dynamic shared-memory limit is only ever raised (to
// `smem`), never lowered, so a launch that set it keeps what it needs.
// `cx` / `cz`: the cluster's extent along x / z, as the launch sets it.
template <class Kernel>
int attrs(Kernel kern, int threads, int smem, int cx, int cz, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  if (smem > fa.maxDynamicSharedSizeBytes) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    fa.maxDynamicSharedSizeBytes = smem;
  }
  int occ = 0;
  if (cx * cz > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cx, 1, cz);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cx;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = cz;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&occ, kern, &cfg);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads,
                                                      smem);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = fa.maxThreadsPerBlock;
  out[3] = (int)fa.sharedSizeBytes;
  out[4] = occ;
  out[5] = fa.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace r8
