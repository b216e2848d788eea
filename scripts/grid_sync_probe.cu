// A cooperative kernel that does nothing but `syncs` grid-wide barriers
// (cooperative_groups' grid.sync()), for timing one barrier at the
// preconditioner kernel's launch geometry. Built and timed by
// scripts/precond_breakdown.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__global__ void grid_sync_probe(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < syncs; ++k) grid.sync();
}

extern "C" int tsl_grid_sync_probe(int grid, int threads, int smem_bytes,
                                   int syncs, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grid_sync_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&syncs};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_sync_probe), dim3(grid),
      dim3(threads), args, static_cast<size_t>(smem_bytes),
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
