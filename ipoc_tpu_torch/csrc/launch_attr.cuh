// Launch attributes shared by the C entries: the dynamic shared memory a
// kernel may take, and the card's view of a kernel's occupancy.

#pragma once

#include <cuda_runtime.h>

namespace ipoc {

// The dynamic shared memory a block may take on an H100 (sm_90): 227 KB.
constexpr size_t kMaxSmem = 232448;

// Lets `kernel` take `bytes` of dynamic shared memory (past 48 KB a launch
// needs this attribute).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The card's view of `kernel` launched with `threads` threads and `smem`
// dynamic shared bytes per block, `scenarios` scenarios per block:
// out[0..5] = resident blocks per SM, threads per block, shared bytes per
// block (static and dynamic), scenarios per block, registers and local
// (spill) bytes per thread (ops/cuda/__init__.py OCCUPANCY_KEYS).  Returns
// 0 or the CUDA error.
template <class Kernel>
int kernel_occupancy(Kernel kernel, int threads, size_t smem, int scenarios,
                     int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = threads;
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[3] = scenarios;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace ipoc
