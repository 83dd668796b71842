// Shared-memory set-up for the kernels' launchers (included by
// construct_probes.cu).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

constexpr int kStaticSmem = 48 * 1024;  // above this only as dynamic smem

// Lets `kernel` launch with `smem` bytes of dynamic shared memory: a launch
// gets up to 48 KB without asking; more needs the function attribute.
template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= (size_t)kStaticSmem) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
