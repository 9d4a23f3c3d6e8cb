// Host-side launch helpers shared by the kernels' C entries (nvcc only; the
// g++ twin does not include this header).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace ctt {

// Raise Kernel's dynamic shared memory limit to `bytes` (above the default
// 48 KB) on the current device, the first time this is called there: each
// kernel keeps its own mask of the devices already raised (one bit a
// device ordinal).
template <auto Kernel>
cudaError_t raise_smem_once(int bytes) {
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || ((raised.load() >> dev) & 1u)) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised |= uint64_t(1) << dev;
  return err;
}

}  // namespace ctt
