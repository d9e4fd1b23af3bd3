// The dynamic shared-memory opt-in of a kernel, once per device.
//
// cudaFuncSetAttribute binds to the calling thread's current device, and one
// process may launch on several cards (a serving engine over a device group
// runs each shard on its own card), so the attribute is set the first time a
// kernel launches on each device. Two threads racing on one device both set
// it, which is harmless; the bit is recorded only once it succeeded.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace {

template <auto Kernel>
cudaError_t smem_opt_in(int bytes) {
  static std::atomic<unsigned long long> done{0};  // bit d: device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

}  // namespace
