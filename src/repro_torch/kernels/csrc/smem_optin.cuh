// Opting a kernel in to more than 48 KB of dynamic shared memory, per device.
//
// cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, n)
// applies to the current device only, so the flag that remembers it is kept
// per device (cudaGetDevice): the first launch on every card opts in there,
// and a replica or a plan's core placed on a second card does not inherit the
// first card's opt-in.  A device index past SMEM_MAX_DEVICES sets the
// attribute on every launch.  Use with static storage only (zero-initialized).
#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int SMEM_MAX_DEVICES = 64;

struct SmemOptIn {
  std::atomic<bool> done[SMEM_MAX_DEVICES];
};

template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kern, int bytes, SmemOptIn& flags) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev >= 0 && dev < SMEM_MAX_DEVICES;
  if (tracked && flags.done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && tracked)
    flags.done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace
