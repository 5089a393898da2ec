// Shared by every kernel library in this directory: each .cu builds into
// its own shared library, so each gets one copy of these definitions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#define CILIUM_EXPORT extern "C" __attribute__((visibility("default")))

CILIUM_EXPORT const char* cilium_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

// The blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that the current card holds at once (its SMs times the blocks an SM
// holds), with the kernel opted into `smem`.  Cached per (kernel, card,
// threads, smem): the queries cost microseconds, a launch's whole budget.
template <typename Kernel>
static cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, size_t>, int> memo;
  static std::map<std::pair<const void*, int>, size_t> opted;  // largest smem allowed
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const auto key = std::make_tuple(fn, dev, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = memo.find(key);
  if (hit != memo.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  size_t& most = opted[{fn, dev}];
  if (smem > most) {  // never lowered: a cached smaller launch stays allowed
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    most = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = memo[key] = sms * per_sm;
  return cudaSuccess;
}
