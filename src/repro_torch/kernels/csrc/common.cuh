// Shared helpers of the port's kernels (CUDA C++, sm_90a).
//
// Every kernel launches on the caller's stream, allocates nothing (the
// Python wrapper allocates outputs and scratch with torch), and every
// exported entry point returns cudaGetLastError() after its launches so
// the wrapper raises on a launch that was refused.
#pragma once

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define BF_EXPORT extern "C" __attribute__((visibility("default")))

namespace bf {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// A per-device value computed once: the first call on a device runs
// `query(device)`, later calls read the cache. An attribute or
// occupancy query is a round trip into the CUDA runtime, which the
// peeling loops would otherwise pay on every launch.
template <typename Query>
inline int cached_per_device(std::atomic<int> (&cache)[kMaxDevices],
                             Query query) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return query(dev);
  int v = cache[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    v = query(dev);
    cache[dev].store(v, std::memory_order_relaxed);
  }
  return v;
}

// Streaming multiprocessors of the current device (0, not cached, if the
// query failed; its error is what the entry point then returns).
inline int sm_count() {
  static std::atomic<int> cache[kMaxDevices];
  return cached_per_device(cache, [](int dev) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  });
}

// Blocks for a grid-stride loop over n items: at most 8 resident blocks
// of 256 threads per SM (2048 threads, the SM's limit), never more
// blocks than the items need.
inline unsigned int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

// A count as int32, wider values clamped (not wrapped) to INT32_MAX: the
// peeling kernels' contract for int64 counts.
template <typename T>
__device__ __forceinline__ int32_t clamp_i32(T v) {
  if constexpr (sizeof(T) > 4) {
    if (v > static_cast<T>(INT_MAX)) v = static_cast<T>(INT_MAX);
  }
  return static_cast<int32_t>(v);
}

}  // namespace bf
