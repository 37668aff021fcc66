// Shared helpers of the port's counting kernels (CUDA C++, sm_90a).
//
// Every kernel launches on the caller's stream, allocates nothing (the
// Python wrapper allocates outputs and scratch with torch), and every
// exported entry point returns cudaGetLastError() after its launches so
// the wrapper raises on a launch that was refused.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define BF_EXPORT extern "C" __attribute__((visibility("default")))

namespace bf {

constexpr int kThreads = 256;

// Blocks for a grid-stride loop over n items: at most 8 resident blocks
// of 256 threads per SM (2048 threads, the SM's limit), never more
// blocks than the items need.
static inline unsigned int grid_for(long long n) {
  int dev = 0;
  int sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

}  // namespace bf
