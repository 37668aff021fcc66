// wedge_histogram: counts[b] = number of entries with valid != 0 and
// key b; keys outside [0, num_buckets) are dropped.
//
// Replaces the Pallas TPU kernel wedge_count.wedge_histogram_pallas
// (src/repro/kernels/wedge_count.py), which builds a one-hot
// (keys x buckets) panel per grid step and contracts it on the MXU
// because the TPU has no fetch-and-add. Its work is O(keys x buckets),
// which is why it could never take the hash path's 2^28-slot table.
//
// What bounds it on an H100: bytes. Each key is read once (4 B key +
// 1 B valid) and each bucket written once (4 B); the adds themselves
// are global atomics that land in L2. The design is the direct one:
// one grid-stride pass, one atomicAdd per live key into a zeroed
// int32 table allocated by the wrapper. A table of 2^28 slots (1 GiB)
// is taken as it is; privatizing small tables in shared memory is
// later work.
#include "common.cuh"

namespace {

__global__ void wedge_histogram_kernel(const int32_t* __restrict__ keys,
                                       const uint8_t* __restrict__ valid,
                                       long long n, int32_t num_buckets,
                                       int32_t* __restrict__ counts) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int32_t k = keys[i];
    if (valid[i] && k >= 0 && k < num_buckets) atomicAdd(&counts[k], 1);
  }
}

}  // namespace

// counts must be zeroed by the caller.
BF_EXPORT int bf_wedge_histogram(const int32_t* keys, const uint8_t* valid,
                                 long long n, int num_buckets,
                                 int32_t* counts, void* stream) {
  if (n > 0) {
    wedge_histogram_kernel<<<bf::grid_for(n), bf::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        keys, valid, n, num_buckets, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

BF_EXPORT const char* bf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
