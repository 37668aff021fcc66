// bucket_min: the minimum of counts[i] over the entries with alive[i]
// != 0, as int32; INT32_MAX when nothing is alive. int64 counts are
// clamped (not wrapped) to INT32_MAX before the reduction.
//
// Replaces the Pallas TPU kernel bucket_min.bucket_min_pallas
// (src/repro/kernels/bucket_min.py), which walks the array in 2048-wide
// tiles on the TPU's one core and carries a (1, 1) running minimum from
// grid step to grid step. Blocks on the H100 run in no order, so the
// carry becomes one atomicMin per block into an output the wrapper
// seeds with INT32_MAX.
//
// What bounds it on an H100: bytes. Each count (4 or 8 B) and each
// alive flag (1 B) is read once; the output is 4 B. The design is one
// grid-stride pass: every thread keeps its minimum in a register, the
// warp reduces with __reduce_min_sync, the block's warps meet in shared
// memory, and the block's first thread does the one atomicMin.
#include "common.cuh"

namespace {

template <typename T>
__global__ void bucket_min_kernel(const T* __restrict__ counts,
                                  const uint8_t* __restrict__ alive,
                                  long long n, int32_t* __restrict__ out) {
  __shared__ int32_t warp_min[bf::kThreads / 32];
  int32_t best = INT_MAX;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (alive[i]) best = min(best, bf::clamp_i32(counts[i]));
  }
  best = __reduce_min_sync(0xffffffffu, best);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < bf::kThreads / 32 ? warp_min[lane] : INT_MAX;
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0 && best != INT_MAX) atomicMin(out, best);
  }
}

}  // namespace

// out must hold INT32_MAX on entry (the wrapper seeds it).
BF_EXPORT int bf_bucket_min(const void* counts, int counts_is_64,
                            const uint8_t* alive, long long n, int32_t* out,
                            void* stream) {
  if (n > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned int grid = bf::grid_for(n);
    if (counts_is_64) {
      bucket_min_kernel<long long><<<grid, bf::kThreads, 0, s>>>(
          static_cast<const long long*>(counts), alive, n, out);
    } else {
      bucket_min_kernel<int32_t><<<grid, bf::kThreads, 0, s>>>(
          static_cast<const int32_t*>(counts), alive, n, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
