// bucket_update: one batched decrease-key of the peeling round loops.
//
//   new_counts = counts - scatter_add(idx, dec)   (entries of idx outside
//                                                   [0, n) are dropped)
//   min        = min of new_counts over alive, int32, INT32_MAX if none
//                (int64 counts clamped to INT32_MAX, not wrapped)
//   hist[b]    = number of alive entries with bit_length(max(v, 0)) == b,
//                b in [0, 32), v the clamped int32 count
//
// Replaces the Pallas TPU kernel bucket_update.bucket_update_pallas
// (src/repro/kernels/bucket_update.py). The TPU has no fetch-and-add, so
// that kernel builds one-hot (batch x 512) panels per tile and contracts
// them on the MXU over three 12-bit limbs of dec, which is exact only
// for batches of at most MAX_UPDATE_CAP = 4096 entries and int32 counts.
// Here the scatter is a global atomicAdd per batch entry, so any batch
// size and int64 counts are exact (two's-complement adds wrap exactly as
// the plain version's subtraction does).
//
// What bounds it on an H100: bytes. counts are read once and new_counts
// written once (the device-to-device copy), new_counts read once more by
// the fused pass, alive read once (1 B), the batch read once (8 B idx +
// 4 or 8 B dec). Design: a stream-ordered copy, then two launches on the
// caller's stream: (1) a grid-stride scatter of atomicAdd(-dec);
// (2) one grid-stride pass over the updated counts that keeps the min in
// a register (warp __reduce_min_sync, one atomicMin per block) and the
// 32-bin histogram in shared memory (added to global memory once per
// block).
#include "common.cuh"

namespace {

constexpr int kBins = 32;

__device__ __forceinline__ void add_to(int32_t* p, int32_t v) {
  atomicAdd(p, v);
}

__device__ __forceinline__ void add_to(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

template <typename T>
__global__ void scatter_dec_kernel(T* __restrict__ counts, long long n,
                                   const long long* __restrict__ idx,
                                   const T* __restrict__ dec, long long k) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < k; j += stride) {
    const long long i = idx[j];
    const T d = dec[j];
    if (i >= 0 && i < n && d != 0) add_to(&counts[i], static_cast<T>(-d));
  }
}

template <typename T>
__global__ void min_hist_kernel(const T* __restrict__ counts,
                                const uint8_t* __restrict__ alive,
                                long long n, int32_t* __restrict__ mn,
                                int32_t* __restrict__ hist) {
  __shared__ int32_t bins[kBins];
  __shared__ int32_t warp_min[bf::kThreads / 32];
  if (threadIdx.x < kBins) bins[threadIdx.x] = 0;
  __syncthreads();
  int32_t best = INT_MAX;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (alive[i]) {
      const int32_t v = bf::clamp_i32(counts[i]);
      best = min(best, v);
      atomicAdd(&bins[32 - __clz(max(v, 0))], 1);
    }
  }
  best = __reduce_min_sync(0xffffffffu, best);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < bf::kThreads / 32 ? warp_min[lane] : INT_MAX;
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0 && best != INT_MAX) atomicMin(mn, best);
    const int32_t c = bins[lane];  // kBins == 32 == warp size
    if (c) atomicAdd(&hist[lane], c);
  }
}

template <typename T>
cudaError_t launch(const T* counts, const uint8_t* alive, long long n,
                   const long long* idx, const T* dec, long long k,
                   T* new_counts, int32_t* mn, int32_t* hist,
                   cudaStream_t s) {
  if (n > 0) {
    const cudaError_t e = cudaMemcpyAsync(new_counts, counts, n * sizeof(T),
                                          cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return e;
  }
  if (k > 0 && n > 0) {
    scatter_dec_kernel<T><<<bf::grid_for(k), bf::kThreads, 0, s>>>(
        new_counts, n, idx, dec, k);
  }
  if (n > 0) {
    min_hist_kernel<T><<<bf::grid_for(n), bf::kThreads, 0, s>>>(
        new_counts, alive, n, mn, hist);
  }
  return cudaGetLastError();
}

}  // namespace

// mn must hold INT32_MAX and hist zeros on entry (the wrapper seeds
// them); dec has the counts' type.
BF_EXPORT int bf_bucket_update(const void* counts, int counts_is_64,
                               const uint8_t* alive, long long n,
                               const long long* idx, const void* dec,
                               long long k, void* new_counts, int32_t* mn,
                               int32_t* hist, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (counts_is_64) {
    e = launch<long long>(static_cast<const long long*>(counts), alive, n,
                          idx, static_cast<const long long*>(dec), k,
                          static_cast<long long*>(new_counts), mn, hist, s);
  } else {
    e = launch<int32_t>(static_cast<const int32_t*>(counts), alive, n, idx,
                        static_cast<const int32_t*>(dec), k,
                        static_cast<int32_t*>(new_counts), mn, hist, s);
  }
  return static_cast<int>(e);
}
