// bucket_update: one batched decrease-key of the peeling round loops.
//
//   new_counts = counts - scatter_add(idx, dec)   (entries of idx outside
//                                                   [0, n) are dropped)
//   out[0]     = min of new_counts over alive, int32, INT32_MAX if none
//                (int64 counts clamped to INT32_MAX, not wrapped)
//   out[1 + b] = number of alive entries with bit_length(max(v, 0)) == b,
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
// What bounds it on an H100: the launch. The work is tiny (the peeling
// path's counts are 45,000 int64 and its median batch about 32,000
// lanes: well under a megabyte), and the peeling loops call it once per
// tile, thousands of times a decomposition. So the whole call is one
// cooperative launch that seeds its own outputs, with no fill, memset or
// copy beside it on the stream. Its grid is sized from a per-device
// cached occupancy query so that every block is resident, and it runs
// three phases separated by grid-wide barriers:
//   1. copy counts -> new_counts (16-byte accesses where aligned); block
//      0 seeds out = [INT32_MAX, 0 x 32];
//   2. grid-stride atomicAdd(-dec) into new_counts;
//   3. one pass over new_counts that keeps the min in a register (warp
//      __reduce_min_sync, one atomicMin per block) and the 32 bins in
//      shared memory (at most 32 global adds per block).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 32;

__device__ __forceinline__ void add_to(int32_t* p, int32_t v) {
  atomicAdd(p, v);
}

__device__ __forceinline__ void add_to(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

// Grid-stride copy of nbytes (a multiple of 4) from src to dst: 16 bytes
// at a time when both are 16-byte aligned, the rest 4 bytes at a time.
__device__ __forceinline__ void copy_words(const void* __restrict__ src,
                                           void* __restrict__ dst,
                                           long long nbytes, long long tid,
                                           long long stride) {
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    const long long n16 = nbytes >> 4;
    const int4* s16 = static_cast<const int4*>(src);
    int4* d16 = static_cast<int4*>(dst);
    for (long long i = tid; i < n16; i += stride) d16[i] = s16[i];
    done = n16 << 2;
  }
  const int32_t* s4 = static_cast<const int32_t*>(src);
  int32_t* d4 = static_cast<int32_t*>(dst);
  for (long long i = done + tid; i < (nbytes >> 2); i += stride) d4[i] = s4[i];
}

template <typename T>
__global__ void __launch_bounds__(bf::kThreads)
    bucket_update_kernel(const T* __restrict__ counts,
                         const uint8_t* __restrict__ alive, long long n,
                         const long long* __restrict__ idx,
                         const T* __restrict__ dec, long long k,
                         T* __restrict__ new_counts,
                         int32_t* __restrict__ out) {
  __shared__ int32_t bins[kBins];
  __shared__ int32_t warp_min[bf::kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  // 1. copy, and seed the outputs
  copy_words(counts, new_counts, n * static_cast<long long>(sizeof(T)), tid,
             stride);
  if (blockIdx.x == 0 && threadIdx.x <= kBins) {
    out[threadIdx.x] = threadIdx.x == 0 ? INT_MAX : 0;
  }
  if (threadIdx.x < kBins) bins[threadIdx.x] = 0;
  grid.sync();

  // 2. scatter
  for (long long j = tid; j < k; j += stride) {
    const long long i = idx[j];
    const T d = dec[j];
    if (i >= 0 && i < n && d != 0) add_to(&new_counts[i], static_cast<T>(-d));
  }
  grid.sync();

  // 3. min and histogram of the updated counts (read from L2: other
  // blocks' atomics wrote them)
  int32_t best = INT_MAX;
  for (long long i = tid; i < n; i += stride) {
    if (alive[i]) {
      const int32_t v = bf::clamp_i32(__ldcg(&new_counts[i]));
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
    if (lane == 0 && best != INT_MAX) atomicMin(&out[0], best);
    const int32_t c = bins[lane];  // kBins == 32 == warp size
    if (c) atomicAdd(&out[1 + lane], c);
  }
}

template <typename T>
cudaError_t launch(const T* counts, const uint8_t* alive, long long n,
                   const long long* idx, const T* dec, long long k,
                   T* new_counts, int32_t* out, cudaStream_t s) {
  static std::atomic<int> resident[bf::kMaxDevices];
  const int per_sm = bf::cached_per_device(resident, [](int) {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bucket_update_kernel<T>, bf::kThreads, 0);
    return blocks;
  });
  if (per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
  const long long cap = static_cast<long long>(per_sm) * bf::sm_count();
  const long long work = n > k ? n : k;
  const unsigned int grid = static_cast<unsigned int>(
      std::max(1LL, std::min(cap, (work + bf::kThreads - 1) / bf::kThreads)));
  void* args[] = {&counts, &alive, &n, &idx, &dec, &k, &new_counts, &out};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&bucket_update_kernel<T>), dim3(grid),
      dim3(bf::kThreads), args, 0, s);
}

}  // namespace

// out is (33,) int32 and needs no seeding; dec has the counts' type.
BF_EXPORT int bf_bucket_update(const void* counts, int counts_is_64,
                               const uint8_t* alive, long long n,
                               const long long* idx, const void* dec,
                               long long k, void* new_counts, int32_t* out,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (counts_is_64) {
    e = launch<long long>(static_cast<const long long*>(counts), alive, n,
                          idx, static_cast<const long long*>(dec), k,
                          static_cast<long long*>(new_counts), out, s);
  } else {
    e = launch<int32_t>(static_cast<const int32_t*>(counts), alive, n, idx,
                        static_cast<const int32_t*>(dec), k,
                        static_cast<int32_t*>(new_counts), out, s);
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
