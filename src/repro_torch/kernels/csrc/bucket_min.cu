// bucket_min: the minimum of counts[i] over the entries with alive[i]
// != 0, as int32; INT32_MAX when nothing is alive. int64 counts are
// clamped (not wrapped) to INT32_MAX before the reduction.
//
// Replaces the Pallas TPU kernel bucket_min.bucket_min_pallas
// (src/repro/kernels/bucket_min.py), which walks the array in 2048-wide
// tiles on the TPU's one core and carries a (1, 1) running minimum from
// grid step to grid step. Blocks on the H100 run in no order, so the
// carry becomes a reduction across blocks.
//
// What bounds it on an H100: the launch. The peeling path's counts are
// 45,000 int64 (405 KB with the alive flags: 0.00012 ms at 3.35 TB/s),
// and the path calls it once per round, thousands of times a
// decomposition; one kernel on the card takes about a microsecond
// however little it reads. So a call is one device operation and
// nothing else: the kernel seeds its own output, with no fill or memset
// beside it on the stream.
//
//  * One wave: the grid is at most one block per SM (the cached SM
//    count), fewer when the array is small. Each thread reads 16-byte
//    words: 16 alive flags and the 16 counts beside them (two int64 or
//    four int32 per word), keeps its minimum in a register; the warp
//    reduces with __reduce_min_sync and the block's warps meet in
//    shared memory.
//  * Elements before the first 16-byte-aligned count and after the last
//    whole group of 16 are read one at a time (a view such as b[1:]
//    starts 8 bytes into a word). The flags are read as one 16-byte
//    word when they share the counts' alignment, else byte by byte.
//  * Each block writes its minimum to partials[blockIdx.x], fences, and
//    takes a ticket (atomicAdd on partials[capacity]). The block that
//    draws the last ticket reduces the partials, writes out, and resets
//    the ticket to 0 for the next call. The scratch is the wrapper's,
//    one per device and reused by every call: that is safe because the
//    port launches every kernel on the device's current stream, so two
//    calls never run at once; calls on two streams at once would race
//    on it.
#include "common.cuh"

namespace {

constexpr int kGroup = 16;  // elements per 16-byte word of alive flags

__device__ __forceinline__ int32_t block_min(int32_t best) {
  __shared__ int32_t warp_min[bf::kThreads / 32];
  best = __reduce_min_sync(0xffffffffu, best);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = best;
  __syncthreads();
  best = lane < bf::kThreads / 32 ? warp_min[lane] : INT_MAX;
  return __reduce_min_sync(0xffffffffu, best);  // in every lane of warp 0
}

template <typename T>
__global__ void __launch_bounds__(bf::kThreads)
    bucket_min_kernel(const T* __restrict__ counts,
                      const uint8_t* __restrict__ alive, long long n,
                      long long head, int32_t* __restrict__ partials,
                      int capacity, int32_t* __restrict__ out) {
  __shared__ bool last;
  constexpr int kPerWord = 16 / sizeof(T);  // counts per 16-byte word
  constexpr int kWords = kGroup / kPerWord;
  int32_t best = INT_MAX;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long groups = (n - head) / kGroup;
  const long long body_end = head + groups * kGroup;
  const bool flags16 =
      (reinterpret_cast<uintptr_t>(alive + head) & 15) == 0;
  for (long long gi = tid; gi < groups; gi += stride) {
    const long long i = head + gi * kGroup;
    union {
      int4 v;
      uint8_t b[kGroup];
    } f;
    if (flags16) {
      f.v = *reinterpret_cast<const int4*>(alive + i);
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) f.b[k] = alive[i + k];
    }
    const int4* c16 = reinterpret_cast<const int4*>(counts + i);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      union {
        int4 v;
        T c[kPerWord];
      } word;
      word.v = c16[w];
#pragma unroll
      for (int k = 0; k < kPerWord; ++k) {
        if (f.b[w * kPerWord + k]) best = min(best, bf::clamp_i32(word.c[k]));
      }
    }
  }
  // the scalar head [0, head) and tail [body_end, n)
  const long long rest = head + (n - body_end);
  for (long long r = tid; r < rest; r += stride) {
    const long long i = r < head ? r : body_end + (r - head);
    if (alive[i]) best = min(best, bf::clamp_i32(counts[i]));
  }

  best = block_min(best);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = best;
    __threadfence();
    const unsigned int ticket =
        atomicAdd(reinterpret_cast<unsigned int*>(&partials[capacity]), 1u);
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every other block's partial is written and fenced
  best = INT_MAX;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) {
    best = min(best, __ldcg(&partials[b]));
  }
  best = block_min(best);
  if (threadIdx.x == 0) {
    *out = best;
    partials[capacity] = 0;
  }
}

template <typename T>
cudaError_t launch(const T* counts, const uint8_t* alive, long long n,
                   int32_t* partials, int capacity, int32_t* out,
                   cudaStream_t s) {
  // elements before the first 16-byte-aligned count (a torch tensor's
  // data is always aligned to its element size)
  const long long head = std::min(
      n, static_cast<long long>(
             ((16 - (reinterpret_cast<uintptr_t>(counts) & 15)) & 15) /
             sizeof(T)));
  const long long groups = (n - head) / kGroup;
  const long long items = std::max(groups, n - groups * kGroup);
  const long long grid = std::max(
      1LL, std::min<long long>((items + bf::kThreads - 1) / bf::kThreads,
                               bf::sm_count()));
  if (grid > capacity) return cudaErrorInvalidValue;
  bucket_min_kernel<T><<<static_cast<unsigned int>(grid), bf::kThreads, 0,
                         s>>>(counts, alive, n, head, partials, capacity,
                              out);
  return cudaGetLastError();
}

}  // namespace

// out is one int32 and needs no seeding. partials holds capacity + 1
// int32 of per-device scratch whose last entry (the ticket) is 0 on
// entry and is left 0; capacity must be at least the SM count.
BF_EXPORT int bf_bucket_min(const void* counts, int counts_is_64,
                            const uint8_t* alive, long long n,
                            int32_t* partials, int capacity, int32_t* out,
                            void* stream) {
  if (n < 0 || capacity < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (counts_is_64) {
    e = launch(static_cast<const long long*>(counts), alive, n, partials,
               capacity, out, s);
  } else {
    e = launch(static_cast<const int32_t*>(counts), alive, n, partials,
               capacity, out, s);
  }
  return static_cast<int>(e);
}
