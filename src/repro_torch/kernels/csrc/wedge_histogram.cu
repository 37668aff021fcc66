// wedge_histogram: counts[b] = number of entries with valid != 0 and
// key b, for int32 or int64 keys; keys outside [0, num_buckets) are
// dropped (an int64 key is never narrowed first).
//
// Replaces the Pallas TPU kernel wedge_count.wedge_histogram_pallas
// (src/repro/kernels/wedge_count.py), which builds a one-hot
// (keys x buckets) panel per grid step and contracts it on the MXU
// because the TPU has no fetch-and-add. Its work is O(keys x buckets),
// which is why it could never take the hash path's 2^28-slot table.
//
// What bounds it on an H100: bytes. Each key is read once (4 or 8 B key
// + 1 B valid) and each bucket written once (4 B). A global atomicAdd
// per key into a table far larger than the 50 MB L2, or any store of a
// few bytes to a random address in a buffer much larger than L2, costs
// a read-modify-write of a 32-byte sector in HBM per key. So the adds
// go to shared memory, and every store to device memory lands in one
// of a few tens of thousands of sequential runs, which L2 merges into
// whole sectors. With S = 2^part_bits int32 bins of shared memory:
//
//   num_buckets <= S: one launch of one block per SM, each with a
//   private table; the flush adds each block's nonzero bins to the
//   output (zeroed by the wrapper) with one global atomic each.
//
//   num_buckets > S: the table splits into P = ceil(num_buckets / S)
//   partitions of S buckets, grouped into C <= 512 coarse partitions of
//   F = 2^coarse_bits <= 512 partitions each (F = 1 is allowed), and the
//   keys are bucketed as in a two-digit radix sort:
//     1. count: each of `blocks` blocks counts its contiguous chunk of
//        keys per coarse partition in shared memory and writes its row
//        of a (blocks x C) int64 matrix (no global atomics);
//     2. prefix: per coarse partition, an exclusive prefix down the
//        matrix's column, leaving the column's total;
//     3. scan: one block turns the totals into segment starts;
//     4. scatter: each block re-reads its chunk and writes each 4-byte
//        key into its coarse segment, at the block's own offset there
//        plus a shared-memory cursor;
//     5. fine: one block per coarse segment counts its keys per
//        partition, scans the F counts into partition starts, and writes
//        each key's 2-byte in-partition offset (key % S) into its
//        partition's segment;
//     6. bins: one block per partition zeroes S bins in shared memory,
//        adds its segment's offsets with shared-memory atomics, and
//        writes all its bins with 16-byte stores. Every output word is
//        written exactly once, so the output needs no zeroing.
#include "common.cuh"

namespace {

constexpr int kBlock = 1024;      // threads of every histogram block
constexpr int kUnroll = 4;        // keys in flight per thread
constexpr int kDigitBits = 9;
constexpr int kDigits = 1 << kDigitBits;  // C and F, at most
constexpr int kItems = 8;         // keys per thread in a scatter tile
constexpr int kTile = kBlock * kItems;
constexpr int kMaxPartBits = 15;  // S <= 2^15 int32 bins: 128 KiB
constexpr int kMaxSmem = static_cast<int>(sizeof(int32_t)) << kMaxPartBits;

__device__ __forceinline__ long long chunk_begin(long long n, int block) {
  const long long chunk = (n + gridDim.x - 1) / gridDim.x;
  const long long b = chunk * block;
  return b < n ? b : n;
}

// Calls f(key) for each live in-range key of [begin, end) that this
// thread owns (stride blockDim.x), with kUnroll keys in flight.
template <typename K, typename F>
__device__ __forceinline__ void for_live(const K* __restrict__ keys,
                                         const uint8_t* __restrict__ valid,
                                         long long begin, long long end,
                                         long long num_buckets, F f) {
  const long long step = static_cast<long long>(blockDim.x) * kUnroll;
  for (long long base = begin + threadIdx.x; base < end; base += step) {
    K k[kUnroll];
    uint8_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * blockDim.x;
      k[u] = i < end ? keys[i] : K(0);
      v[u] = i < end ? valid[i] : uint8_t(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long key = static_cast<long long>(k[u]);
      if (v[u] && key >= 0 && key < num_buckets) f(static_cast<uint32_t>(key));
    }
  }
}

// Calls f(value) for each entry of [begin, end) of a scratch array that
// this thread owns (stride blockDim.x), with kUnroll entries in flight.
template <typename T, typename F>
__device__ __forceinline__ void for_each_entry(const T* __restrict__ a,
                                         long long begin, long long end,
                                         F f) {
  const long long step = static_cast<long long>(blockDim.x) * kUnroll;
  for (long long base = begin + threadIdx.x; base < end; base += step) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * blockDim.x;
      v[u] = i < end ? a[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + static_cast<long long>(u) * blockDim.x < end) f(v[u]);
    }
  }
}

// Exclusive prefix of one value per thread across the block (every
// thread calls it); `total` gets the block's sum. Callers put a
// __syncthreads() between two calls.
__device__ long long block_exclusive_scan(long long own, long long* total) {
  __shared__ long long warp_sum[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = own;  // inclusive scan across the warp
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  *total = warp_sum[31];
  return x - own + (warp ? warp_sum[warp - 1] : 0);
}

template <typename K>
__global__ void __launch_bounds__(kBlock)
    wedge_histogram_shared(const K* __restrict__ keys,
                           const uint8_t* __restrict__ valid, long long n,
                           int num_buckets, int32_t* __restrict__ counts) {
  extern __shared__ int32_t bins[];
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  for_live(keys, valid, chunk_begin(n, blockIdx.x),
           chunk_begin(n, blockIdx.x + 1), num_buckets,
           [&](uint32_t k) { atomicAdd(&bins[k], 1); });
  __syncthreads();
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) {
    const int32_t c = bins[b];
    if (c) atomicAdd(&counts[b], c);
  }
}

// Step 1: block_part[block][c] = live keys of coarse partition c in this
// block's chunk.
template <typename K>
__global__ void __launch_bounds__(kBlock)
    wedge_histogram_count(const K* __restrict__ keys,
                          const uint8_t* __restrict__ valid, long long n,
                          int num_buckets, int coarse_shift, int coarse,
                          long long* __restrict__ block_part) {
  __shared__ int32_t cnt[kDigits];
  for (int c = threadIdx.x; c < coarse; c += blockDim.x) cnt[c] = 0;
  __syncthreads();
  for_live(keys, valid, chunk_begin(n, blockIdx.x),
           chunk_begin(n, blockIdx.x + 1), num_buckets,
           [&](uint32_t k) { atomicAdd(&cnt[k >> coarse_shift], 1); });
  __syncthreads();
  long long* row = block_part + static_cast<long long>(blockIdx.x) * coarse;
  for (int c = threadIdx.x; c < coarse; c += blockDim.x) row[c] = cnt[c];
}

// Step 2: one thread per coarse partition walks down its column of the
// matrix, replacing each count by the column's exclusive prefix, and
// leaves the column's total in starts[c].
__global__ void wedge_histogram_prefix(long long* __restrict__ block_part,
                                       int blocks, int coarse,
                                       long long* __restrict__ starts) {
  constexpr int kBatch = 16;  // loads in flight per thread
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= coarse) return;
  long long* col = block_part + c;
  long long run = 0;
  for (int b0 = 0; b0 < blocks; b0 += kBatch) {
    long long v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      v[u] = b0 + u < blocks ? col[static_cast<long long>(b0 + u) * coarse] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b0 + u < blocks) {
        col[static_cast<long long>(b0 + u) * coarse] = run;
        run += v[u];
      }
    }
  }
  starts[c] = run;
}

// Step 3, one block: starts[0, coarse) becomes its exclusive scan in
// place, and starts[coarse] the total.
__global__ void __launch_bounds__(kBlock)
    wedge_histogram_scan(long long* __restrict__ starts, int coarse) {
  const long long own = threadIdx.x < coarse ? starts[threadIdx.x] : 0;
  long long total;
  const long long excl = block_exclusive_scan(own, &total);
  if (threadIdx.x < coarse) starts[threadIdx.x] = excl;
  if (threadIdx.x == 0) starts[coarse] = total;
}

// A scatter tile in shared memory: up to kTile 32-bit values are ranked
// by digit, laid out digit by digit, and written out so that the values
// of one digit go to consecutive addresses (coalesced stores, whole
// sectors) instead of one store request per value.
struct Tile {
  uint32_t stage[kTile];
  int32_t count[kDigits];   // values of each digit in this tile
  int32_t first[kDigits];   // where each digit's values start in stage
  long long next[kDigits];  // output position of each digit's next value
};

// Writes this tile's values v[u] of digit d[u] (d < 0: none) to
// out[next[d] + rank] as put(x) and advances next[d]; digit_of(x)
// recovers a value's digit. Every thread of the block calls it, with
// count[] zero on entry (and left so).
template <typename Out, typename Digit, typename Put>
__device__ __forceinline__ void scatter_tile(Tile& t,
                                             const uint32_t (&v)[kItems],
                                             const int (&d)[kItems],
                                             int digits,
                                             Out* __restrict__ out,
                                             Digit digit_of, Put put) {
  int rank[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    rank[u] = d[u] >= 0 ? atomicAdd(&t.count[d[u]], 1) : 0;
  }
  __syncthreads();
  long long live;
  const long long first = block_exclusive_scan(
      threadIdx.x < digits ? t.count[threadIdx.x] : 0, &live);
  if (threadIdx.x < digits) t.first[threadIdx.x] = static_cast<int32_t>(first);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    if (d[u] >= 0) t.stage[t.first[d[u]] + rank[u]] = v[u];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < live; j += blockDim.x) {
    const uint32_t x = t.stage[j];
    const int dj = digit_of(x);
    out[t.next[dj] + (j - t.first[dj])] = put(x);
  }
  __syncthreads();
  if (threadIdx.x < digits) {
    t.next[threadIdx.x] += t.count[threadIdx.x];
    t.count[threadIdx.x] = 0;
  }
  __syncthreads();
}

// Step 4: each live key into its coarse segment (step 5 splits it).
template <typename K>
__global__ void __launch_bounds__(kBlock)
    wedge_histogram_scatter(const K* __restrict__ keys,
                            const uint8_t* __restrict__ valid, long long n,
                            int num_buckets, int coarse_shift, int coarse,
                            const long long* __restrict__ block_part,
                            const long long* __restrict__ starts,
                            uint32_t* __restrict__ wide) {
  __shared__ Tile t;
  const long long* row =
      block_part + static_cast<long long>(blockIdx.x) * coarse;
  for (int c = threadIdx.x; c < coarse; c += blockDim.x) {
    t.next[c] = starts[c] + row[c];
    t.count[c] = 0;
  }
  __syncthreads();
  const auto digit_of = [&](uint32_t x) { return static_cast<int>(x >> coarse_shift); };
  const long long end = chunk_begin(n, blockIdx.x + 1);
  for (long long t0 = chunk_begin(n, blockIdx.x); t0 < end; t0 += kTile) {
    uint32_t v[kItems];
    int d[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const long long i = t0 + u * kBlock + threadIdx.x;
      const long long key = i < end ? static_cast<long long>(keys[i]) : -1;
      const bool live = i < end && valid[i] && key >= 0 && key < num_buckets;
      v[u] = static_cast<uint32_t>(key);
      d[u] = live ? digit_of(v[u]) : -1;
    }
    scatter_tile(t, v, d, coarse, wide, digit_of,
                 [](uint32_t x) { return x; });
  }
}

// Step 5: block c splits coarse segment c into its F = 2^coarse_bits
// partitions p = c * F + f, writing fine_starts[p] (and, in the last
// block, fine_starts[parts] = the total).
__global__ void __launch_bounds__(kBlock)
    wedge_histogram_fine(const uint32_t* __restrict__ wide,
                         const long long* __restrict__ starts, int part_bits,
                         int coarse_bits, int parts, int coarse,
                         long long* __restrict__ fine_starts,
                         uint16_t* __restrict__ slots) {
  __shared__ Tile t;
  const int F = 1 << coarse_bits;
  const uint32_t fine = F - 1;
  const uint32_t in_part = (1u << part_bits) - 1;
  const auto digit_of = [&](uint32_t x) {
    return static_cast<int>((x >> part_bits) & fine);
  };
  const long long lo = starts[blockIdx.x];
  const long long hi = starts[blockIdx.x + 1];
  for (int f = threadIdx.x; f < F; f += blockDim.x) t.count[f] = 0;
  __syncthreads();
  for_each_entry(wide, lo, hi,
                 [&](uint32_t k) { atomicAdd(&t.count[digit_of(k)], 1); });
  __syncthreads();
  long long total;
  const long long excl = block_exclusive_scan(
      threadIdx.x < F ? t.count[threadIdx.x] : 0, &total);
  if (threadIdx.x < F) {
    t.next[threadIdx.x] = lo + excl;
    t.count[threadIdx.x] = 0;
    const int p = blockIdx.x * F + threadIdx.x;
    if (p < parts) fine_starts[p] = lo + excl;
  }
  if (blockIdx.x == coarse - 1 && threadIdx.x == 0) fine_starts[parts] = hi;
  __syncthreads();
  for (long long t0 = lo; t0 < hi; t0 += kTile) {
    uint32_t v[kItems];
    int d[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const long long i = t0 + u * kBlock + threadIdx.x;
      v[u] = i < hi ? wide[i] : 0u;
      d[u] = i < hi ? digit_of(v[u]) : -1;
    }
    scatter_tile(t, v, d, F, slots, digit_of, [&](uint32_t x) {
      return static_cast<uint16_t>(x & in_part);
    });
  }
}

// Step 6: block p owns buckets [p * S, min((p + 1) * S, num_buckets)).
__global__ void __launch_bounds__(kBlock)
    wedge_histogram_bins(const uint16_t* __restrict__ slots,
                         const long long* __restrict__ starts, int part_bits,
                         int num_buckets, int32_t* __restrict__ counts) {
  extern __shared__ int4 bins4[];
  int32_t* bins = reinterpret_cast<int32_t*>(bins4);
  const int S = 1 << part_bits;
  for (int i = threadIdx.x; i < S / 4; i += blockDim.x) {
    bins4[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  for_each_entry(slots, starts[blockIdx.x], starts[blockIdx.x + 1],
           [&](uint16_t s) { atomicAdd(&bins[s], 1); });
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) << part_bits;
  const long long left = num_buckets - first;
  const int width = left < S ? static_cast<int>(left) : S;
  int32_t* out = counts + first;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    done = width & ~3;
    for (int i = threadIdx.x; i < done / 4; i += blockDim.x) {
      reinterpret_cast<int4*>(out)[i] = bins4[i];
    }
  }
  for (int i = done + threadIdx.x; i < width; i += blockDim.x) out[i] = bins[i];
}

// Lets the two kernels with a table in shared memory take up to
// kMaxSmem of it, once per device.
template <typename K>
cudaError_t allow_smem() {
  static std::atomic<int> done[bf::kMaxDevices];
  const int ok = bf::cached_per_device(done, [](int) {
    const void* fns[] = {
        reinterpret_cast<const void*>(&wedge_histogram_shared<K>),
        reinterpret_cast<const void*>(&wedge_histogram_bins),
    };
    for (const void* f : fns) {
      if (cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem) != cudaSuccess) {
        return 0;
      }
    }
    return 1;
  });
  return ok ? cudaSuccess : cudaGetLastError();
}

template <typename K>
cudaError_t histogram(const K* keys, const uint8_t* valid, long long n,
                      int num_buckets, int part_bits, int coarse_bits,
                      int blocks, long long* offsets, uint32_t* wide,
                      uint16_t* slots, int32_t* counts, cudaStream_t s) {
  cudaError_t e = allow_smem<K>();
  if (e != cudaSuccess) return e;
  const int S = 1 << part_bits;
  if (num_buckets <= S) {
    wedge_histogram_shared<K><<<bf::sm_count(), kBlock,
                                num_buckets * sizeof(int32_t), s>>>(
        keys, valid, n, num_buckets, counts);
    return cudaGetLastError();
  }
  const long long nb = num_buckets;
  const int parts = static_cast<int>((nb + S - 1) >> part_bits);
  const int coarse_shift = part_bits + coarse_bits;
  const int coarse = static_cast<int>(
      (nb + (1LL << coarse_shift) - 1) >> coarse_shift);
  long long* block_part = offsets;
  long long* starts = block_part + static_cast<long long>(blocks) * coarse;
  long long* fine_starts = starts + coarse + 1;
  wedge_histogram_count<K><<<blocks, kBlock, 0, s>>>(
      keys, valid, n, num_buckets, coarse_shift, coarse, block_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wedge_histogram_prefix<<<(coarse + bf::kThreads - 1) / bf::kThreads,
                           bf::kThreads, 0, s>>>(block_part, blocks, coarse,
                                                 starts);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wedge_histogram_scan<<<1, kBlock, 0, s>>>(starts, coarse);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wedge_histogram_scatter<K><<<blocks, kBlock, 0, s>>>(
      keys, valid, n, num_buckets, coarse_shift, coarse, block_part, starts,
      wide);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wedge_histogram_fine<<<coarse, kBlock, 0, s>>>(
      wide, starts, part_bits, coarse_bits, parts, coarse, fine_starts,
      slots);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wedge_histogram_bins<<<parts, kBlock, S * sizeof(int32_t), s>>>(
      slots, fine_starts, part_bits, num_buckets, counts);
  return cudaGetLastError();
}

}  // namespace

// The wrapper's plan (kernels/cuda.py:histogram_plan) sizes the scratch.
// For num_buckets <= 2^part_bits no scratch is read and counts must be
// zeroed. Above it, counts need no zeroing; offsets holds blocks * C +
// C + 1 + P + 1 int64, slots one uint16 and wide one uint32 per key.
// Arguments outside the shared-memory tables' limits (part_bits in
// [2, 15], C = ceil(num_buckets / 2^(part_bits + coarse_bits)) and
// 2^coarse_bits at most 512, blocks >= 1) return cudaErrorInvalidValue.
BF_EXPORT int bf_wedge_histogram(const void* keys, int keys_is_64,
                                 const uint8_t* valid, long long n,
                                 int num_buckets, int part_bits,
                                 int coarse_bits, int blocks,
                                 long long* offsets, uint32_t* wide,
                                 uint16_t* slots, int32_t* counts,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n < 0 || num_buckets < 1 || part_bits < 2 ||
      part_bits > kMaxPartBits || coarse_bits < 0 ||
      coarse_bits > kDigitBits || blocks < 1 ||
      ((static_cast<long long>(num_buckets) - 1) >>
       (part_bits + coarse_bits)) >= kDigits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e;
  if (keys_is_64) {
    e = histogram(static_cast<const long long*>(keys), valid, n, num_buckets,
                  part_bits, coarse_bits, blocks, offsets, wide, slots,
                  counts, s);
  } else {
    e = histogram(static_cast<const int32_t*>(keys), valid, n, num_buckets,
                  part_bits, coarse_bits, blocks, offsets, wide, slots,
                  counts, s);
  }
  return static_cast<int>(e);
}

BF_EXPORT const char* bf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
