// fused_count_tiles: zero-materialization butterfly counting over
// vertex-aligned tiles of the flat wedge space.
//
// Replaces the Pallas TPU kernel wedge_fused.fused_count_tiles_pallas
// (src/repro/kernels/wedge_fused.py). Per tile of flat wedge ids it
// rebuilds every wedge (upper bound on the wedge prefix w_off, CSR
// gathers; direction low or high), groups the tile's wedges by their
// endpoint pair (x1, x2) into multiplicities d, adds C(d, 2) once per
// group to x1, x2 and the total, and d - 1 per wedge to the center y
// and to both undirected wedge edges. The global wedge array never
// exists in device memory.
//
// The TPU kernel grouped by an all-pairs key match on the MXU and
// scattered through one-hot panels, which kept every f32 contraction
// exact only up to 4096 wedges per tile, and it carried int32 limb
// pairs across a grid that runs in order. None of that is needed here:
//
//  * Grouping is an open-addressing hash table in global scratch, keyed
//    by the 64-bit x1 << 32 | x2, with 2 x tile-wedges slots (load factor
//    <= 1/2, linear probing). atomicCAS claims a key's slot, atomicAdd
//    counts it; the thread whose CAS claimed the slot is the group's
//    representative. The tile cap is set by this scratch (see
//    MAX_TILE_CAP in kernels/cuda.py), not by float exactness.
//  * Blocks run in no order, so the TPU's in-order accumulation becomes
//    int64 atomic adds into outputs the wrapper zeroed.
//  * A plan at the auto budget has only a handful of tiles of up to 2^24
//    wedges, so one block per tile would leave most of the 132 SMs idle.
//    Instead every pass spreads one batch of tiles over the whole grid,
//    one wedge per thread: (1) recover and insert, (2) look up d and add
//    the contributions, (3) clear the slots the batch used, so the table
//    is empty again for the next batch without a full memset. Groups
//    never span tiles (the vertex-aligned invariant), so adjacent tiles
//    share one pass while their wedges fit the table, and per-batch
//    results add.
//
// What bounds it on an H100: memory traffic. The inputs and outputs are
// read and written once at the least (the CSR, w_off, the per-vertex
// and per-edge outputs); the real cost is random: a binary search of
// w_off per wedge per pass, a handful of CSR gathers, and one hash
// probe plus up to five atomics per wedge, all of which land in L2 or
// DRAM. Adds of zero (d == 1) are skipped, which removes most atomics
// on sparse graphs. Shared-memory hashing and a sort-based grouping are
// later work.
#include "common.cuh"

namespace {

constexpr unsigned long long kEmpty = ~0ULL;

struct Wedge {
  long long e;    // directed slot of the iterating edge
  long long pos;  // slot of the second edge (y -> other endpoint)
  int32_t x1;
  int32_t x2;
  int32_t y;
};

__device__ __forceinline__ long long upper_bound(const long long* a,
                                                 long long n, long long x) {
  long long lo = 0;
  long long hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The reference's wedges_at recovery for one flat wedge id, with its
// clamps (zero-wedge slots are skipped by the upper bound; y is clamped
// below the n_pad sentinel before it indexes offsets).
__device__ __forceinline__ Wedge recover(long long wid,
                                         const long long* __restrict__ w_off,
                                         long long e_pad,
                                         const int32_t* __restrict__ off,
                                         const int32_t* __restrict__ nbr,
                                         const int32_t* __restrict__ src,
                                         int n_pad, int high) {
  Wedge w;
  long long e = upper_bound(w_off, e_pad + 1, wid) - 1;
  e = e < 0 ? 0 : (e > e_pad - 1 ? e_pad - 1 : e);
  const long long j = wid - w_off[e];
  const long long cnt = w_off[e + 1] - w_off[e];
  const int32_t y = nbr[e];
  const int32_t ys = y < n_pad - 1 ? y : n_pad - 1;
  long long pos = high ? static_cast<long long>(off[ys]) + j
                       : static_cast<long long>(off[ys + 1]) - cnt + j;
  pos = pos < 0 ? 0 : (pos > e_pad - 1 ? e_pad - 1 : pos);
  if (high) {
    w.x2 = src[e];
    w.x1 = nbr[pos];
  } else {
    w.x1 = src[e];
    w.x2 = nbr[pos];
  }
  w.e = e;
  w.pos = pos;
  w.y = y;
  return w;
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

struct Graph {
  const int32_t* off;
  const int32_t* nbr;
  const int32_t* src;
  const int32_t* uid;
  const long long* w_off;
  long long e_pad;
  int n_pad;
  int high;
};

// Pass 1: recover each wedge of [ws, ws + nw) and insert its key.
// slot_of[t] = slot | (1 << 31 if this wedge claimed the slot). A probe
// that walks the whole table (impossible at load factor <= 1/2 unless
// the caller broke the sizing contract) sets *overflow and stops.
__global__ void insert_kernel(Graph g, long long ws, long long nw,
                              unsigned long long* __restrict__ keys,
                              uint32_t* __restrict__ counts,
                              unsigned long long mask,
                              uint32_t* __restrict__ slot_of,
                              int* __restrict__ overflow) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < nw; t += stride) {
    const Wedge w =
        recover(ws + t, g.w_off, g.e_pad, g.off, g.nbr, g.src, g.n_pad,
                g.high);
    const unsigned long long key =
        (static_cast<unsigned long long>(static_cast<uint32_t>(w.x1)) << 32) |
        static_cast<uint32_t>(w.x2);
    unsigned long long h = mix64(key) & mask;
    uint32_t rep = 0;
    bool found = false;
    for (unsigned long long probe = 0; probe <= mask; ++probe) {
      unsigned long long cur = __ldcg(&keys[h]);
      if (cur == kEmpty) {
        cur = atomicCAS(&keys[h], kEmpty, key);
        if (cur == kEmpty) rep = 1;
      }
      if (rep || cur == key) {
        found = true;
        break;
      }
      h = (h + 1) & mask;
    }
    if (!found) {
      atomicExch(overflow, 1);
      slot_of[t] = 0;
      continue;
    }
    atomicAdd(&counts[h], 1u);
    slot_of[t] = static_cast<uint32_t>(h) | (rep << 31);
  }
}

__device__ __forceinline__ unsigned long long block_sum(unsigned long long v) {
  __shared__ unsigned long long warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // the block's sum, in thread 0
}

// Pass 2: read each wedge's group multiplicity d and add its
// contributions (Lemma 4.2).
__global__ void apply_kernel(Graph g, long long ws, long long nw,
                             const uint32_t* __restrict__ counts,
                             const uint32_t* __restrict__ slot_of,
                             int do_global, int do_vertex, int do_edge,
                             unsigned long long* __restrict__ total,
                             unsigned long long* __restrict__ vertex,
                             unsigned long long* __restrict__ edge) {
  unsigned long long local = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < nw; t += stride) {
    const uint32_t s = slot_of[t];
    const unsigned long long d = counts[s & 0x7fffffffu];
    const Wedge w =
        recover(ws + t, g.w_off, g.e_pad, g.off, g.nbr, g.src, g.n_pad,
                g.high);
    const unsigned long long dm1 = d - 1;
    if (dm1 != 0) {
      if (do_vertex) atomicAdd(&vertex[w.y], dm1);
      if (do_edge) {
        atomicAdd(&edge[g.uid[w.e]], dm1);
        atomicAdd(&edge[g.uid[w.pos]], dm1);
      }
    }
    if (s >> 31) {
      const unsigned long long c2 = d * dm1 / 2;
      if (c2 != 0) {
        if (do_vertex) {
          atomicAdd(&vertex[w.x1], c2);
          atomicAdd(&vertex[w.x2], c2);
        }
        local += c2;
      }
    }
  }
  if (do_global) {
    const unsigned long long sum = block_sum(local);
    if (threadIdx.x == 0 && sum != 0) atomicAdd(total, sum);
  }
}

// Pass 3: empty the slots this batch claimed.
__global__ void clear_kernel(long long nw,
                             const uint32_t* __restrict__ slot_of,
                             unsigned long long* __restrict__ keys,
                             uint32_t* __restrict__ counts) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < nw; t += stride) {
    const uint32_t s = slot_of[t];
    if (s >> 31) {
      const uint32_t h = s & 0x7fffffffu;
      keys[h] = kEmpty;
      counts[h] = 0;
    }
  }
}

}  // namespace

// batches: host memory, (n_batches, 2) flat wedge ranges [ws, we); each
// range holds whole vertex-aligned tiles and at most table_slots / 2
// wedges, and slot_of holds at least that many entries. table_keys must
// be all-ones (empty) and table_counts zero on entry; both are left so.
// total (1,), vertex (n_pad,) and edge (m,) are zeroed int64 outputs;
// overflow is a zeroed device int the wrapper reads after the call.
BF_EXPORT int bf_fused_count_tiles(
    const long long* batches, int n_batches, const int32_t* offsets,
    const int32_t* neighbors, const int32_t* edge_src,
    const int32_t* undirected_id, const long long* w_off, long long e_pad,
    int n_pad, int high, int do_global, int do_vertex, int do_edge,
    unsigned long long* table_keys, uint32_t* table_counts,
    long long table_slots, uint32_t* slot_of, long long* total,
    long long* vertex, long long* edge, int* overflow, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Graph g{offsets, neighbors, edge_src, undirected_id, w_off,
                e_pad,   n_pad,     high};
  const unsigned long long mask =
      static_cast<unsigned long long>(table_slots) - 1;
  auto* tot = reinterpret_cast<unsigned long long*>(total);
  auto* vert = reinterpret_cast<unsigned long long*>(vertex);
  auto* edg = reinterpret_cast<unsigned long long*>(edge);
  for (int b = 0; b < n_batches; ++b) {
    const long long ws = batches[2 * b];
    const long long nw = batches[2 * b + 1] - ws;
    if (nw <= 0) continue;
    const unsigned int grid = bf::grid_for(nw);
    insert_kernel<<<grid, bf::kThreads, 0, s>>>(g, ws, nw, table_keys,
                                                table_counts, mask, slot_of,
                                                overflow);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    apply_kernel<<<grid, bf::kThreads, 0, s>>>(g, ws, nw, table_counts,
                                               slot_of, do_global, do_vertex,
                                               do_edge, tot, vert, edg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    clear_kernel<<<grid, bf::kThreads, 0, s>>>(nw, slot_of, table_keys,
                                               table_counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
