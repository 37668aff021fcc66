// fused_count_tiles: zero-materialization butterfly counting over
// vertex-aligned tiles of the flat wedge space.
//
// Replaces the Pallas TPU kernel wedge_fused.fused_count_tiles_pallas
// (src/repro/kernels/wedge_fused.py). Per tile of flat wedge ids it
// rebuilds every wedge (CSR gathers; direction low or high), groups the
// tile's wedges by their endpoint pair (x1, x2) into multiplicities d,
// adds C(d, 2) once per group to x1, x2 and the total, and d - 1 per
// wedge to the center y and to both undirected wedge edges. The global
// wedge array never exists in device memory.
//
// The TPU kernel grouped by an all-pairs key match on the MXU, one tile
// of flat wedge ids per grid step. Walking flat ids cost the first port
// a binary search of the whole wedge prefix w_off per wedge and pass,
// and its grouping hash table of 64-bit (x1, x2) keys lived in global
// memory far larger than L2. This design groups by source vertex:
//
//  * Every wedge of slot e has src[e] as one endpoint (x1 under low, x2
//    under high), and a tile is vertex-aligned, so a group never leaves
//    one source vertex's wedge range. The grouping key is the other
//    endpoint alone, 32 bits. The unit of grouping is a segment: one
//    vertex's wedges inside one tile (the whole vertex for the aligned
//    tiles of a plan; a tile that cuts a vertex is still grouped as the
//    plain version groups it).
//  * The host plans the work (kernels/cuda.py:fused_work): light
//    segments (at most kLightSlots / 2 = 14,336 wedges) are packed into
//    batches of at most that many wedges; heavy ones are split into
//    chunks, and their counters are bounded in flight.
//  * Light batches: one block each, 1,024 threads, a hash table of
//    kLightSlots 4-byte keys and 4-byte counts in 224 KiB of shared
//    memory. Each segment owns a region of exactly 2x its wedges (load
//    factor 1/2, so a probe always ends), so keys need no vertex part. A
//    count pass and an apply pass run in the block with __syncthreads()
//    between; no global scratch and no clear pass.
//  * Heavy segments: one cooperative launch walks rounds of segments.
//    A round holds at most 16 (FUSED_MAX_IN_FLIGHT, the counter buffers
//    allocated: 44.8 MB at the smoke graph's n_pad = 350,000) whose
//    counters can touch at most 24 MiB of 32-byte sectors, about half
//    the 50 MB L2 (min(8 B x n_pad, 32 B x wedges) a segment). Each
//    buffer is a dense uint64 counter per endpoint: the count phase adds
//    1 to the low word, a grid barrier, then the apply phase adds 2^32
//    and reads back (d, seen) in one atomic. seen == 0 marks the group's
//    representative; seen + 1 == d is the group's last wedge, which
//    stores 0, so every touched entry is clear again for the next round
//    with no clear pass and no memset. Chunks of one segment spread over
//    many blocks, so the 1,086,647-wedge vertex of the smoke graph does
//    not set the critical path. A dense array over n_pad was chosen over
//    a hash sized 2x the segment (probes, and a clear pass, since a
//    cleared hash slot breaks other keys' probe chains) and over
//    distributed shared memory of a block cluster (8 x 200 KB holds one
//    1.4 MB array, but then one segment per cluster is in flight and a
//    remote atomic per wedge crosses the SM-to-SM network). Where
//    8 B x n_pad outgrows the L2 budget, one large segment is in flight
//    and its counter spills to HBM: correct, slower, not measured.
//  * Blocks walk their range by flat wedge id, one wedge per thread;
//    a wedge's slot e is an upper bound over w_off restricted to the
//    chunk's own slot range (a few L1-resident entries, not the whole
//    prefix), and the second edges of one slot are a contiguous run of
//    pos, read as coalesced runs of nbr and uid. A per-thread cursor
//    that scans forward from its last slot instead measured slower on
//    the H100 (scripts/torch_fused_probe.py), so the search stays.
//
// What bounds it on an H100: L2 atomics and latency, not HBM bytes (the
// inputs and outputs are ~84 MB, 0.025 ms at 3.35 TB/s). Per wedge the
// design does one counter increment, one counter atomic with return and
// one edge[uid[pos]] add, all on arrays L2 holds (counters, vertex 2.8
// MB, edge 13 MB at the smoke shape). Sums happen before atomics: under
// either direction y = nbr[e] and uid[e] are fixed for all cnt wedges
// of slot e, so their d - 1 terms are summed across the warp's lanes of
// one slot (one atomic per slot per warp, not per wedge); the segment
// vertex's own C(d, 2) terms are summed across the block (heavy) or the
// warp's lanes of one vertex (light); only C(d, 2) to the other endpoint
// (once per group) and d - 1 to uid[pos] (once per wedge) stay
// scattered; the total is one atomic per block. Adds of zero are
// skipped. On an H100 80GB HBM3 at 700 W the output atomics take ~1.3
// of the heavy kernel's ~5.3 ms at the smoke shape (the probe's --mode
// global against all); recovery and the counter atomics the rest.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLightThreads = 1024;
constexpr int kLightSlots = 28672;  // 224 KiB of keys and counts
constexpr int kLightSmem = kLightSlots * 8;
constexpr int32_t kEmptyKey = -1;
constexpr uint32_t kClaimed = 0x80000000u;
constexpr unsigned kFull = 0xffffffffu;

struct Graph {
  const int32_t* off;
  const int32_t* nbr;
  const int32_t* src;
  const int32_t* uid;
  const long long* w_off;
  long long e_pad;
  int n_pad;
  int high;
  int do_global;
  int do_vertex;
  int do_edge;
};

struct Wedge {
  int e;          // directed slot of the iterating edge (src[e] -> y)
  int pos;        // slot of the second edge (y -> x)
  int x;          // the other endpoint: the group key
  int y;          // the center
};

// Wedge t of a range whose slots lie in [e_lo, e_hi]: w_off[e_lo] <= t <
// w_off[e_hi] (the host's plan guarantees it), so the upper bound is
// searched over that range only. The reference's clamps stay (y below
// the n_pad sentinel before it indexes offsets, pos inside e_pad).
__device__ __forceinline__ Wedge wedge_at(const Graph& g, long long t,
                                          long long e_lo, long long e_hi) {
  long long lo = e_lo + 1;
  long long hi = e_hi;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(&g.w_off[mid]) <= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long e = lo - 1;
  const long long w0 = __ldg(&g.w_off[e]);
  const long long j = t - w0;
  const long long cnt = __ldg(&g.w_off[e + 1]) - w0;
  const int32_t y = __ldg(&g.nbr[e]);
  const int32_t ys = y < g.n_pad - 1 ? y : g.n_pad - 1;
  long long pos = g.high ? static_cast<long long>(__ldg(&g.off[ys])) + j
                         : static_cast<long long>(__ldg(&g.off[ys + 1])) -
                               cnt + j;
  pos = pos < 0 ? 0 : (pos > g.e_pad - 1 ? g.e_pad - 1 : pos);
  Wedge w;
  w.e = static_cast<int>(e);
  w.pos = static_cast<int>(pos);
  w.x = __ldg(&g.nbr[pos]);
  w.y = y;
  return w;
}

__device__ __forceinline__ void add(unsigned long long* p,
                                    unsigned long long v) {
  if (v != 0) atomicAdd(p, v);
}

// Sum of v over the lanes of the warp that hold the same key, where
// equal keys sit on consecutive lanes (flat wedge ids are consecutive
// across lanes). The segment's sum lands in its first lane, which gets
// *head = true. Every lane of the warp must call it.
__device__ __forceinline__ unsigned long long segment_sum(
    unsigned long long v, int key, bool* head) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long ov = __shfl_down_sync(kFull, v, o);
    const int ok = __shfl_down_sync(kFull, key, o);
    if (lane + o < 32 && ok == key) v += ov;
  }
  const int prev = __shfl_up_sync(kFull, key, 1);
  *head = lane == 0 || prev != key;
  return v;
}

// One wedge step's terms, given its group's d and whether this wedge is
// the group's representative: d - 1 to uid[pos] (per wedge), C(d, 2) to
// the other endpoint (per group; also returned for the caller's sums of
// the segment vertex's and the total's terms), and d - 1 summed per slot
// e to the center y and the iterating edge uid[e] (per slot and warp).
// Every lane of the warp must call it; inactive lanes pass active false.
__device__ __forceinline__ unsigned long long apply_wedge(
    const Graph& g, bool active, const Wedge& w, unsigned long long d,
    bool rep, unsigned long long* __restrict__ vertex,
    unsigned long long* __restrict__ edge) {
  const unsigned long long dm1 = active ? d - 1 : 0;
  unsigned long long c2 = 0;
  if (active) {
    if (g.do_edge) add(&edge[__ldg(&g.uid[w.pos])], dm1);
    if (rep) {
      c2 = d * dm1 / 2;
      if (g.do_vertex) add(&vertex[w.x], c2);
    }
  }
  if (g.do_vertex || g.do_edge) {
    bool head;
    const unsigned long long s = segment_sum(dm1, active ? w.e : -1, &head);
    if (active && head && s != 0) {
      if (g.do_vertex) atomicAdd(&vertex[w.y], s);
      if (g.do_edge) atomicAdd(&edge[__ldg(&g.uid[w.e])], s);
    }
  }
  return c2;
}

__device__ __forceinline__ unsigned long long block_sum(unsigned long long v) {
  __shared__ unsigned long long warp_sums[32];
  __syncthreads();  // a previous call's readers are done with warp_sums
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  }
  return v;  // the block's sum, in thread 0
}

__device__ __forceinline__ uint32_t mix32(uint32_t k) {
  k ^= k >> 16;
  k *= 0x7feb352du;
  k ^= k >> 15;
  k *= 0x846ca68bu;
  k ^= k >> 16;
  return k;
}

// First probe of key x in a region of `size` slots (any size, not only a
// power of two: a multiply-high range reduction).
__device__ __forceinline__ int probe_start(int32_t x, int size) {
  return static_cast<int>(
      (static_cast<unsigned long long>(mix32(static_cast<uint32_t>(x))) *
       static_cast<unsigned>(size)) >>
      32);
}

__device__ __forceinline__ int find_or_insert(int32_t* keys, int32_t x,
                                              int base, int size) {
  int s = base + probe_start(x, size);
  const int end = base + size;
  while (true) {
    int32_t k = *reinterpret_cast<volatile int32_t*>(&keys[s]);
    if (k == x) return s;
    if (k == kEmptyKey) {
      k = atomicCAS(&keys[s], kEmptyKey, x);
      if (k == kEmptyKey || k == x) return s;
    }
    if (++s == end) s = base;
  }
}

__device__ __forceinline__ int find(const int32_t* keys, int32_t x, int base,
                                    int size) {
  int s = base + probe_start(x, size);
  const int end = base + size;
  while (keys[s] != x) {
    if (++s == end) s = base;
  }
  return s;
}

// The shared-memory region of the segment that holds slot e, inside the
// batch [t0, t1): 2 slots per wedge of the segment, at twice its offset.
__device__ __forceinline__ void light_region(const Graph& g, int v,
                                             long long t0, long long t1,
                                             int* base, int* size) {
  long long a = __ldg(&g.w_off[__ldg(&g.off[v])]);
  long long b = __ldg(&g.w_off[__ldg(&g.off[v + 1])]);
  a = a > t0 ? a : t0;
  b = b < t1 ? b : t1;
  *base = static_cast<int>(2 * (a - t0));
  *size = static_cast<int>(2 * (b - a));
}

// One block per light batch (t0, t1, e_lo, e_hi): count, then apply.
__global__ void __launch_bounds__(kLightThreads, 1)
    fused_light_kernel(Graph g, const long long* __restrict__ batches,
                       unsigned long long* __restrict__ total,
                       unsigned long long* __restrict__ vertex,
                       unsigned long long* __restrict__ edge) {
  extern __shared__ int32_t smem[];
  int32_t* keys = smem;
  uint32_t* counts = reinterpret_cast<uint32_t*>(smem + kLightSlots);
  const long long* b = batches + 4 * static_cast<long long>(blockIdx.x);
  const long long t0 = b[0], t1 = b[1], e_lo = b[2], e_hi = b[3];
  const int n = static_cast<int>(2 * (t1 - t0));
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    keys[i] = kEmptyKey;
    counts[i] = 0;
  }
  __syncthreads();

  // count
  for (long long t = t0 + threadIdx.x; t < t1; t += blockDim.x) {
    const Wedge w = wedge_at(g, t, e_lo, e_hi);
    int base, size;
    light_region(g, __ldg(&g.src[w.e]), t0, t1, &base, &size);
    atomicAdd(&counts[find_or_insert(keys, w.x, base, size)], 1u);
  }
  __syncthreads();

  // apply (the trip count is the block's, so every lane shuffles)
  unsigned long long local = 0;
  for (long long t_base = t0; t_base < t1; t_base += blockDim.x) {
    const long long t = t_base + threadIdx.x;
    const bool active = t < t1;
    Wedge w{};
    int v = -1;
    unsigned long long d = 0;
    bool rep = false;
    if (active) {
      w = wedge_at(g, t, e_lo, e_hi);
      v = __ldg(&g.src[w.e]);
      int base, size;
      light_region(g, v, t0, t1, &base, &size);
      const uint32_t old = atomicOr(&counts[find(keys, w.x, base, size)],
                                    kClaimed);
      d = old & ~kClaimed;
      rep = !(old & kClaimed);
    }
    const unsigned long long c2 = apply_wedge(g, active, w, d, rep, vertex,
                                              edge);
    local += c2;
    if (g.do_vertex) {  // the segment vertex's terms, summed per warp
      bool head;
      const unsigned long long s = segment_sum(c2, v, &head);
      if (active && head) add(&vertex[v], s);
    }
  }
  if (g.do_global) {
    const unsigned long long s = block_sum(local);
    if (threadIdx.x == 0) add(total, s);
  }
}

// Heavy segments, one cooperative launch: per round, a count phase and
// an apply phase over the round's chunks (t0, t1, e_lo, e_hi, buffer),
// with a grid barrier after each.
__global__ void __launch_bounds__(bf::kThreads)
    fused_heavy_kernel(Graph g, const long long* __restrict__ chunks,
                       const long long* __restrict__ rounds, int n_rounds,
                       unsigned long long* __restrict__ counters,
                       unsigned long long* __restrict__ total,
                       unsigned long long* __restrict__ vertex,
                       unsigned long long* __restrict__ edge) {
  cg::grid_group grid = cg::this_grid();
  const long long n_pad = g.n_pad;
  for (int r = 0; r < n_rounds; ++r) {
    const long long c_end = rounds[r + 1];
    for (long long c = rounds[r] + blockIdx.x; c < c_end; c += gridDim.x) {
      const long long* ch = chunks + 5 * c;
      const long long t1 = ch[1], e_lo = ch[2], e_hi = ch[3];
      unsigned long long* ctr = counters + ch[4] * n_pad;
      for (long long t = ch[0] + threadIdx.x; t < t1; t += blockDim.x) {
        const Wedge w = wedge_at(g, t, e_lo, e_hi);
        // the low word of the little-endian uint64: d
        atomicAdd(reinterpret_cast<unsigned int*>(&ctr[w.x]), 1u);
      }
    }
    grid.sync();
    for (long long c = rounds[r] + blockIdx.x; c < c_end; c += gridDim.x) {
      const long long* ch = chunks + 5 * c;
      const long long t0 = ch[0], t1 = ch[1], e_lo = ch[2], e_hi = ch[3];
      unsigned long long* ctr = counters + ch[4] * n_pad;
      unsigned long long local = 0;
      for (long long t_base = t0; t_base < t1; t_base += blockDim.x) {
        const long long t = t_base + threadIdx.x;
        const bool active = t < t1;
        Wedge w{};
        unsigned long long d = 0, seen = 1;
        if (active) {
          w = wedge_at(g, t, e_lo, e_hi);
          const unsigned long long old = atomicAdd(&ctr[w.x], 1ULL << 32);
          d = old & 0xffffffffULL;
          seen = old >> 32;
          if (seen + 1 == d) ctr[w.x] = 0;  // the group's last wedge
        }
        local += apply_wedge(g, active, w, d, seen == 0, vertex, edge);
      }
      // one segment per chunk: its vertex's C(d, 2) terms, once a block
      const unsigned long long s = block_sum(local);
      if (threadIdx.x == 0 && s != 0) {
        if (g.do_vertex) atomicAdd(&vertex[__ldg(&g.src[e_lo])], s);
        if (g.do_global) atomicAdd(total, s);
      }
    }
    if (r + 1 < n_rounds) grid.sync();
  }
}

// Once per device: the light kernel's shared-memory table above 48 KiB,
// and the heavy kernel's resident blocks per SM (0 on error).
cudaError_t allow_light_smem() {
  static std::atomic<int> done[bf::kMaxDevices];
  const int ok = bf::cached_per_device(done, [](int) {
    return cudaFuncSetAttribute(
               reinterpret_cast<const void*>(&fused_light_kernel),
               cudaFuncAttributeMaxDynamicSharedMemorySize,
               kLightSmem) == cudaSuccess
               ? 1
               : 0;
  });
  return ok ? cudaSuccess : cudaGetLastError();
}

int heavy_blocks_per_sm() {
  static std::atomic<int> resident[bf::kMaxDevices];
  return bf::cached_per_device(resident, [](int) {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_heavy_kernel, bf::kThreads, 0);
    return blocks;
  });
}

}  // namespace

// The host's work list (kernels/cuda.py:fused_work), on the device:
// light (n_light, 4) and heavy chunks (rounds[n_rounds], 5) int64 rows,
// rounds (n_rounds + 1,) chunk offsets. counters holds in_flight x n_pad
// zeroed uint64 and is left zeroed. total (1,), vertex (n_pad,) and edge
// (m,) are zeroed int64 outputs. light_slots must equal the kernel's
// table (the wrapper's FUSED_LIGHT_SLOTS), else cudaErrorInvalidValue.
BF_EXPORT int bf_fused_count_tiles(
    const int32_t* offsets, const int32_t* neighbors, const int32_t* edge_src,
    const int32_t* undirected_id, const long long* w_off, long long e_pad,
    int n_pad, int high, int do_global, int do_vertex, int do_edge,
    int light_slots, const long long* light, int n_light,
    const long long* heavy, const long long* rounds, int n_rounds,
    unsigned long long* counters, long long* total, long long* vertex,
    long long* edge, void* stream) {
  if (light_slots != kLightSlots || n_light < 0 || n_rounds < 0 ||
      e_pad < 1 || e_pad > INT_MAX || n_pad < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Graph g{offsets, neighbors, edge_src, undirected_id, w_off, e_pad,
          n_pad,   high,      do_global, do_vertex,   do_edge};
  auto* tot = reinterpret_cast<unsigned long long*>(total);
  auto* vert = reinterpret_cast<unsigned long long*>(vertex);
  auto* edg = reinterpret_cast<unsigned long long*>(edge);
  cudaError_t e;
  if (n_light > 0) {
    if ((e = allow_light_smem()) != cudaSuccess) return static_cast<int>(e);
    fused_light_kernel<<<n_light, kLightThreads, kLightSmem, s>>>(
        g, light, tot, vert, edg);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  if (n_rounds > 0) {
    const int per_sm = heavy_blocks_per_sm();
    if (per_sm <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const unsigned int grid =
        static_cast<unsigned int>(per_sm * bf::sm_count());
    void* args[] = {&g,        &heavy, &rounds, &n_rounds,
                    &counters, &tot,   &vert,   &edg};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&fused_heavy_kernel), dim3(grid),
        dim3(bf::kThreads), args, 0, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
