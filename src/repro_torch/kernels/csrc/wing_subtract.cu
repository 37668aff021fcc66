// wing_subtract: one tile [ts, te) of a wing-peeling round's flat triple
// space, recovered and subtracted in one launch, the counts decremented
// in place.
//
// One thread per flat id w (grid-stride):
//   1. a binary search of roff (the int64 prefix of the per-edge triple
//      space sizes l2 over the round's peeled edges ids) gives the
//      peeled edge a = (u1, v1) and the offset tp inside its space;
//   2. v1's degree-sorted row splits at deg(u2) >= deg(u1) (a binary
//      search of degkey inside the row): a head candidate u2 owns
//      deg(u2) centres, found by a binary search of the degree prefix
//      gpre; a tail candidate owns deg(u1), found by one division;
//   3. v2 is the i-th neighbour of the smaller-degree side of u1, u2,
//      and the other side must have the edge to v2 (a binary search of
//      comp inside that side's row);
//   4. if u2 != u1, v2 != v1 and the butterfly's other edges b = (u2,
//      v1), c = (u1, v2), d = (u2, v2) are present for a (alive before
//      the round, and not peeled in it or of a larger id than a), each
//      of their counts takes an atomic -1.
// Every index is clamped as the plain version clamps it, so no lane
// reads out of range. The kernel decrements whether the edge is alive
// or not, as bucket_update applies every decrement.
//
// Replaces no TPU kernel. The reference recovers a tile's triples with
// about 45 XLA ops (src/repro/core/peel.py, the wing device engine),
// then groups the three edge ids by sorting and subtracts each group's
// size through bucket_update; the port did the same with torch ops
// (kernels/ref.py: wing_subtract_ref keeps the recovery). A wing
// decrement is a sum of ones, so atomics give the same counts bit for
// bit in any order, and the grouping goes.
//
// What bounds it on an H100: the host that enqueues it. A round of the
// Graph 500 SCALE 12 decomposition streams about 47k lanes, each four
// dependent binary searches over int64 arrays of 2m entries (under 1 MB
// each at m = 54k, so L2-resident) and at most three atomics; one
// launch replaces the ~55 enqueues a tile took. The searches of step 2
// and 3 are cut to one CSR row: the keys are sorted by row first, so
// the global search lands there too.
#include "common.cuh"

namespace {

struct WingGraph {
  const long long* eu;
  const long long* ev;
  const long long* deg;
  const long long* off;
  const long long* nbr;
  const long long* uid;
  const long long* nbr_ds;
  const long long* uid_ds;
  const long long* degkey;
  const long long* gpre;
  const long long* comp;
  long long stride;
  long long n;
  long long slots;  // 2m: nbr, uid, nbr_ds, uid_ds, degkey, comp entries
};

// First index in [lo, hi) whose value is >= key, hi if none
// (searchsorted side="left").
__device__ __forceinline__ long long lower_bound(const long long* a,
                                                 long long lo, long long hi,
                                                 long long key) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(&a[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First index in [lo, hi) whose value is > key, hi if none
// (searchsorted side="right").
__device__ __forceinline__ long long upper_bound(const long long* a,
                                                 long long lo, long long hi,
                                                 long long key) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(&a[mid]) <= key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void take_one(int32_t* p) { atomicAdd(p, -1); }

__device__ __forceinline__ void take_one(long long* p) {
  // two's complement: adding 2^64 - 1 subtracts one
  atomicAdd(reinterpret_cast<unsigned long long*>(p), ~0ULL);
}

// Edge x is present for the peeled edge a.
__device__ __forceinline__ bool present(const uint8_t* __restrict__ alive_prev,
                                        const uint8_t* __restrict__ peel,
                                        long long x, long long a) {
  return alive_prev[x] && (!peel[x] || x > a);
}

template <typename T>
__global__ void __launch_bounds__(bf::kThreads)
    wing_subtract_kernel(const long long* __restrict__ roff, long long k,
                         const long long* __restrict__ ids,
                         const uint8_t* __restrict__ alive_prev,
                         const uint8_t* __restrict__ peel, WingGraph g,
                         long long ts, long long te, T* __restrict__ counts) {
  const long long slot_max = g.slots - 1;
  const long long total = roff[k];
  const long long last = total > 0 ? total - 1 : 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = ts + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < te; w += stride) {
    // 1. the peeled edge and the offset inside its space
    const long long kc = w < last ? w : last;
    const long long seg = clamp_ll(upper_bound(roff, 0, k + 1, kc) - 1, 0,
                                   k - 1);
    const long long tp = kc - roff[seg];
    const long long a = ids[seg];
    const long long u1 = g.eu[a];
    const long long v1 = g.ev[a];
    const long long d1 = g.deg[u1];
    const long long rs = g.off[v1];
    // 2. split N(v1) (degree-sorted) at deg(u2) >= deg(u1)
    const long long q = lower_bound(g.degkey, rs, g.off[v1 + 1],
                                    v1 * g.stride + d1);
    const long long g_rs = g.gpre[rs];
    const long long head = g.gpre[q] - g_rs;
    long long p1;
    long long i;
    if (tp < head) {
      // head: gpre[p1] <= g_rs + tp < gpre[p1 + 1], p1 in [rs, q)
      p1 = clamp_ll(lower_bound(g.gpre, rs + 1, q + 1, g_rs + tp + 1) - 1,
                    0, slot_max);
      i = tp - (g.gpre[p1] - g_rs);
    } else {
      // tail: deg(u1)-sized blocks
      const long long r = tp - head;
      const long long d1s = d1 > 1 ? d1 : 1;
      const long long j = r / d1s;
      p1 = clamp_ll(q + j, 0, slot_max);
      i = r - j * d1s;
    }
    const long long u2 = g.nbr_ds[p1];
    const long long b = g.uid_ds[p1];
    if (u2 == u1 || !present(alive_prev, peel, b, a)) continue;
    // 3. the i-th neighbour v2 of the smaller side
    const bool si = d1 <= g.deg[u2];
    const long long small = si ? u1 : u2;
    const long long oth = si ? u2 : u1;
    const long long ds = g.deg[small];
    i = clamp_ll(i, 0, ds > 0 ? ds - 1 : 0);
    const long long pos2 = clamp_ll(g.off[small] + i, 0, slot_max);
    const long long v2 = g.nbr[pos2];
    if (v2 == v1) continue;
    // membership: (other, v2) must be an edge, in the other side's row
    const long long key = oth * g.n + v2;
    const long long o_end = g.off[oth + 1];
    const long long p = lower_bound(g.comp, g.off[oth], o_end, key);
    if (p >= o_end || g.comp[p] != key) continue;
    const long long e_small = g.uid[pos2];
    const long long e_other = g.uid[p];
    // c = (u1, v2), d = (u2, v2): map small/other back
    const long long c = si ? e_small : e_other;
    const long long d = si ? e_other : e_small;
    if (!present(alive_prev, peel, c, a) || !present(alive_prev, peel, d, a))
      continue;
    // 4. one from each of the three other edges
    take_one(&counts[b]);
    take_one(&counts[c]);
    take_one(&counts[d]);
  }
}

}  // namespace

// The graph's arrays are int64 on the device, as kernels/ref.py's
// WingGraph lists them; k >= 1 peeled edges, 0 <= ts < te <= roff[k].
BF_EXPORT int bf_wing_subtract(const long long* roff, long long k,
                               const long long* ids, const uint8_t* alive_prev,
                               const uint8_t* peel, const long long* eu,
                               const long long* ev, const long long* deg,
                               const long long* off, const long long* nbr,
                               const long long* uid, const long long* nbr_ds,
                               const long long* uid_ds,
                               const long long* degkey, const long long* gpre,
                               const long long* comp, long long graph_stride,
                               long long n, long long slots, long long ts,
                               long long te, void* counts, int counts_is_64,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || te <= ts) return static_cast<int>(cudaGetLastError());
  const WingGraph g{eu,     ev,     deg,  off,  nbr,          uid, nbr_ds,
                    uid_ds, degkey, gpre, comp, graph_stride, n,   slots};
  const unsigned int grid = bf::grid_for(te - ts);
  if (counts_is_64) {
    wing_subtract_kernel<long long><<<grid, bf::kThreads, 0, s>>>(
        roff, k, ids, alive_prev, peel, g, ts, te,
        static_cast<long long*>(counts));
  } else {
    wing_subtract_kernel<int32_t><<<grid, bf::kThreads, 0, s>>>(
        roff, k, ids, alive_prev, peel, g, ts, te,
        static_cast<int32_t*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}
