"""Plain PyTorch versions of the counting and peeling kernels.

Each function computes exactly what its CUDA kernel computes, on any
device: ``kernels/ops.py`` takes these for a tensor on the CPU, the CPU
tests hold them against the reference package's Pallas kernels, and
``chip_smoke.py`` holds each CUDA kernel against its plain version on
the card, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "NUM_BUCKETS",
    "I32_MAX",
    "wedge_histogram_ref",
    "butterfly_combine_ref",
    "choose2_limbs",
    "fused_count_tiles_ref",
    "bit_length",
    "bucket_upper_bound",
    "lowest_nonempty_bucket",
    "bucket_min_ref",
    "bucket_state_ref",
    "bucket_update_ref",
    "WingGraph",
    "wing_subtract_ref",
]

# Geometric count ranges of the peeling occupancy histogram: bucket k
# holds the int32 values with bit_length k, so 32 buckets cover [0, 2^31).
NUM_BUCKETS = 32
I32_MAX = 2**31 - 1


def wedge_histogram_ref(keys: torch.Tensor, valid: torch.Tensor,
                        num_buckets: int) -> torch.Tensor:
    """counts[b] = number of entries with ``valid > 0`` and key ``b``;
    keys outside ``[0, num_buckets)`` are dropped. int32 (num_buckets,)."""
    keys = keys.reshape(-1).long()
    live = (valid.reshape(-1).to(torch.int32) > 0)
    live &= (keys >= 0) & (keys < num_buckets)
    out = torch.zeros(num_buckets, dtype=torch.int32, device=keys.device)
    k = keys[live]
    return out.index_add_(0, k, torch.ones_like(k, dtype=torch.int32))


def butterfly_combine_ref(d: torch.Tensor, rep: torch.Tensor,
                          valid: torch.Tensor):
    """``dm1 = d - 1`` where ``valid & d > 0`` (else 0), int32; ``c2 =
    C(d, 2)`` where also ``rep`` (else 0), exact int64 for every int32
    ``d``. Returns ``(dm1, c2)``."""
    d = d.to(torch.int32)
    live = (valid.to(torch.int32) > 0) & (d > 0)
    dm1 = torch.where(live, d - 1, torch.zeros_like(d))
    dd = d.to(torch.int64)
    c2 = torch.where(live & (rep.to(torch.int32) > 0), dd * (dd - 1) // 2,
                     torch.zeros_like(dd))
    return dm1, c2


def choose2_limbs(d: torch.Tensor):
    """Exact C(d, 2) for int32 ``d`` in [0, 2^31) as the reference
    kernel's (lo, hi) int32 limbs of the 64-bit result (``lo`` is the
    low word's bit pattern). Only the parity tests use this: the port's
    kernels return C(d, 2) as int64."""
    dd = d.to(torch.int64)
    c2 = dd * (dd - 1) // 2
    lo = c2 & 0xFFFFFFFF
    lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo)
    return lo.to(torch.int32), (c2 >> 32).to(torch.int32)


def fused_count_tiles_ref(
    tile_bounds: torch.Tensor,
    offsets: torch.Tensor,
    neighbors: torch.Tensor,
    edge_src: torch.Tensor,
    undirected_id: torch.Tensor,
    w_off: torch.Tensor,
    *,
    n_pad: int,
    m: int,
    direction: str = "low",
    mode: str = "all",
):
    """Per vertex-aligned tile ``[ws, we)`` of flat wedge ids: rebuild
    each wedge (upper bound on ``w_off``, CSR gathers), group the tile's
    wedges by (x1, x2) into multiplicities d, add C(d, 2) per group to
    x1, x2 and the total, and d - 1 per wedge to the center y and both
    wedge edges. Returns exact int64 ``(total (), vertex (n_pad,),
    edge (m,))``; modes not requested by ``mode`` come back as zeros.
    ``tile_bounds`` is an (n_tiles, 2) integer tensor on any device."""
    dev = neighbors.device
    do_global = mode in ("global", "all")
    do_vertex = mode in ("vertex", "all")
    do_edge = mode in ("edge", "all")
    e_pad = int(neighbors.shape[0])
    nbr = neighbors.long()
    src = edge_src.long()
    off = offsets.long()
    uid = undirected_id.long()
    w_off = w_off.long()
    total = torch.zeros((), dtype=torch.int64, device=dev)
    vertex = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    edge = torch.zeros(m, dtype=torch.int64, device=dev)
    for ws, we in tile_bounds.tolist():
        if we <= ws:
            continue
        wid = torch.arange(ws, we, dtype=torch.int64, device=dev)
        e = torch.clamp(torch.searchsorted(w_off, wid, right=True) - 1,
                        0, e_pad - 1)
        j = wid - w_off[e]
        cnt_e = w_off[e + 1] - w_off[e]
        y = nbr[e]
        y_safe = torch.clamp(y, max=n_pad - 1)
        if direction == "low":
            x1 = src[e]
            pos = torch.clamp(off[y_safe + 1] - cnt_e + j, 0, e_pad - 1)
            x2 = nbr[pos]
        elif direction == "high":
            x2 = src[e]
            pos = torch.clamp(off[y_safe] + j, 0, e_pad - 1)
            x1 = nbr[pos]
        else:
            raise ValueError(f"direction must be low|high, got {direction}")
        keys, inv, d = torch.unique((x1 << 32) | x2, return_inverse=True,
                                    return_counts=True)
        c2 = d * (d - 1) // 2
        dm1 = d[inv] - 1
        if do_global:
            total += c2.sum()
        if do_vertex:
            vertex.index_add_(0, keys >> 32, c2)
            vertex.index_add_(0, keys & 0xFFFFFFFF, c2)
            vertex.index_add_(0, y, dm1)
        if do_edge:
            edge.index_add_(0, uid[e], dm1)
            edge.index_add_(0, uid[pos], dm1)
    return total, vertex, edge


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """``bit_length(max(v, 0))`` per entry, int64: the occupancy bucket
    of a count (bucket ``k`` holds ``[2^(k-1), 2^k)``, bucket 0 holds
    exactly {0}). Values are taken as int32 (callers clamp first)."""
    v = torch.clamp(v.to(torch.int64), min=0)
    # built on the device (no host-to-device copy): 2^0 .. 2^30
    powers = torch.ones(31, dtype=torch.int64, device=v.device) << torch.arange(
        31, device=v.device)
    return torch.searchsorted(powers, v, right=True)


def bucket_upper_bound(k: int) -> int:
    """Exclusive upper bound ``2^k`` of geometric bucket ``k``, clamped
    to INT32_MAX for the top bucket."""
    return I32_MAX if k >= 31 else 1 << k


def lowest_nonempty_bucket(hist: torch.Tensor) -> torch.Tensor:
    """Index of the lowest non-empty bucket of an occupancy histogram,
    ``NUM_BUCKETS`` when all are empty; a () int64 tensor."""
    idx = torch.arange(hist.shape[0], dtype=torch.int64, device=hist.device)
    idx = torch.where(hist > 0, idx, NUM_BUCKETS)
    return torch.cat([idx, idx.new_full((1,), NUM_BUCKETS)]).min()


def _clamped_i32(counts: torch.Tensor) -> torch.Tensor:
    """Counts as int32, wider values clamped (not wrapped) to INT32_MAX."""
    if counts.element_size() > 4:
        counts = torch.clamp(counts, max=I32_MAX)
    return counts.to(torch.int32)


def _masked_min(c32: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    inf = c32.new_full((1,), I32_MAX)
    return torch.cat([torch.where(live, c32, inf), inf]).min()


def _min_and_hist(c32: torch.Tensor, alive: torch.Tensor):
    live = alive.reshape(-1).to(torch.int32) > 0
    hist = torch.zeros(NUM_BUCKETS, dtype=torch.int32, device=c32.device)
    hist.index_add_(0, bit_length(c32), live.to(torch.int32))
    return _masked_min(c32, live), hist


def bucket_min_ref(counts: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Min of ``counts`` where ``alive``, INT32_MAX if none alive; a ()
    int32 tensor. Wider-than-int32 counts are clamped to INT32_MAX."""
    return _masked_min(_clamped_i32(counts.reshape(-1)),
                       alive.reshape(-1).to(torch.int32) > 0)


def bucket_state_ref(counts: torch.Tensor, alive: torch.Tensor):
    """``(min, hist)`` of ``bucket_update_ref`` with an empty batch: the
    masked min in the ``bucket_min`` contract and the (NUM_BUCKETS,)
    int32 occupancy of ``bit_length(max(v, 0))`` over alive entries."""
    return _min_and_hist(_clamped_i32(counts.reshape(-1)), alive)


def bucket_update_ref(counts: torch.Tensor, alive: torch.Tensor,
                      idx: torch.Tensor, dec: torch.Tensor):
    """Batched decrease-key: ``(new_counts, min, hist)``.

    ``new_counts[i] = counts[i] - sum(dec[idx == i])`` in the counts
    dtype; entries of ``idx`` outside ``[0, n)`` (the ``n`` sentinel
    included) are dropped. ``min`` and ``hist`` are those of
    :func:`bucket_state_ref` over the updated counts."""
    counts = counts.reshape(-1)
    n = counts.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    keep = (idx >= 0) & (idx < n)
    new = counts.clone()
    new.index_add_(0, idx[keep], -dec.reshape(-1)[keep].to(counts.dtype))
    mn, hist = _min_and_hist(_clamped_i32(new), alive)
    return new, mn, hist


class WingGraph(NamedTuple):
    """The static arrays of a wing decomposition's triple recovery, all
    int64 on one device (built once a call by ``core/peel.py``'s
    ``_wing_graph``). ``n`` vertices in global ids (V after U), ``m``
    edges, ``2m`` CSR slots:

      - ``eu``, ``ev`` (m,): each edge's U and V endpoint;
      - ``deg`` (n,), ``off`` (n + 1,): degrees and CSR offsets;
      - ``nbr``, ``uid`` (2m,): each row's neighbours, ascending, and
        the undirected edge id of each slot;
      - ``nbr_ds``, ``uid_ds`` (2m,): the same rows sorted by neighbour
        degree;
      - ``degkey`` (2m,): ``row * stride + neighbour degree`` of the
        degree-sorted rows, ascending;
      - ``gpre`` (2m + 1,): the exclusive prefix of the degree-sorted
        neighbour degrees;
      - ``comp`` (2m,): ``row * n + neighbour``, ascending;
      - ``stride``: the largest degree plus one."""

    eu: torch.Tensor
    ev: torch.Tensor
    deg: torch.Tensor
    off: torch.Tensor
    nbr: torch.Tensor
    uid: torch.Tensor
    nbr_ds: torch.Tensor
    uid_ds: torch.Tensor
    degkey: torch.Tensor
    gpre: torch.Tensor
    comp: torch.Tensor
    stride: int
    n: int


def wing_subtract_ref(counts: torch.Tensor, ts: int, te: int,
                      roff: torch.Tensor, ids: torch.Tensor,
                      alive_prev: torch.Tensor, peel: torch.Tensor,
                      g: WingGraph) -> torch.Tensor:
    """One tile ``[ts, te)`` of a wing-peeling round's flat triple space:
    every butterfly it locates takes 1 from the count of each of its
    three other still-present edges, in place. Returns ``counts``.

    ``ids`` (k,) are the round's peeled edges, ascending, and ``roff``
    (k + 1,) the int64 prefix of their triple-space sizes ``l2``. A flat
    id inverts to the peeled edge ``a = (u1, v1)`` (a search of
    ``roff``), a candidate ``u2`` of v1's degree-sorted row and a centre
    index ``i``: the row's candidates with ``deg(u2) < deg(u1)`` come
    first, each with ``deg(u2)`` centres (a search of ``gpre``), every
    later one with ``deg(u1)`` (a division). ``v2`` is the ``i``-th
    neighbour of the smaller-degree side of ``u1``, ``u2``, and the
    butterfly exists when the other side has the edge to ``v2`` (a
    search of ``comp``). Edge ``x`` is present for ``a`` when
    ``alive_prev[x] & (~peel[x] | x > a)``; a butterfly counts when
    ``u2 != u1``, ``v2 != v1`` and its three other edges ``b = (u2,
    v1)``, ``c = (u1, v2)``, ``d = (u2, v2)`` are present. Every
    decrement lands whether its edge is alive or not. Every index is
    clamped into its array, so a lane past the space reads in range."""
    if te <= ts or ids.shape[0] == 0:
        return counts
    dev = counts.device
    slot_max = g.nbr.shape[0] - 1
    stride, n = g.stride, g.n
    wid = torch.arange(ts, te, device=dev)
    kc = torch.minimum(wid, torch.clamp(roff[-1] - 1, min=0))
    seg = torch.clamp(torch.searchsorted(roff, kc, right=True) - 1,
                      0, ids.shape[0] - 1)
    tp = kc - roff[seg]
    a = ids[seg]

    def present(x):
        return alive_prev[x] & (~peel[x] | (x > a))

    u1, v1 = g.eu[a], g.ev[a]
    d1 = g.deg[u1]
    rs = g.off[v1]
    # split N(v1) (degree-sorted) at deg(u2) >= deg(u1)
    q = torch.searchsorted(g.degkey, v1 * stride + d1)
    g_rs = g.gpre[rs]
    head = g.gpre[q] - g_rs
    in_head = tp < head
    # head: ragged inner sizes from the neighbour-degree prefix
    p_head = torch.minimum(torch.searchsorted(g.gpre, g_rs + tp + 1), q) - 1
    # tail: deg(u1)-sized blocks, pure arithmetic
    r_tail = tp - head
    d1s = torch.clamp(d1, min=1)
    j_tail = r_tail // d1s
    p1 = torch.clamp(torch.where(in_head, p_head, q + j_tail), 0, slot_max)
    i = torch.where(in_head, tp - (g.gpre[p1] - g_rs), r_tail - j_tail * d1s)
    u2 = g.nbr_ds[p1]
    b = g.uid_ds[p1]
    si = d1 <= g.deg[u2]
    small = torch.where(si, u1, u2)
    oth = torch.where(si, u2, u1)
    i = torch.minimum(torch.clamp(i, min=0),
                      torch.clamp(g.deg[small] - 1, min=0))
    pos2 = torch.clamp(g.off[small] + i, 0, slot_max)
    v2 = g.nbr[pos2]
    e_small = g.uid[pos2]
    # membership: (other, v2) must be an edge
    key = oth * n + v2
    p = torch.clamp(torch.searchsorted(g.comp, key), max=slot_max)
    e_other = g.uid[p]
    # c = (u1, v2), d = (u2, v2): map small/other back
    c = torch.where(si, e_small, e_other)
    d = torch.where(si, e_other, e_small)
    ok = ((u2 != u1) & present(b) & (g.comp[p] == key) & (v2 != v1)
          & present(c) & present(d))
    tgt = torch.cat([b[ok], c[ok], d[ok]])
    return counts.index_add_(0, tgt, torch.full_like(tgt, -1,
                                                     dtype=counts.dtype))
