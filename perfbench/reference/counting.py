"""Plain PyTorch reference for exact butterfly counts.

Works from the edge arrays alone and imports nothing of the program. The
textbook algorithm (Chiba-Nishizeki wedges under a degree order; Wang et
al., Sanei-Mehri et al.): rank every vertex by decreasing degree, ties
by id (U ids first, then V ids); a wedge ``x1 - y - x2`` is taken from
the endpoint ``x1`` that ranks before both ``y`` and ``x2``. The wedges
of one endpoint pair ``(x1, x2)`` with ``d`` members close ``C(d, 2)``
butterflies, each counted once, at the pair's lowest-ranked vertex:

* the total and each endpoint gain ``C(d, 2)``;
* each wedge's centre and each of its two edges gain ``d - 1``.

``dtype`` is the accumulator: ``torch.int64`` for the judge, a narrower
type for the control (``int32`` wraps, ``float32`` rounds), which is
the step a faster implementation might take.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Counts", "degree_rank", "count_all", "wedge_total", "ranges"]


class Counts(NamedTuple):
    """Host int64 tensors; ``per_edge`` follows the input edge rows."""

    total: int
    per_u: torch.Tensor
    per_v: torch.Tensor
    per_edge: torch.Tensor


def ranges(starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Concatenation of ``[s, s + l)`` for each pair, in order."""
    total = int(lens.sum())
    if total == 0:
        return starts.new_zeros(0)
    excl = torch.cumsum(lens, 0) - lens
    seg_start = torch.repeat_interleave(starts - excl, lens,
                                        output_size=total)
    return seg_start + torch.arange(total, device=starts.device)


def degree_rank(n_u: int, n_v: int, edges: torch.Tensor):
    """``(global endpoints (m, 2), degree, rank)``: rank 0 is the vertex
    of highest degree; ties go to the lower global id."""
    n = n_u + n_v
    ge = torch.stack([edges[:, 0], edges[:, 1] + n_u], 1)
    deg = torch.bincount(ge.reshape(-1), minlength=n)
    order = torch.sort(-deg, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device)
    return ge, deg, rank


def _arcs(n: int, ge: torch.Tensor, rank: torch.Tensor):
    """Both directions of every edge, sorted by (source rank, target
    rank): ``(arc key, source, target, edge id, offsets by source
    rank)``."""
    m = ge.shape[0]
    src = torch.cat([ge[:, 0], ge[:, 1]])
    dst = torch.cat([ge[:, 1], ge[:, 0]])
    eid = torch.arange(m, device=ge.device).repeat(2)
    key = rank[src] * n + rank[dst]
    key, perm = torch.sort(key)
    src, dst, eid = src[perm], dst[perm], eid[perm]
    off = torch.zeros(n + 1, dtype=torch.int64, device=ge.device)
    off[1:] = torch.cumsum(torch.bincount(rank[src], minlength=n), 0)
    return key, src, dst, eid, off


def _wedge_arcs(n: int, rank, key, src, dst, off):
    """For every arc ``x1 -> y`` with ``y`` after ``x1``: the first arc
    ``y -> x2`` with ``x2`` after ``x1`` and how many follow it."""
    keep = rank[dst] > rank[src]
    a = torch.nonzero(keep).squeeze(1)
    y_rank = rank[dst[a]]
    first = torch.searchsorted(key, y_rank * n + rank[src[a]], right=True)
    cnt = off[y_rank + 1] - first
    return a, first, cnt


def wedge_total(n_u: int, n_v: int, edges: torch.Tensor) -> int:
    """Number of wedges the degree order takes (the work of a count)."""
    ge, _deg, rank = degree_rank(n_u, n_v, edges)
    key, src, dst, _eid, off = _arcs(n_u + n_v, ge, rank)
    _a, _first, cnt = _wedge_arcs(n_u + n_v, rank, key, src, dst, off)
    return int(cnt.sum())


def count_all(n_u: int, n_v: int, edges, *, dtype=torch.int64,
              device="cpu", block: int = 1 << 25) -> Counts:
    """Total, per-vertex and per-edge butterfly counts of the simple
    bipartite graph ``edges`` ((m, 2), U id then V id, no duplicates).
    Wedges are taken in blocks of about ``block`` so the peak stays
    bounded."""
    edges = torch.as_tensor(edges, dtype=torch.int64, device=device)
    n, m = n_u + n_v, edges.shape[0]
    ge, _deg, rank = degree_rank(n_u, n_v, edges)
    key, src, dst, eid, off = _arcs(n, ge, rank)
    a, first, cnt = _wedge_arcs(n, rank, key, src, dst, off)
    per_vertex = torch.zeros(n, dtype=dtype, device=device)
    per_edge = torch.zeros(m, dtype=dtype, device=device)
    total = torch.zeros((), dtype=dtype, device=device)
    for lo, hi in _blocks(rank[src[a]], cnt, block):
        c = cnt[lo:hi]
        arc = a[torch.repeat_interleave(torch.arange(lo, hi, device=device),
                                        c)]
        pos = ranges(first[lo:hi], c)
        x1, y, x2 = src[arc], dst[arc], dst[pos]
        pair, inv, d = torch.unique(x1 * n + x2, return_inverse=True,
                                    return_counts=True)
        closed = (d * (d - 1) // 2).to(dtype)
        total += closed.sum(dtype=dtype)
        per_vertex.index_add_(0, pair // n, closed)
        per_vertex.index_add_(0, pair % n, closed)
        dm1 = (d[inv] - 1).to(dtype)
        per_vertex.index_add_(0, y, dm1)
        per_edge.index_add_(0, eid[arc], dm1)
        per_edge.index_add_(0, eid[pos], dm1)
    per_vertex = _to_int64(per_vertex)
    return Counts(int(_to_int64(total)), per_vertex[:n_u],
                  per_vertex[n_u:], _to_int64(per_edge))


def _blocks(x1_rank: torch.Tensor, cnt: torch.Tensor, block: int):
    """Cut the wedge-taking arcs into runs of about ``block`` wedges,
    only between two source vertices, so each endpoint pair's wedges
    fall in one run. Yields ``(lo, hi)`` arc index ranges."""
    if cnt.numel() == 0:
        return
    run_end = torch.nonzero(x1_rank[1:] != x1_rank[:-1]).squeeze(1) + 1
    run_end = torch.cat([run_end, run_end.new_tensor([cnt.numel()])])
    done = torch.cumsum(cnt, 0)[run_end - 1]
    targets = torch.arange(block, int(done[-1]) + block, block,
                           device=cnt.device)
    cuts = run_end[torch.searchsorted(done, targets).clamp(
        max=run_end.numel() - 1)]
    lo = 0
    for hi in torch.unique(cuts).tolist():
        if hi > lo:
            yield lo, hi
            lo = hi


def _to_int64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype.is_floating_point:
        t = torch.round(t)
    return t.to(torch.int64).cpu()
