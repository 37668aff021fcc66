"""Frozen roofline of the wing decomposition, independent of any kernel.

The least time an H100 SXM could take for one exact wing decomposition
of a bipartite graph with ``m`` edges (PEEL-E, the paper's Alg. 6),
whose butterflies through an edge ``(u1, v1)`` are found by scanning,
for each ``u2`` of ``N(v1)``, the smaller of ``N(u1)`` and ``N(u2)``:

* bytes: each input byte read once and each output byte written once.
  The input is the edge list, ``8 m`` bytes (two int32 ids an edge),
  and the per-edge butterfly counts, ``8 m`` (int64); the output is the
  int64 wing number of every edge, ``8 m``;
* int32 operations: two for each of the ``L`` candidate triples, the
  paper's work bound ``L = sum over edges (u1, v1) of sum over u2 in
  N(v1) of min(deg u1, deg u2)`` (the ``u2 == u1`` term included), one
  to form the candidate and one to test it; the work per butterfly and
  per round is left out, so the count is a floor.

``L`` is computed here from the edges' degrees alone: for each ``v`` it
is the sum over ordered pairs of its neighbours of the smaller degree,
which for the neighbours' degrees sorted ascending, ``s_0 <= ... <=
s_{k-1}``, is ``sum_r s_r (2 (k - 1 - r) + 1)``.

``bound_s = max(bytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)`` at the
rates of :mod:`perfbench.roofline`. A decomposition's share of this
roofline is ``bound_s`` over the device time of all kernels it launches.
"""
from __future__ import annotations

import torch

from perfbench.roofline import HBM_BYTES_PER_S, INT32_OPS_PER_S

__all__ = ["wing_triples", "wing_bytes", "wing_ops", "wing_bound"]


def wing_triples(n_u: int, n_v: int, edges) -> int:
    """``L`` of the simple bipartite graph ``edges`` ((m, 2), U id then
    V id, no duplicates)."""
    e = torch.as_tensor(edges, dtype=torch.int64)
    if e.numel() == 0:
        return 0
    du = torch.bincount(e[:, 0], minlength=n_u)
    dv = torch.bincount(e[:, 1], minlength=n_v)
    d = du[e[:, 0]]
    # neighbours of each v by ascending degree
    d_max = int(d.max()) + 1
    order = torch.argsort(e[:, 1] * d_max + d)
    v, s = e[order, 1], d[order]
    start = torch.cumsum(dv, 0) - dv
    r = torch.arange(e.shape[0]) - start[v]
    return int((s * (2 * (dv[v] - 1 - r) + 1)).sum())


def wing_bytes(m: int) -> int:
    return 8 * m + 8 * m + 8 * m


def wing_ops(triples: int) -> int:
    return 2 * triples


def wing_bound(m: int, triples: int):
    """``(seconds, "bytes" | "ops")``: the least time and what sets it."""
    t_bytes = wing_bytes(m) / HBM_BYTES_PER_S
    t_ops = wing_ops(triples) / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
