"""Vertex orderings (paper §3.1.1, §4.1, §4.5, §4.6).

Each ranking returns a permutation of global vertex ids (U ids first:
``0..n_u-1``, then V ids ``n_u..n-1``) ordered from rank 0 (processed
first) to rank n-1. All rankings here preserve the paper's work bounds:

  - side:                     O(Σ deg²) wedges, best locality
  - degree / approx_degree:   O(αm) wedges (Chiba–Nishizeki; Thm 4.11)
  - complement_degeneracy /
    approx_complement_degeneracy: O(αm) wedges (Thms 4.12, 4.13)

The host implementations are numpy, copied from the reference package
so a graph ranks identically in both; ``approx_complement_degeneracy``
also has a device-side bucketed round loop in PyTorch, registered as
``"approx_complement_degeneracy_device"`` so ``make_order`` /
``count_butterflies(order=...)`` can select it (it produces the
identical ordering to the host variant). Ranking cost is O(m α(m)) or
better and is amortized against O(αm) counting work.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .device import resolve_device
from .graph import BipartiteGraph

__all__ = ["make_order", "RANKINGS", "wedges_processed"]


def _global_degrees(g: BipartiteGraph) -> np.ndarray:
    du, dv = g.degrees()
    return np.concatenate([du, dv]).astype(np.int64)


def _stable_desc(keys: np.ndarray) -> np.ndarray:
    """Stable sort of vertex ids by descending key (ties keep id order).

    Keeping ties in id order preserves input locality — the motivation
    for the paper's *approximate* orders.
    """
    return np.argsort(-keys, kind="stable")


def side_order(g: BipartiteGraph) -> np.ndarray:
    """Order one bipartition entirely first (Sanei-Mehri et al.).

    The endpoint side is chosen to minimize the number of wedges
    processed: wedges with endpoints in U have centers in V, so their
    count is Σ_{v∈V} C(deg v, 2).
    """
    w_u, w_v = g.wedge_totals()
    u_ids = np.arange(g.n_u)
    v_ids = g.n_u + np.arange(g.n_v)
    if w_u <= w_v:  # endpoints in U -> U first
        return np.concatenate([u_ids, v_ids])
    return np.concatenate([v_ids, u_ids])


def degree_order(g: BipartiteGraph) -> np.ndarray:
    """Decreasing degree (Chiba–Nishizeki)."""
    return _stable_desc(_global_degrees(g))


def approx_degree_order(g: BipartiteGraph) -> np.ndarray:
    """Decreasing floor(log2 degree); ties keep original id order."""
    deg = _global_degrees(g)
    logdeg = np.zeros_like(deg)
    nz = deg > 0
    logdeg[nz] = np.floor(np.log2(deg[nz])).astype(np.int64)
    return _stable_desc(logdeg)


def _peel_max_order(g: BipartiteGraph, key_fn) -> np.ndarray:
    """Round-based max-peeling: each round removes every vertex whose
    key(current degree) equals the current maximum (paper §3.1.1).

    Removal order defines the ranking (removed first => rank 0).
    """
    n = g.n
    # CSR over global ids.
    src = np.concatenate([g.edges[:, 0], g.n_u + g.edges[:, 1]])
    dst = np.concatenate([g.n_u + g.edges[:, 1], g.edges[:, 0]])
    perm = np.argsort(src, kind="stable")
    src, dst = src[perm], dst[perm]
    deg = np.bincount(src, minlength=n).astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=offsets[1:])

    alive = np.ones(n, dtype=bool)
    cur = deg.copy()
    out = np.empty(n, dtype=np.int64)
    pos = 0
    while pos < n:
        keys = np.where(alive, key_fn(cur), -1)
        kmax = keys.max()
        batch = np.flatnonzero(alive & (keys == kmax))
        # Stable within a round: ascending id (deterministic).
        out[pos : pos + batch.size] = batch
        pos += batch.size
        alive[batch] = False
        # Decrement neighbor degrees.
        for v in batch:
            nbrs = dst[offsets[v] : offsets[v + 1]]
            live = nbrs[alive[nbrs]]
            np.subtract.at(cur, live, 1)
    return out


def complement_degeneracy_order(g: BipartiteGraph) -> np.ndarray:
    """Repeatedly remove all current-max-degree vertices."""
    return _peel_max_order(g, lambda d: d)


def approx_complement_degeneracy_order(g: BipartiteGraph) -> np.ndarray:
    """Repeatedly remove all current-max-log-degree vertices.

    Far fewer rounds than the exact variant (paper §3.1.1) while keeping
    the O(αm) wedge bound (Thm 4.13).
    """

    def logkey(d):
        out = np.full_like(d, -1)
        nz = d > 0
        out[nz] = np.floor(np.log2(d[nz])).astype(np.int64)
        return out

    return _peel_max_order(g, logkey)


def approx_complement_degeneracy_order_device(
    g: BipartiteGraph, device=None
) -> np.ndarray:
    """Device-side parallel approx-complement-degeneracy ranking.

    The paper computes this ordering with Julienne's parallel bucketing
    (peel all max-log-degree vertices per round). Each loop iteration
    is one fully parallel round on the device: a masked max-reduction
    for the bucket key, then one edge sweep (``bincount``) that
    decrements the degrees of live neighbours of the peeled vertices.
    The loop tests for termination on the host once per round; the
    round count is O(log dmax x peel levels), tiny for the approximate
    variant. Produces the identical ordering to the host version (same
    batch-per-round and id tie-breaking). ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    n = g.n
    src = np.concatenate([g.edges[:, 0], g.n_u + g.edges[:, 1]])
    dst = np.concatenate([g.n_u + g.edges[:, 1], g.edges[:, 0]])
    deg = torch.as_tensor(
        np.bincount(src, minlength=n).astype(np.int32), device=dev
    )
    src_d = torch.as_tensor(src, dtype=torch.int64, device=dev)
    dst_d = torch.as_tensor(dst, dtype=torch.int64, device=dev)

    def logkey(d):
        safe = torch.clamp(d, min=1)
        lk = torch.floor(torch.log2(safe.to(torch.float32))).to(torch.int32)
        return torch.where(d > 0, lk, torch.full_like(lk, -1))

    alive = torch.ones(n, dtype=torch.bool, device=dev)
    round_of = torch.zeros(n, dtype=torch.int32, device=dev)
    r = 0
    while bool(alive.any()):
        keys = torch.where(alive, logkey(deg), torch.full_like(deg, -2))
        peel = alive & (keys == keys.max())
        round_of[peel] = r
        alive &= ~peel
        # one parallel edge sweep: decrement deg of live dsts whose src
        # was peeled this round
        dec = peel[src_d] & alive[dst_d]
        deg -= torch.bincount(dst_d[dec], minlength=n).to(torch.int32)
        r += 1
    rounds = round_of.cpu().numpy()
    return np.lexsort((np.arange(n), rounds))


RANKINGS: Dict[str, Callable[[BipartiteGraph], np.ndarray]] = {
    "side": side_order,
    "degree": degree_order,
    "approx_degree": approx_degree_order,
    "complement_degeneracy": complement_degeneracy_order,
    "approx_complement_degeneracy": approx_complement_degeneracy_order,
    "approx_complement_degeneracy_device":
        approx_complement_degeneracy_order_device,
}


def make_order(g: BipartiteGraph, name: str, device=None) -> np.ndarray:
    """The ranking ``name`` of ``g``. ``device`` is used only by the
    device-side ranking (``None`` means CUDA); the others run on the
    host."""
    try:
        fn = RANKINGS[name]
    except KeyError:
        raise ValueError(
            f"unknown ranking {name!r}; options: {sorted(RANKINGS)}"
        ) from None
    if fn is approx_complement_degeneracy_order_device:
        return fn(g, device=device)
    return fn(g)


def wedges_processed(g: BipartiteGraph, order: np.ndarray) -> int:
    """Exact number of wedges retrieved under ``order`` (paper Table 3).

    For each directed edge (x1 -> y) with rank(y) > rank(x1), the wedges
    contributed are |{x2 in N(y) : rank(x2) > rank(x1)}|.
    """
    n = g.n
    rank = np.empty(n, dtype=np.int64)
    rank[np.asarray(order)] = np.arange(n)
    src = rank[np.concatenate([g.edges[:, 0], g.n_u + g.edges[:, 1]])]
    dst = rank[np.concatenate([g.n_u + g.edges[:, 1], g.edges[:, 0]])]
    perm = np.lexsort((dst, src))
    src, dst = src[perm], dst[perm]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=offsets[1:])
    # Vectorized: for each directed edge e=(x1,y) with y > x1, count
    # neighbors of y greater than x1. The CSR is globally lexsorted by
    # (src, dst), so every per-y upper_bound is one batched searchsorted
    # on the composite key src * n + dst (the `_batch_bounds`-style
    # cumsum/searchsorted trick — no per-edge Python loop).
    mask = dst > src
    ys = dst[mask]
    x1s = src[mask]
    comp = src * np.int64(n) + dst  # ascending by construction
    ub = np.searchsorted(comp, ys * np.int64(n) + x1s, side="right")
    return int((offsets[ys + 1] - ub).sum())
