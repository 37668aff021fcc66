"""Dense numpy oracle for butterfly counts (tests + kernel validation).

O(n_u^2 n_v) — only for small graphs.
"""
from __future__ import annotations

import numpy as np

from .graph import BipartiteGraph

__all__ = [
    "adjacency",
    "global_count",
    "per_vertex_counts",
    "per_edge_counts",
]


def adjacency(g: BipartiteGraph) -> np.ndarray:
    a = np.zeros((g.n_u, g.n_v), dtype=np.int64)
    a[g.edges[:, 0], g.edges[:, 1]] = 1
    return a


def _choose2(x: np.ndarray) -> np.ndarray:
    return x * (x - 1) // 2


def _gram(a: np.ndarray) -> np.ndarray:
    """``a @ a.T`` of a 0/1 matrix. The product runs in float64 (BLAS)
    and is exact: every entry is a count of at most ``a.shape[1]``,
    far below 2^53."""
    af = a.astype(np.float64)
    return (af @ af.T).astype(np.int64)


def global_count(g: BipartiteGraph) -> int:
    a = adjacency(g)
    m = _gram(a)  # |N(u1) ∩ N(u2)|
    iu = np.triu_indices(g.n_u, k=1)
    return int(_choose2(m[iu]).sum())


def per_vertex_counts(g: BipartiteGraph) -> tuple[np.ndarray, np.ndarray]:
    a = adjacency(g)
    mu = _gram(a)
    np.fill_diagonal(mu, 0)
    per_u = _choose2(mu).sum(axis=1)
    mv = _gram(a.T)
    np.fill_diagonal(mv, 0)
    per_v = _choose2(mv).sum(axis=1)
    return per_u, per_v


def per_edge_counts(g: BipartiteGraph) -> np.ndarray:
    a = adjacency(g)
    mu = _gram(a)  # (n_u, n_u)
    out = np.zeros(g.m, dtype=np.int64)
    for i, (u, v) in enumerate(g.edges):
        nbrs = np.flatnonzero(a[:, v])
        nbrs = nbrs[nbrs != u]
        out[i] = int((mu[u, nbrs] - 1).sum())
    return out
