"""Frozen graph generator of the benchmark: the Graph 500 Kronecker
generator, read as a bipartite graph.

The Graph 500 specification (graph500.org, section "Graph Generation")
defines its graphs by a Kronecker generator and gives it as a short
reference program: ``N = 2**SCALE`` vertices and ``M = edgefactor * N``
edge tuples; each tuple picks one quadrant of the adjacency matrix per
level, ``SCALE`` levels, with the initiator probabilities ``A``, ``B``,
``C`` and ``D = 1 - A - B - C``; the vertex numbers are then permuted
by one random permutation and the tuples shuffled. This is that program
in numpy, draw for draw in its order (row bits against ``A + B``, then
column bits against ``A / (A + B)`` or ``C / (C + D)``).

Read as a bipartite graph: a tuple ``(i, j)`` is the edge from row
vertex ``u_i`` to column vertex ``v_j``, ``|U| = |V| = N``; tuples that
repeat collapse into one edge (the specification keeps them in its list
and its kernels ignore them) and keep the place of their first draw.
Vertices that no tuple names stay in the graph with degree 0.

The structure comes from the run's ``--seed``: every seed draws a new
graph of the same law, so the work differs between seeds only by the
law's own scatter (within 0.3% in edges, wedges and butterflies, 1-2% in
peeling rounds; PERF.md, section 4). Nothing here imports the program:
the arrays go to the program and to the reference alike.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["kronecker_tuples", "bipartite_edges", "cell_graph"]


def kronecker_tuples(scale: int, edgefactor: int, seed: int, a: float,
                     b: float, c: float) -> np.ndarray:
    """The specification's ``M`` edge tuples, ``(M, 2)`` int64, with
    repeats, in its order: quadrant bits level by level, then the
    vertex permutation, then the shuffle of the tuples."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    n = 1 << scale
    m = edgefactor * n
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ij = np.zeros((2, m), dtype=np.int64)
    for level in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > np.where(ii, c_norm, a_norm)
        ij[0] += ii.astype(np.int64) << level
        ij[1] += jj.astype(np.int64) << level
    ij = rng.permutation(n)[ij]
    ij = ij[:, rng.permutation(m)]
    return np.ascontiguousarray(ij.T)


def bipartite_edges(tuples: np.ndarray, n: int) -> np.ndarray:
    """Distinct ``(u, v)`` edges of the tuples, each at its first draw."""
    key = tuples[:, 0] * n + tuples[:, 1]
    _, first = np.unique(key, return_index=True)
    first.sort()
    return tuples[first]


def cell_graph(cfg: dict, seed: int) -> Tuple[int, int, np.ndarray]:
    """``(n_u, n_v, edges)`` of a configuration file and a run's seed."""
    s, ef = int(cfg["SCALE"]), int(cfg["edgefactor"])
    p = cfg["initiator"]
    n = 1 << s
    t = kronecker_tuples(s, ef, seed, p["A"], p["B"], p["C"])
    return n, n, bipartite_edges(t, n)
