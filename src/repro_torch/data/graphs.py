"""Bipartite graph sources for the butterfly engine.

The same numpy ``Generator`` calls as the reference package's
generators, so a seed gives the identical graph in both.

KONECT datasets (paper §6) are not available offline; the benchmark
graphs are power-law bipartite generators calibrated per KONECT-like
statistics (heavy-tailed degrees on both sides), plus a parser for the
KONECT ``out.*`` TSV format for running against real data when present.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.graph import BipartiteGraph

__all__ = ["random_bipartite", "powerlaw_bipartite", "load_konect"]


def random_bipartite(n_u: int, n_v: int, m: int, seed: int = 0) -> BipartiteGraph:
    rng = np.random.default_rng(seed)
    e = np.stack(
        [rng.integers(0, n_u, m), rng.integers(0, n_v, m)], axis=1
    )
    return BipartiteGraph(n_u, n_v, e)


def powerlaw_bipartite(
    n_u: int,
    n_v: int,
    m: int,
    alpha_u: float = 2.1,
    alpha_v: float = 2.1,
    seed: int = 0,
) -> BipartiteGraph:
    """Chung-Lu style bipartite graph with Zipf expected degrees.

    Real KONECT affiliation networks have heavy-tailed degrees on both
    sides — the regime where degree-style rankings beat side order
    (paper Table 3).
    """
    rng = np.random.default_rng(seed)
    wu = (np.arange(1, n_u + 1, dtype=np.float64)) ** (-1.0 / (alpha_u - 1))
    wv = (np.arange(1, n_v + 1, dtype=np.float64)) ** (-1.0 / (alpha_v - 1))
    pu = wu / wu.sum()
    pv = wv / wv.sum()
    us = rng.choice(n_u, size=m, p=pu)
    vs = rng.choice(n_v, size=m, p=pv)
    # permute ids so degree is uncorrelated with id (locality realism)
    perm_u = rng.permutation(n_u)
    perm_v = rng.permutation(n_v)
    e = np.stack([perm_u[us], perm_v[vs]], axis=1)
    return BipartiteGraph(n_u, n_v, e)


def load_konect(path: str, limit: Optional[int] = None) -> BipartiteGraph:
    """Parse a KONECT ``out.<name>`` bipartite edge list."""
    us, vs = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("%"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            us.append(int(parts[0]) - 1)
            vs.append(int(parts[1]) - 1)
            if limit and len(us) >= limit:
                break
    us = np.asarray(us)
    vs = np.asarray(vs)
    e = np.stack([us, vs], axis=1)
    return BipartiteGraph(int(us.max()) + 1, int(vs.max()) + 1, e)
