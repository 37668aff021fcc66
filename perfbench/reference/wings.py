"""Plain PyTorch reference for the wing decomposition.

Works from the edge arrays and the per-edge butterfly counts, which the
caller computes with :mod:`counting`; imports nothing of the program.
Each round takes the level: the least count left, or the highest level
before if that is higher. It peels every live edge whose count is at
most the level and gives it the level (the wing number: the largest
``k`` such that the edge lies in a ``k``-wing). An edge whose count has
fallen below the level lies in no wing above it, so it is peeled in the
round that finds it there rather than in one round of its own. Every
butterfly whose four edges are all live at the start of the round and
one or more of them peeled in it is taken away once: each of its edges
that stays live loses 1. Wing numbers do not depend on how ties are
peeled, so the rounds need not match any engine's.

A round finds those butterflies from each peeled edge ``a = (u1, v1)``:
every ``u2`` of ``N(v1)`` and every ``v2`` of ``N(u1)`` whose edge
``(u2, v2)`` exists, ``deg(u1) * deg(v1)`` candidates in all. A
butterfly with several peeled edges is taken from the one with the
lowest edge id alone. The candidates are made in blocks of about
``block`` so the peak stays bounded.

``dtype`` is the counts' type: ``torch.int64`` for the judge, narrower
for a control.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .counting import ranges

__all__ = ["Wings", "wing_numbers"]


class Wings(NamedTuple):
    numbers: torch.Tensor  # host int64, one per edge, in the input order
    rounds: int


def _edge_csr(n: int, a: torch.Tensor, b: torch.Tensor):
    """``a -> b`` arcs grouped by ``a``: offsets, targets and the edge
    id of each arc."""
    order = torch.argsort(a, stable=True)
    off = torch.zeros(n + 1, dtype=torch.int64, device=a.device)
    off[1:] = torch.cumsum(torch.bincount(a, minlength=n), 0)
    return off, b[order], order


class _Adjacency(NamedTuple):
    eu: torch.Tensor  # U end of each edge
    ev: torch.Tensor  # V end of each edge
    u_off: torch.Tensor  # u -> (v, edge id)
    u_nbr: torch.Tensor
    u_eid: torch.Tensor
    v_off: torch.Tensor  # v -> (u, edge id)
    v_nbr: torch.Tensor
    v_eid: torch.Tensor
    key: torch.Tensor  # u * n_v + v of every edge, sorted
    key_eid: torch.Tensor  # the edge id of each key
    n_v: int


def wing_numbers(n_u: int, n_v: int, edges, counts, *, dtype=torch.int64,
                 device="cpu", block: int = 1 << 24) -> Wings:
    """Wing numbers of every edge of the simple bipartite graph
    ``edges`` ((m, 2), U id then V id, no duplicates) from its per-edge
    butterfly ``counts``."""
    e = torch.as_tensor(edges, dtype=torch.int64, device=device)
    m = e.shape[0]
    eu, ev = e[:, 0], e[:, 1]
    key, key_eid = torch.sort(eu * n_v + ev)
    g = _Adjacency(eu, ev, *_edge_csr(n_u, eu, ev), *_edge_csr(n_v, ev, eu),
                   key, key_eid, n_v)
    work = (g.u_off[eu + 1] - g.u_off[eu]) * (g.v_off[ev + 1] - g.v_off[ev])
    # a copy: the caller's counts stay as they are
    cnt = torch.as_tensor(counts).to(device=device, dtype=dtype, copy=True)
    big = torch.iinfo(dtype).max if not dtype.is_floating_point \
        else float("inf")
    live = torch.ones(m, dtype=torch.bool, device=device)
    numbers = torch.zeros(m, dtype=dtype, device=device)
    level = None
    rounds = 0
    left = m
    while left:
        low = torch.where(live, cnt, big).min()
        level = low if level is None else torch.maximum(level, low)
        peeled = live & (cnt <= level)
        peel = torch.nonzero(peeled).squeeze(1)
        numbers[peel] = level
        left -= peel.numel()
        rounds += 1
        for a in _blocks(peel, work[peel], block):
            hit = _taken(g, a, live, peeled)
            cnt.index_add_(0, hit, -torch.ones_like(hit, dtype=dtype))
        live &= ~peeled
    out = numbers.to(torch.int64) if not dtype.is_floating_point \
        else torch.round(numbers).to(torch.int64)
    return Wings(out.cpu(), rounds)


def _taken(g: _Adjacency, a: torch.Tensor, live: torch.Tensor,
           peeled: torch.Tensor) -> torch.Tensor:
    """The other three edges, concatenated, of every butterfly this
    round takes away from the peeled edges ``a``: each ``u1 v1 u2 v2``
    with ``b = (u2, v1)``, ``c = (u1, v2)`` and ``d = (u2, v2)``."""
    u1, v1 = g.eu[a], g.ev[a]
    # u2 over N(v1)
    n1 = g.v_off[v1 + 1] - g.v_off[v1]
    p1 = ranges(g.v_off[v1], n1)
    i1 = torch.repeat_interleave(torch.arange(a.numel(), device=a.device),
                                 n1, output_size=p1.numel())
    u2, b = g.v_nbr[p1], g.v_eid[p1]
    # then v2 over N(u1)
    n2 = g.u_off[u1[i1] + 1] - g.u_off[u1[i1]]
    p2 = ranges(g.u_off[u1[i1]], n2)
    i2 = torch.repeat_interleave(torch.arange(i1.numel(), device=a.device),
                                 n2, output_size=p2.numel())
    i, u2, b = i1[i2], u2[i2], b[i2]
    v2, c = g.u_nbr[p2], g.u_eid[p2]
    want = u2 * g.n_v + v2
    p = torch.searchsorted(g.key, want).clamp(max=g.key.numel() - 1)
    d = g.key_eid[p]
    ok = (u2 != u1[i]) & (v2 != v1[i]) & (g.key[p] == want)
    ok &= live[b] & live[c] & live[d]
    # a butterfly with several peeled edges is taken from the lowest
    a2 = a[i]
    for x in (b, c, d):
        ok &= ~(peeled[x] & (x < a2))
    return torch.cat([b, c, d])[ok.repeat(3)]


def _blocks(ids: torch.Tensor, work: torch.Tensor, block: int):
    """Runs of ``ids`` whose summed ``work`` is about ``block`` (a run
    holds one id at least)."""
    if ids.numel() == 0:
        return
    done = torch.cumsum(work, 0)
    cuts = torch.searchsorted(
        done, torch.arange(block, int(done[-1]) + block, block,
                           device=ids.device), right=True)
    lo = 0
    for hi in torch.unique(cuts.clamp(min=1, max=ids.numel())).tolist():
        if hi > lo:
            yield ids[lo:hi]
            lo = hi
    if lo < ids.numel():
        yield ids[lo:]
