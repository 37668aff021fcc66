"""Plain PyTorch reference for the tip decomposition.

Works from the edge arrays and the peeled side's butterfly counts, which
the caller computes with :mod:`counting`; imports nothing of the
program. Each round peels every live vertex whose count is the least
left, and gives it that count, or the highest count peeled before if
that is higher (the tip number: the largest ``k`` such that the vertex
lies in a ``k``-tip). A peeled vertex ``u`` takes ``C(c, 2)``
butterflies from each live vertex ``w`` of its side with which it
shares ``c`` neighbours; a butterfly has two vertices on the peeled
side, so none is taken twice. Tip numbers do not depend on how ties are
peeled, so the rounds need not match any engine's.

``dtype`` is the counts' type: ``torch.int64`` for the judge, narrower
for the control.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .counting import ranges

__all__ = ["Tips", "peel_side", "side_csr", "tip_numbers"]


class Tips(NamedTuple):
    numbers: torch.Tensor  # host int64, one per vertex of the side
    rounds: int


def peel_side(n_u: int, n_v: int, edges) -> int:
    """The side the engines peel by default: the one whose vertices end
    fewer wedges (wedges ending in U have their centre in V)."""
    edges = torch.as_tensor(edges, dtype=torch.int64)
    du = torch.bincount(edges[:, 0], minlength=n_u)
    dv = torch.bincount(edges[:, 1], minlength=n_v)
    w_u = int((dv * (dv - 1) // 2).sum())
    w_v = int((du * (du - 1) // 2).sum())
    return 0 if w_u <= w_v else 1


def side_csr(n: int, a: torch.Tensor, b: torch.Tensor):
    """Offsets and targets of ``a -> b`` arcs grouped by ``a``."""
    order = torch.argsort(a, stable=True)
    off = torch.zeros(n + 1, dtype=torch.int64, device=a.device)
    off[1:] = torch.cumsum(torch.bincount(a, minlength=n), 0)
    return off, b[order]


def tip_numbers(n_u: int, n_v: int, edges, side: int, counts, *,
                dtype=torch.int64, device="cpu") -> Tips:
    """Tip numbers of every vertex of ``side`` (0: U, 1: V), from its
    per-vertex butterfly ``counts``."""
    e = torch.as_tensor(edges, dtype=torch.int64, device=device)
    s, o = (e[:, 0], e[:, 1]) if side == 0 else (e[:, 1], e[:, 0])
    n_s, n_o = (n_u, n_v) if side == 0 else (n_v, n_u)
    s_off, s_nbr = side_csr(n_s, s, o)
    o_off, o_nbr = side_csr(n_o, o, s)
    s_deg, o_deg = s_off[1:] - s_off[:-1], o_off[1:] - o_off[:-1]
    cnt = torch.as_tensor(counts, device=device).to(dtype)
    big = torch.iinfo(dtype).max if not dtype.is_floating_point \
        else float("inf")
    live = torch.ones(n_s, dtype=torch.bool, device=device)
    numbers = torch.zeros(n_s, dtype=dtype, device=device)
    level = None
    rounds = 0
    left = n_s
    while left:
        low = torch.where(live, cnt, big).min()
        level = low if level is None else torch.maximum(level, low)
        peel = torch.nonzero(live & (cnt == low)).squeeze(1)
        numbers[peel] = level
        live[peel] = False
        left -= peel.numel()
        rounds += 1
        # wedges u - v - w from the peeled u to live w
        d1 = s_deg[peel]
        pos1 = ranges(s_off[peel], d1)
        u = torch.repeat_interleave(peel, d1, output_size=pos1.numel())
        v = s_nbr[pos1]
        d2 = o_deg[v]
        pos2 = ranges(o_off[v], d2)
        u = torch.repeat_interleave(u, d2, output_size=pos2.numel())
        w = o_nbr[pos2]
        keep = live[w]
        pair, c = torch.unique(u[keep] * n_s + w[keep], return_counts=True)
        cnt.index_add_(0, pair % n_s, -(c * (c - 1) // 2).to(dtype))
    out = numbers.to(torch.int64) if not dtype.is_floating_point \
        else torch.round(numbers).to(torch.int64)
    return Tips(out.cpu(), rounds)
