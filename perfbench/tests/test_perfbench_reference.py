"""The plain reference against brute force on small graphs."""
import itertools
import math

import numpy as np
import pytest
import torch

from perfbench.generator import cell_graph
from perfbench.reference.counting import count_all, wedge_total
from perfbench.reference.tips import peel_side, tip_numbers


def _graphs():
    rng = np.random.default_rng(0)
    out = []
    for n_u, n_v, m in [(8, 7, 30), (20, 15, 120), (40, 30, 400)]:
        key = rng.choice(n_u * n_v, size=m, replace=False)
        out.append((n_u, n_v, np.stack([key // n_v, key % n_v], 1)))
    out.append(cell_graph({"SCALE": 6, "edgefactor": 8, "initiator": {
        "A": 0.57, "B": 0.19, "C": 0.19}}, 7))
    out.append((3, 4, np.array([[0, 0], [0, 1], [1, 0], [1, 1], [2, 3]])))
    return out


def brute(n_u, n_v, e):
    a = np.zeros((n_u, n_v), dtype=np.int64)
    a[e[:, 0], e[:, 1]] = 1
    cu = a @ a.T  # common neighbours of two U vertices
    cv = a.T @ a
    c2 = lambda x: x * (x - 1) // 2  # noqa: E731
    np.fill_diagonal(cu, 0)
    np.fill_diagonal(cv, 0)
    per_u = c2(cu).sum(1)
    per_v = c2(cv).sum(1)
    total = int(c2(cu).sum() // 2)
    per_edge = np.array([sum(cu[u, w] - 1 for w in np.nonzero(a[:, v])[0]
                             if w != u) for u, v in e], dtype=np.int64)
    return total, per_u, per_v, per_edge


@pytest.mark.parametrize("g", _graphs(), ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("block", [1 << 25, 7])
def test_counts_equal_brute_force(g, block):
    n_u, n_v, e = g
    total, per_u, per_v, per_edge = brute(n_u, n_v, e)
    c = count_all(n_u, n_v, e, block=block)
    assert c.total == total
    assert np.array_equal(c.per_u.numpy(), per_u)
    assert np.array_equal(c.per_v.numpy(), per_v)
    assert np.array_equal(c.per_edge.numpy(), per_edge)
    assert 4 * total == int(c.per_edge.sum()) == int(per_u.sum() +
                                                     per_v.sum())


@pytest.mark.parametrize("g", _graphs(), ids=lambda g: f"{g[0]}x{g[1]}")
def test_wedge_total_is_the_degree_orders(g):
    n_u, n_v, e = g
    n = n_u + n_v
    adj = [set() for _ in range(n)]
    for u, v in e:
        adj[u].add(n_u + v)
        adj[n_u + v].add(u)
    deg = np.array([len(s) for s in adj])
    rank = np.empty(n, dtype=np.int64)
    rank[np.argsort(-deg, kind="stable")] = np.arange(n)
    w = sum(1 for x1 in range(n) for y in adj[x1] if rank[y] > rank[x1]
            for x2 in adj[y] if rank[x2] > rank[x1])
    assert wedge_total(n_u, n_v, torch.as_tensor(e)) == w


def brute_tips(n_u, n_v, e, side):
    """One vertex at a time, counts recomputed from scratch."""
    a = np.zeros((n_u, n_v), dtype=np.int64)
    a[e[:, 0], e[:, 1]] = 1
    if side == 1:
        a = a.T
    live = list(range(a.shape[0]))
    out = np.zeros(a.shape[0], dtype=np.int64)
    level = 0
    while live:
        sub = a[live]
        c = sub @ sub.T
        np.fill_diagonal(c, 0)
        cnt = (c * (c - 1) // 2).sum(1)
        i = int(np.argmin(cnt))
        level = max(level, int(cnt[i]))
        out[live[i]] = level
        live.pop(i)
    return out


@pytest.mark.parametrize("g", _graphs(), ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("side", [0, 1])
def test_tip_numbers_equal_brute_force(g, side):
    n_u, n_v, e = g
    c = count_all(n_u, n_v, e)
    t = tip_numbers(n_u, n_v, e, side, c.per_u if side == 0 else c.per_v)
    assert np.array_equal(t.numbers.numpy(), brute_tips(n_u, n_v, e, side))


def test_peel_side_is_fewer_wedge_endpoints():
    e = np.array([[0, 0], [1, 0], [2, 0], [0, 1]])
    # U ends 3 + 0 wedges (centres in V), V ends 1 (centre u0)
    assert peel_side(3, 2, e) == 1


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_narrow_counts_differ_where_they_must(dtype):
    """K(64, 2000): 4.03e9 butterflies, past int32; an odd total past
    2**24 for float32 comes from K(102, 103)."""
    n_u, n_v = (64, 2000) if dtype == torch.int32 else (102, 103)
    e = np.array(list(itertools.product(range(n_u), range(n_v))))
    exact = math.comb(n_u, 2) * math.comb(n_v, 2)
    assert count_all(n_u, n_v, e).total == exact
    assert count_all(n_u, n_v, e, dtype=dtype).total != exact
