"""The frozen generator: the Graph 500 Kronecker law, distinct edges in
first-draw order, the same graph for the same seed and a new one for
another."""
import itertools

import numpy as np
import pytest

from perfbench import generator
from perfbench.harness import load_json

A, B, C = 0.57, 0.19, 0.19
D = 1 - A - B - C


def test_one_level_draws_the_initiators_quadrants():
    """SCALE 1: a tuple is one quadrant, and the one permutation of two
    vertices either keeps the quadrants or swaps A with D and B with C."""
    t = generator.kronecker_tuples(1, 100_000, 2**31 + 5, A, B, C)
    share = {q: np.mean((t[:, 0] == q[0]) & (t[:, 1] == q[1]))
             for q in itertools.product((0, 1), repeat=2)}
    diag = sorted([share[0, 0], share[1, 1]])
    assert diag == pytest.approx([D, A], abs=0.005)
    assert [share[0, 1], share[1, 0]] == pytest.approx([B, C], abs=0.005)


def test_row_and_column_degrees_follow_the_law():
    """SCALE 3: a row's share of the tuples is the product over its bits
    of ``A + B`` (bit 0) or ``C + D`` (bit 1); a column's of ``A + C``
    or ``B + D``. The permutation only reorders them."""
    scale = 3
    t = generator.kronecker_tuples(scale, 40_000, 11, A, B, C)
    bits = np.array([[(r >> k) & 1 for k in range(scale)]
                     for r in range(1 << scale)])
    rows = np.prod(np.where(bits == 0, A + B, C + D), axis=1)
    cols = np.prod(np.where(bits == 0, A + C, B + D), axis=1)
    n = t.shape[0]
    for side, want in ((0, rows), (1, cols)):
        got = np.bincount(t[:, side], minlength=1 << scale) / n
        assert np.sort(got) == pytest.approx(np.sort(want), abs=0.003)


def test_tuples_are_the_specifications_count():
    t = generator.kronecker_tuples(6, 16, 3, A, B, C)
    assert t.shape == (16 << 6, 2)
    assert t.min() >= 0 and t.max() < 1 << 6


def test_edges_are_distinct_in_first_draw_order():
    t = np.array([[1, 2], [0, 0], [1, 2], [3, 1], [0, 0], [2, 2]])
    e = generator.bipartite_edges(t, 4)
    assert e.tolist() == [[1, 2], [0, 0], [3, 1], [2, 2]]


CFG = {"SCALE": 10, "edgefactor": 16,
       "initiator": {"A": A, "B": B, "C": C, "D": D}}


def test_seed_gives_the_graph():
    n_u, n_v, a = generator.cell_graph(CFG, 2**31 + 11)
    _, _, b = generator.cell_graph(CFG, 2**31 + 11)
    _, _, c = generator.cell_graph(CFG, 5)
    assert (n_u, n_v) == (1024, 1024)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    key = lambda e: set((e[:, 0] * 1024 + e[:, 1]).tolist())  # noqa: E731
    assert key(a) != key(c)  # a new structure, not a relabeling
    # the same law: edge counts within a few per cent of each other
    assert abs(len(a) - len(c)) < 0.03 * len(a)


@pytest.mark.parametrize("name", ["graph500-s14"])
def test_configuration_graph(name):
    cfg = load_json("configs", name)
    n_u, n_v, e = generator.cell_graph(cfg, 2**31 + 1)
    n = 1 << cfg["SCALE"]
    assert (n_u, n_v) == (n, n)
    assert np.unique(e[:, 0] * n + e[:, 1]).size == len(e)
    assert e.min() >= 0 and e.max() < n
    # repeats collapse: fewer edges than tuples, most of them kept
    assert 0.8 * cfg["edgefactor"] * n < len(e) < cfg["edgefactor"] * n


def _law_edges(scale, edgefactor):
    """Expected distinct edges under the law: each cell of the matrix is
    named by some tuple with probability ``1 - (1 - p) ** M``, ``p`` the
    product of its quadrants' probabilities, cells grouped by how many
    levels fall in each quadrant."""
    from math import factorial as f

    m, out = edgefactor << scale, 0.0
    for a in range(scale + 1):
        for b in range(scale + 1 - a):
            for c in range(scale + 1 - a - b):
                d = scale - a - b - c
                cells = f(scale) // (f(a) * f(b) * f(c) * f(d))
                out += cells * (1 - (1 - A**a * B**b * C**c * D**d) ** m)
    return out


def _law_top_degree(scale, edgefactor):
    """Expected distinct columns of the row whose bits are all 0."""
    from math import comb

    m, a = edgefactor << scale, A / (A + B)
    p_row = (A + B) ** scale
    return sum(comb(scale, k) * (1 - (1 - p_row * a ** (scale - k)
                                      * (1 - a) ** k) ** m)
               for k in range(scale + 1))


def test_edge_count_and_top_degree_match_the_law():
    """SCALE 10 over five seeds: distinct edges within 1% of the law's
    expectation, the largest row degree within 10%."""
    got = [generator.cell_graph(CFG, s)[2] for s in range(5)]
    edges = np.mean([len(e) for e in got])
    top = np.mean([np.bincount(e[:, 0]).max() for e in got])
    assert edges == pytest.approx(_law_edges(10, 16), rel=0.01)
    assert top == pytest.approx(_law_top_degree(10, 16), rel=0.10)
