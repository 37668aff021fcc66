"""The port's graph layer against the reference package: seeded
generators give the same graphs, every ranking gives the same order,
preprocessing gives the same padded CSR arrays (on seeded generators,
the benchmark's Graph 500 graphs, repeated edges kept under
``assume_unique``, one edge, isolated vertices) and the same content
hash, and malformed input, a bad order included, raises the same typed
errors."""
import dataclasses
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np  # noqa: E402

from repro.core import graph as ref_graph  # noqa: E402
from repro.core import ranking as ref_ranking  # noqa: E402
from repro.data import graphs as ref_graphs  # noqa: E402
from repro_torch.core import graph, ranking  # noqa: E402
from repro_torch.core.resilience import (  # noqa: E402
    AccumulatorOverflowRisk,
    GraphValidationError,
)
from repro_torch.data import graphs  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))  # the benchmark's generator
from perfbench.generator import cell_graph  # noqa: E402

GENERATORS = [
    ("random_bipartite", (50, 40, 400), {"seed": 3}),
    ("powerlaw_bipartite", (300, 200, 2000), {"seed": 5}),
    ("powerlaw_bipartite", (80, 500, 900), {"seed": 0, "alpha_u": 2.5}),
]


def _pair(name, args, kw):
    return (getattr(ref_graphs, name)(*args, **kw),
            getattr(graphs, name)(*args, **kw))


@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generators_match_reference(name, args, kw):
    r, p = _pair(name, args, kw)
    assert (p.n_u, p.n_v) == (r.n_u, r.n_v)
    assert np.array_equal(p.edges, r.edges) and p.edges.dtype == r.edges.dtype
    assert p.content_hash() == r.content_hash()
    assert p.wedge_totals() == r.wedge_totals()
    assert p.accumulator_preflight() == r.accumulator_preflight()


def _graph500(scale, seed):
    """The benchmark's Graph 500 graph (``perfbench/generator.py``) at a
    small SCALE."""
    n_u, n_v, e = cell_graph({"SCALE": scale, "edgefactor": 16, "initiator":
                              {"A": 0.57, "B": 0.19, "C": 0.19}}, seed)
    return ref_graph.BipartiteGraph(n_u, n_v, e), graph.BipartiteGraph(
        n_u, n_v, e)


def _both(n_u, n_v, edges, **kw):
    e = np.asarray(edges, dtype=np.int64)
    return (ref_graph.BipartiteGraph(n_u, n_v, e, **kw),
            graph.BipartiteGraph(n_u, n_v, e, **kw))


def _repeated():
    """Repeated pairs, kept by ``assume_unique``: a stable sort keeps
    their ``undirected_id`` in the reference's order."""
    rng = np.random.default_rng(9)
    e = np.stack([rng.integers(0, 6, 60), rng.integers(0, 5, 60)], 1)
    return _both(6, 5, np.concatenate([e, e[::3]]),
                 on_duplicate="assume_unique")


def _isolated():
    """Edges among the first few vertices only; the rest isolated."""
    rng = np.random.default_rng(5)
    e = np.stack([rng.integers(0, 6, 40), rng.integers(0, 5, 40)], 1)
    return _both(21, 17, e)


# graph cases beyond GENERATORS (whose cases keep their indices)
GRAPHS = {
    "graph500-s7": lambda: _graph500(7, 1),
    "graph500-s8": lambda: _graph500(8, 2),
    "graph500-s9": lambda: _graph500(9, 3),
    "repeated-assume-unique": _repeated,
    "one-edge": lambda: _both(1, 1, [[0, 0]]),
    "isolated": _isolated,
}


@pytest.mark.parametrize("order", sorted(ref_ranking.RANKINGS))
@pytest.mark.parametrize("gen", [*range(len(GENERATORS)), *GRAPHS])
def test_rankings_and_preprocess_match_reference(order, gen):
    r, p = GRAPHS[gen]() if gen in GRAPHS else _pair(*GENERATORS[gen])
    ro = ref_ranking.make_order(r, order)
    po = ranking.make_order(p, order, device="cpu")
    assert np.array_equal(po, ro)
    assert ranking.wedges_processed(p, po) == ref_ranking.wedges_processed(r, ro)
    rrg = ref_graph.preprocess(r, ro, order_name=order)
    prg = graph.preprocess(p, po, order_name=order)
    for f in dataclasses.fields(rrg):
        a, b = getattr(prg, f.name), getattr(rrg, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("bad", ["short", "out-of-range", "duplicate"])
def test_preprocess_rejects_bad_order_like_reference(bad):
    """A bad order raises the reference's error, with its message, and
    before any device work: on a host without a card, ``device="cuda"``
    still gives the validation error."""
    r, p = _pair(*GENERATORS[0])
    order = ref_ranking.make_order(r, "degree")
    order = {"short": order[:-1],
             "out-of-range": np.where(order == 0, r.n, order),
             "duplicate": np.where(order == 0, 1, order)}[bad]
    with pytest.raises(ref_graph.GraphValidationError) as want:
        ref_graph.preprocess(r, order)
    for device in ("cpu", "cuda"):
        with pytest.raises(GraphValidationError) as got:
            graph.preprocess(p, order, device=device)
        assert str(got.value) == str(want.value)


def test_rankings_registry_matches_reference():
    assert sorted(ranking.RANKINGS) == sorted(ref_ranking.RANKINGS)


def test_ranked_graph_from_arrays_round_trip():
    r, _ = _pair(*GENERATORS[1])
    rrg = ref_graph.preprocess(r, ref_ranking.make_order(r, "degree"),
                               order_name="degree")
    prg = graph.RankedGraph.from_arrays(**vars(rrg))
    for f in dataclasses.fields(rrg):
        a, b = getattr(prg, f.name), getattr(rrg, f.name)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b
    bad = dict(vars(rrg))
    bad["offsets"] = bad["offsets"][:-1]
    with pytest.raises(GraphValidationError, match="offsets"):
        graph.RankedGraph.from_arrays(**bad)


@pytest.mark.parametrize("edges,kw", [
    (np.zeros((3, 3)), {}),
    (np.array([[0, 9]]), {}),
    (np.array([[0.5, 1.0]]), {}),
    (np.array([[0, 1], [0, 1]]), {"on_duplicate": "raise"}),
])
def test_validation_errors_match_reference(edges, kw):
    with pytest.raises(ref_graph.GraphValidationError):
        ref_graph.BipartiteGraph(4, 4, edges, **kw)
    with pytest.raises(GraphValidationError):
        graph.BipartiteGraph(4, 4, edges, **kw)


def test_preflight_raises_like_reference():
    """Two hubs of degree k: min(w_u, w_v) ~ C(k, 2), so the worst-case
    bound C(w, 2) passes 2^63 at k = 100,000 with only 2k edges."""
    k = 100_000
    ids = np.arange(k)
    e = np.concatenate([np.stack([np.zeros(k, np.int64), ids], 1),
                        np.stack([ids, np.zeros(k, np.int64)], 1)])
    r = ref_graph.BipartiteGraph(k, k, e)
    p = graph.BipartiteGraph(k, k, e)
    assert p.accumulator_preflight(budget_bits=80) == \
        r.accumulator_preflight(budget_bits=80) > 2**63
    with pytest.raises(ref_graph.AccumulatorOverflowRisk):
        r.accumulator_preflight()
    with pytest.raises(AccumulatorOverflowRisk):
        p.accumulator_preflight()


def test_smoke_graph_content_hash_is_pinned():
    """The chip smoke test's full-size graph, generated by the port,
    hashes to the value pinned from the reference package."""
    with open(os.path.join(HERE, "data", "torch_smoke_reference.json")) as f:
        pinned = json.load(f)
    gen = pinned["generator"]
    g = graphs.powerlaw_bipartite(gen["n_u"], gen["n_v"], gen["m"],
                                  seed=gen["seed"])
    assert g.m == pinned["m"]
    assert list(g.wedge_totals()) == pinned["wedge_totals"]
    assert g.content_hash() == pinned["content_hash"]
