"""The one wedge-count pass of a count: the per-slot wedge counts that
plan and run a count come from the prepared graph's device pass
(``wedges.prepare``) and equal the numpy ``host_wedge_counts`` element
for element, padding slots included, and its per-vertex prefix equals
the ``np.add.at`` sums; ``count_butterflies`` makes that pass once
(``report.phases["count.wedge_counts"].n == 1``) and never calls
``host_wedge_counts``, on every engine, mode, forced descent, shrink
retry and batch aggregation, with the counts and the report's plan
summary of the host-planned path. The pass of a count runs on the graph
that the count's CSR build left on its device
(``wedges.preprocess_device``; a count calls no ``device_graph``), equal
tensor for tensor to an upload of the host ``RankedGraph``, which the
same build gives array for array on the CPU and on the card; only
``count_from_ranked`` called alone uploads, once."""
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import BipartiteGraph, count_butterflies  # noqa: E402
from repro_torch.core import count as count_mod  # noqa: E402
from repro_torch.core import oracle, pipeline, resilience, spans  # noqa: E402
from repro_torch.core import wedges  # noqa: E402
from repro_torch.core.graph import preprocess  # noqa: E402
from repro_torch.core.ranking import make_order  # noqa: E402
from repro_torch.core.wedges import (  # noqa: E402
    device_graph,
    host_wedge_counts,
    preprocess_device,
)
from repro_torch.testing import faults  # noqa: E402


def _rand(nu, nv, m, seed):
    rng = np.random.default_rng(seed)
    e = np.stack([rng.integers(0, nu, m), rng.integers(0, nv, m)], 1)
    return BipartiteGraph(nu, nv, e)


def _isolated():
    """Edges among the first few vertices only; the rest isolated."""
    rng = np.random.default_rng(5)
    e = np.stack([rng.integers(0, 6, 40), rng.integers(0, 5, 40)], 1)
    return BipartiteGraph(21, 17, e)


def _hub():
    """One vertex adjacent to every vertex of the other side, and a few
    other edges."""
    rng = np.random.default_rng(11)
    hub = np.stack([np.zeros(40, np.int64), np.arange(40)], 1)
    rest = np.stack([rng.integers(1, 12, 30), rng.integers(0, 40, 30)], 1)
    return BipartiteGraph(12, 40, np.concatenate([hub, rest]))


GRAPHS = {
    "rand0": lambda: _rand(30, 25, 160, 0),
    "rand1": lambda: _rand(40, 12, 200, 1),
    "rand2": lambda: _rand(9, 33, 120, 2),
    "isolated": _isolated,
    "hub": _hub,
    "one_edge": lambda: BipartiteGraph(1, 1, np.array([[0, 0]])),
}


def _ranked(g, order, pad_vertices=8):
    return preprocess(g, make_order(g, order, device="cpu"),
                      order_name=order, pad_vertices=pad_vertices)


def _check_pass(rg, direction, device):
    pg = wedges.prepare(rg, device_graph(rg, device), direction)
    want = host_wedge_counts(rg, direction)
    assert pg.rg is rg and pg.direction == direction
    assert pg.host.dtype == np.int64 and pg.cnt.dtype == torch.int64
    assert pg.cnt.device.type == torch.device(device).type
    assert np.array_equal(pg.host, want)
    assert np.array_equal(pg.cnt.cpu().numpy(), want)
    assert not pg.host[2 * rg.m:].any()  # padding slots hold 0
    # the per-vertex prefix equals the per-vertex sums by iterating
    # endpoint, padding vertices included
    wv = np.zeros(rg.n_pad, dtype=np.int64)
    np.add.at(wv, rg.edge_src[:2 * rg.m].astype(np.int64),
              want[:2 * rg.m])
    voff = wedges.wedge_prefix(rg.offsets, pg.host)[1]
    assert voff.dtype == np.int64 and voff.shape == (rg.n_pad + 1,)
    assert np.array_equal(voff, np.concatenate([[0], np.cumsum(wv)]))
    return pg


@pytest.mark.parametrize("direction", ["low", "high"])
@pytest.mark.parametrize("order", ["degree", "side"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pass_equals_host_wedge_counts(name, order, direction):
    # a long vertex padding tail: 32-vertex padding
    rg = _ranked(GRAPHS[name](), order, pad_vertices=32)
    assert rg.n_pad > rg.n and rg.e_pad >= 2 * rg.m
    _check_pass(rg, direction, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["low", "high"])
def test_pass_equals_host_wedge_counts_on_card(direction):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in sorted(GRAPHS):
        rg = _ranked(GRAPHS[name](), "degree", pad_vertices=32)
        _check_pass(rg, direction, "cuda")
    g = _rand(3000, 2500, 60_000, 7)
    _check_pass(_ranked(g, "degree"), direction, "cuda")


def _no_host_pass(monkeypatch):
    """Every module of the port that holds ``host_wedge_counts`` gets one
    that raises."""
    def boom(*_a, **_k):
        raise AssertionError("host_wedge_counts called on the count path")

    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch") and hasattr(mod,
                                                      "host_wedge_counts"):
            monkeypatch.setattr(mod, "host_wedge_counts", boom)


def _oracle(g):
    per_u, per_v = oracle.per_vertex_counts(g)
    return (oracle.global_count(g), per_u, per_v, oracle.per_edge_counts(g))


def _assert_counts(r, g, mode):
    total, per_u, per_v, per_edge = _oracle(g)
    assert int(r.total) == total
    if mode == "all":
        assert np.array_equal(r.per_u, per_u)
        assert np.array_equal(r.per_v, per_v)
        assert np.array_equal(r.per_edge, per_edge)


MAX_CHUNK = 64  # several tiles on every engine, so every engine plans

# (engine, mode, aggregation, fault, the rungs the ladder runs)
CASES = {
    **{f"{e}-{m}": (e, m, "sort", None, [e])
       for e in ("fused_cuda", "fused", "cuda", "torch")
       for m in ("global", "all")},
    "descent-global": ("fused_cuda", "global", "sort",
                       ("capacity_overflow", None), ["fused_cuda", "fused"]),
    "descent-all": ("fused_cuda", "all", "hash",
                    ("capacity_overflow", None), ["fused_cuda", "fused"]),
    "shrink-global": ("fused_cuda", "global", "sort", ("oom", 1),
                      ["fused_cuda"]),
    "shrink-all": ("fused", "all", "auto", ("oom", 1), ["fused"]),
    "batch_wa-global": ("torch", "global", "batch_wa", None, ["torch"]),
    "batch_wa-all": ("torch", "all", "batch_wa", None, ["torch"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_makes_one_pass_and_no_host_pass(case, monkeypatch):
    engine, mode, aggregation, fault, rungs = CASES[case]
    g = _rand(30, 25, 160, 3)
    # the host-planned report pass: the plan that the report records
    rg = _ranked(g, "degree")
    want_plan = None
    if aggregation != "batch_wa":
        want_plan = pipeline.plan_count(
            rg, mode=mode, direction="low", aggregation=aggregation,
            budget=MAX_CHUNK, dtype=torch.int64, engine=engine,
            wv_slots=host_wedge_counts(rg, "low"),
        ).summary()
    _no_host_pass(monkeypatch)
    kw = dict(mode=mode, engine=engine, aggregation=aggregation,
              max_chunk=MAX_CHUNK, count_dtype=torch.int64, device="cpu",
              resilience=resilience.ResiliencePolicy(backoff_base_s=0.0))
    if fault is None:
        r = count_butterflies(g, **kw)
    else:
        kind, times = fault
        with faults.inject(kind, site=f"count.{engine}", times=times) as f:
            r = count_butterflies(g, **kw)
        assert f.fired >= 1
    rep = r.report
    assert rep.phases["count.wedge_counts"].n == 1
    assert [a.rung for a in rep.attempts] == rungs
    if fault is not None and fault[0] == "oom":
        assert rep.attempts[0].retries == 1
    assert rep.plan == want_plan
    assert r.total.dtype == np.int64
    _assert_counts(r, g, mode)


@pytest.mark.parametrize("engine", ["fused_cuda", "torch"])
def test_count_from_ranked_alone_makes_its_own_pass(engine, monkeypatch):
    """Called alone, as the query service calls it, ``count_from_ranked``
    plans from its own device pass, not from ``host_wedge_counts``."""
    g = _rand(30, 25, 160, 4)
    rg = _ranked(g, "degree")
    _no_host_pass(monkeypatch)
    total, bv, be = count_mod.count_from_ranked(
        rg, mode="all", engine=engine, max_chunk=MAX_CHUNK,
        count_dtype=torch.int64, device="cpu")
    r = count_mod.interpret_counts(
        rg, g, "all", (total.numpy(), bv.numpy(), be.numpy()), "sort",
        "degree")
    _assert_counts(r, g, "all")


# the CSR build on the count's device: the CPU, and the card where there
# is one (decided in the test)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _on(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return device


def _assert_ranked_equal(a, b):
    for f in ("offsets", "neighbors", "edge_src", "undirected_id",
              "side_of", "orig_id", "rank_of_u", "rank_of_v"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("n", "m", "n_u", "n_v", "order_name"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("device", DEVICES)
def test_csr_build_on_device_equals_host_build_and_upload(device):
    device = _on(device)
    for name in sorted(GRAPHS):
        g = GRAPHS[name]()
        order = make_order(g, "degree", device="cpu")
        want = preprocess(g, order, order_name="degree")
        _assert_ranked_equal(
            preprocess(g, order, order_name="degree", device=device), want)
        rg, dg = preprocess_device(g, order, "degree", device)
        _assert_ranked_equal(rg, want)
        up = device_graph(want, device)
        for f in ("offsets", "neighbors", "edge_src", "undirected_id",
                  "side_of"):
            x, y = getattr(dg, f), getattr(up, f)
            assert x.dtype == y.dtype and x.device == y.device, f
            assert torch.equal(x, y), f
        assert (dg.n, dg.m) == (up.n, up.m)


def _no_upload(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("device_graph called on the count path")

    monkeypatch.setattr(count_mod, "device_graph", boom)
    monkeypatch.setattr(wedges, "device_graph", boom)


@pytest.mark.parametrize("device", DEVICES)
def test_count_takes_its_graph_from_the_csr_build(device, monkeypatch):
    device = _on(device)
    g = _rand(3000, 2500, 60_000, 7) if device == "cuda" else GRAPHS["hub"]()
    kw = dict(mode="all", engine="fused_cuda", count_dtype=torch.int64)
    want = count_butterflies(g, device="cpu", **kw)
    _no_upload(monkeypatch)
    r = count_butterflies(g, device=device, **kw)
    assert r.report.counters == {}
    assert r.report.phases["count.csr"].n == 1
    for f in ("total", "per_u", "per_v", "per_edge"):
        assert np.array_equal(getattr(r, f), getattr(want, f)), f
    if device == "cpu":
        _assert_counts(r, g, "all")


@pytest.mark.parametrize("device", DEVICES)
def test_count_from_ranked_alone_uploads(device, monkeypatch):
    device = _on(device)
    g = GRAPHS["rand0"]()
    rg = _ranked(g, "degree")
    uploads = []

    def upload(*a, **k):
        uploads.append(a[0])
        return device_graph(*a, **k)

    monkeypatch.setattr(count_mod, "device_graph", upload)
    with spans.root("count") as call:
        total = count_mod.count_from_ranked(
            rg, mode="global", engine="fused_cuda", count_dtype=torch.int64,
            device=device)
    assert len(uploads) == 1 and uploads[0] is rg
    assert call.phases["count.wedge_counts"][1] == 1
    assert call.counters == {}
    assert int(total) == oracle.global_count(g)


@pytest.mark.parametrize("knobs,match", [
    (dict(engine="gpu"), "engine"),
    (dict(mode="pairs"), "mode"),
    (dict(aggregation="radix"), "aggregation"),
    (dict(aggregation="batch", engine="fused"), "batch"),
])
def test_count_from_ranked_refuses_bad_knobs_before_uploading(
        knobs, match, monkeypatch):
    _no_upload(monkeypatch)
    rg = _ranked(GRAPHS["rand0"](), "degree")
    with pytest.raises(ValueError, match=match):
        count_mod.count_from_ranked(rg, device="cpu", **knobs)
