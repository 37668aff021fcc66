"""The port's approximate tier against the reference's.

Part one mirrors ``tests/test_sparsify.py`` on the port (``device="cpu"``):
honest seeded subgraphs, unbiased estimators, covering error bars, the
sparsify methods routed through the exact fused engine, and typed
misuse. Part two holds the port to the JAX package exactly: the same
seed gives the same thinned edge arrays, the same sampling state and
the same estimates, with ``estimate``, ``stddev``, ``ci95``, ``p`` and
``n_samples`` compared with ``==`` (tolerance zero: both packages run
the same numpy draws and the same float operations in the same order).
"""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np  # noqa: E402

from repro.core import approx as ref_approx  # noqa: E402
from repro.core import sparsify as ref_sparsify  # noqa: E402
from repro.data import graphs as ref_graphs  # noqa: E402
from repro_torch.core import BipartiteGraph  # noqa: E402
from repro_torch.core import sparsify as sparsify_mod  # noqa: E402
from repro_torch.core.approx import (  # noqa: E402
    ApproxCount,
    SampleState,
    sample_count,
    samples_for_eps,
)
from repro_torch.core.count import ENGINE_MAP  # noqa: E402
from repro_torch.core.oracle import global_count  # noqa: E402
from repro_torch.core.sparsify import (  # noqa: E402
    approx_count,
    colorful_classes,
    sparsify_colorful,
    sparsify_edges,
)
from repro_torch.data.graphs import powerlaw_bipartite  # noqa: E402

G_SMALL = powerlaw_bipartite(200, 150, 1200, seed=0)
G_MED = powerlaw_bipartite(300, 250, 2500, seed=2)
CPU = dict(device="cpu")
# seeded graphs (n_u, n_v, m, seed) for the exact parity checks
PARITY_GRAPHS = [(200, 150, 1200, 0), (300, 250, 2500, 2),
                 (60, 400, 1500, 5), (500, 40, 1800, 9)]
FIELDS = ("estimate", "stddev", "ci95", "p", "n_samples", "eps", "seed",
          "method")


def approx(g, *args, **kw):
    return approx_count(g, *args, **CPU, **kw)


# ---------------------------------------------------------------------------
# sparsified graphs
# ---------------------------------------------------------------------------


def test_sparsified_graph_is_subgraph():
    full = {tuple(e) for e in G_SMALL.edges}
    for fn in (sparsify_edges, sparsify_colorful):
        gs = fn(G_SMALL, 0.5, seed=1)
        assert 0 < gs.m < G_SMALL.m
        assert gs.n_u == G_SMALL.n_u and gs.n_v == G_SMALL.n_v
        assert all(tuple(e) in full for e in gs.edges)


def test_sparsify_seeded_determinism():
    for fn in (sparsify_edges, sparsify_colorful):
        a = fn(G_SMALL, 0.5, seed=3)
        b = fn(G_SMALL, 0.5, seed=3)
        c = fn(G_SMALL, 0.5, seed=4)
        assert np.array_equal(a.edges, b.edges)
        assert not np.array_equal(a.edges, c.edges)
    s1 = sample_count(G_SMALL, n_samples=500, seed=9)
    s2 = sample_count(G_SMALL, n_samples=500, seed=9)
    assert s1.estimate == s2.estimate and s1.ci95 == s2.ci95


def test_colorful_classes_rounding():
    assert colorful_classes(1.0) == 1
    assert colorful_classes(0.5) == 2
    assert colorful_classes(0.3) == 3
    assert colorful_classes(0.24) == 4
    with pytest.raises(ValueError):
        colorful_classes(0.0)


# ---------------------------------------------------------------------------
# estimator accuracy: means and coverage
# ---------------------------------------------------------------------------


def test_p_one_is_exact():
    exact = global_count(G_SMALL)
    for method in ("edges", "colorful", "edge"):  # incl. seed alias
        r = approx(G_SMALL, 1.0, method=method, seed=0)
        assert isinstance(r, ApproxCount)
        assert int(r.estimate) == exact
        assert r.ci95 == 0.0 and r.stddev == 0.0


@pytest.mark.parametrize("method", ["edges", "colorful"])
def test_sparsify_estimator_mean_close(method):
    """Mean over 10 single-rep seeds within 30% of exact: a wrong
    survival exponent is a 2x error at p=0.5."""
    exact = global_count(G_MED)
    ests = [approx(G_MED, 0.5, method=method, seed=s, reps=1).estimate
            for s in range(10)]
    assert all(e > 0 for e in ests)
    err = abs(np.mean(ests) - exact) / exact
    assert err < 0.30, (np.mean(ests), exact, err)


def test_sample_estimator_mean_and_coverage():
    exact = global_count(G_MED)
    runs = [sample_count(G_MED, n_samples=2000, seed=s) for s in range(40)]
    err = abs(np.mean([r.estimate for r in runs]) - exact) / exact
    assert err < 0.10, err
    coverage = np.mean([r.covers(exact) for r in runs])
    assert coverage >= 0.85, coverage


@pytest.mark.parametrize("method", ["edges", "colorful"])
def test_sparsify_ci95_covers(method):
    exact = global_count(G_SMALL)
    covered = sum(
        approx(G_SMALL, 0.5, method=method, seed=s, reps=4).covers(exact)
        for s in range(6)
    )
    assert covered >= 5, covered


def test_derived_p_from_eps_runs():
    r = approx(G_SMALL, method="edges", eps=0.4, reps=1, seed=0)
    assert 0.0 < r.p <= 1.0
    assert r.eps == 0.4
    assert r.estimate >= 0.0


# ---------------------------------------------------------------------------
# routing: the sparsify tier runs the exact fused engine
# ---------------------------------------------------------------------------


def test_sparsify_routes_through_fused_tile_loop():
    r = approx(G_SMALL, 0.5, method="edges", seed=0, reps=1)
    rep = r.report
    assert rep is not None
    assert rep.final_rung == "fused_cuda"  # its plain version on the CPU
    assert "engine=fused_cuda" in rep.plan
    assert "count/count_wedges" in rep.plan
    assert rep.estimator.startswith("approx(method=edges")
    assert "scale=1/p^4" in rep.estimator
    assert "kept_m=" in rep.estimator
    assert "estimator:" in rep.summary()


def test_colorful_scale_recorded():
    r = approx(G_SMALL, 0.5, method="colorful", seed=0, reps=1)
    assert r.p == 0.5  # effective keep probability 1/N
    assert "scale=N^3=8" in r.report.estimator


def test_sample_runs_as_zero_cost_rung():
    r = approx(G_SMALL, method="sample", eps=0.2, seed=0)
    rep = r.report
    assert rep is not None
    assert rep.final_rung == "sample"
    assert rep.estimator.startswith("approx(method=sample")
    assert rep.plan is None


# ---------------------------------------------------------------------------
# the sampling estimator's surface
# ---------------------------------------------------------------------------


def test_sample_fields_and_describe():
    r = sample_count(G_MED, eps=0.1, seed=0)
    assert r.method == "sample"
    assert r.n_samples == samples_for_eps(0.1)
    assert r.stddev > 0 and r.ci95 >= 1.9 * r.stddev
    assert "method=sample" in r.describe()
    assert f"n={r.n_samples}" in r.describe()
    assert r.covers(r.estimate)
    assert not r.covers(r.estimate + 10 * r.ci95 + 1.0)


def test_eps_to_samples_monotone():
    n_loose = samples_for_eps(0.3)
    n_mid = samples_for_eps(0.1)
    n_tight = samples_for_eps(0.05)
    assert n_loose < n_mid < n_tight
    assert n_loose >= 64
    assert n_mid == math.ceil(8.0 / 0.1 ** 2)
    for bad in (0.0, 1.0, -0.1):
        with pytest.raises(ValueError):
            samples_for_eps(bad)


def test_sample_state_resident_reuse():
    state = SampleState.build(G_MED)
    assert state.w_total == min(G_MED.wedge_totals())
    a = sample_count(state, n_samples=1000, seed=5)
    b = sample_count(G_MED, n_samples=1000, seed=5)
    assert a.estimate == b.estimate


def test_wedgeless_graph_is_exactly_zero():
    edges = np.stack([np.arange(10), np.arange(10)], axis=1)
    g = BipartiteGraph(10, 10, edges)
    r = sample_count(g, n_samples=100, seed=0)
    assert r.estimate == 0.0 and r.ci95 == 0.0
    r2 = approx(g, method="sample", seed=0)
    assert r2.estimate == 0.0


def test_typed_errors():
    with pytest.raises(ValueError, match="method"):
        approx(G_SMALL, 0.5, method="magic")
    with pytest.raises(ValueError, match="p must be in"):
        approx(G_SMALL, 1.5, method="edges")
    with pytest.raises(ValueError, match="p must be in"):
        sparsify_edges(G_SMALL, 0.0)
    with pytest.raises(ValueError, match="eps/n_samples"):
        approx(G_SMALL, 0.5, method="sample")
    with pytest.raises(ValueError, match="eps"):
        approx(G_SMALL, method="edges", eps=2.0)
    with pytest.raises(ValueError, match="reps"):
        approx(G_SMALL, 0.5, method="edges", reps=0)


def test_approx_count_refuses_a_missing_card(monkeypatch):
    """``device=None`` means CUDA for every method: without a card the
    entry point raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (dict(p=0.5, method="edges"), dict(method="sample")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            approx_count(G_SMALL, seed=0, **kw)


# ---------------------------------------------------------------------------
# exact parity with the reference package
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def graph_pair(spec):
    nu, nv, m, seed = spec
    return (ref_graphs.powerlaw_bipartite(nu, nv, m, seed=seed),
            powerlaw_bipartite(nu, nv, m, seed=seed))


@pytest.mark.parametrize("spec", PARITY_GRAPHS)
def test_sparsified_edges_equal_reference(spec):
    ref_g, g = graph_pair(spec)
    assert np.array_equal(ref_g.edges, g.edges)
    for p in (1.0, 0.5, 0.3, 0.1):
        for seed in (0, 1, 2 ** 40 + 7):
            for name in ("sparsify_edges", "sparsify_colorful"):
                want = getattr(ref_sparsify, name)(ref_g, p, seed=seed)
                got = getattr(sparsify_mod, name)(g, p, seed=seed)
                assert (got.n_u, got.n_v) == (want.n_u, want.n_v)
                assert got.edges.dtype == want.edges.dtype
                assert np.array_equal(got.edges, want.edges), (name, p, seed)


@pytest.mark.parametrize("spec", PARITY_GRAPHS)
def test_sample_state_and_sample_count_equal_reference(spec):
    ref_g, g = graph_pair(spec)
    want, got = ref_approx.SampleState.build(ref_g), SampleState.build(g)
    assert (got.center_side, got.w_total) == (want.center_side,
                                              want.w_total)
    for f in ("c_indptr", "c_indices", "e_indptr", "e_indices", "c_cumw"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for seed in (0, 1, 17):
        for kw in (dict(eps=0.1), dict(eps=0.3), dict(n_samples=1),
                   dict(n_samples=2000)):
            a = sample_count(got, seed=seed, **kw)
            b = ref_approx.sample_count(want, seed=seed, **kw)
            for f in FIELDS:
                assert getattr(a, f) == getattr(b, f), (seed, kw, f)
            assert a.describe() == b.describe()


@pytest.mark.parametrize("spec", PARITY_GRAPHS)
@pytest.mark.parametrize("method", ["edges", "colorful"])
def test_derived_p_equals_reference(spec, method):
    """The pilot-sample ``eps -> p`` mapping equals the reference's to
    the last bit: one ulp would change ``colorful_classes`` rounding
    and with it the whole estimate."""
    ref_g, g = graph_pair(spec)
    for eps in (0.05, 0.1, 0.25, 0.4, 0.9):
        for seed in (0, 3):
            got = sparsify_mod._derive_p(g, eps, method, seed)
            want = ref_sparsify._derive_p(ref_g, eps, method, seed)
            assert got == want, (eps, seed)
            assert (sparsify_mod.colorful_classes(got)
                    == ref_sparsify.colorful_classes(want))
    for dof in range(0, 14):
        assert sparsify_mod._t975(dof) == ref_sparsify._t975(dof)


APPROX_CASES = [
    dict(method="edges", p=0.5, reps=3),
    dict(method="colorful", p=0.3, reps=2),
    dict(method="edges", p=0.5, reps=1),
    dict(method="edges", eps=0.4, reps=2),
    dict(method="colorful", eps=0.3, reps=2),
    dict(method="sample", eps=0.2),
    dict(method="sample", n_samples=300),
]


@pytest.mark.parametrize("spec", PARITY_GRAPHS[:2])
@pytest.mark.parametrize("kw", APPROX_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_approx_count_equals_reference(spec, kw):
    """All three methods, with ``p`` and with ``p`` derived from
    ``eps``: equal fields, and the same ``report.estimator`` with the
    reference's ``fused`` counting the thinned graphs where the port's
    default ``fused_cuda`` does."""
    ref_g, g = graph_pair(spec)
    want = ref_sparsify.approx_count(ref_g, seed=5, **kw)
    got = approx_count(g, seed=5, device="cpu", **kw)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.report.estimator == want.report.estimator
    assert got.report.final_rung == (
        "sample" if kw["method"] == "sample"
        else ENGINE_MAP["fused_pallas"])
    if kw["method"] != "sample":
        assert want.report.final_rung == "fused"
        assert got.report.plan == want.report.plan.replace(
            "engine=fused", f"engine={ENGINE_MAP['fused_pallas']}")
