"""Stored-wedge tip decomposition (WPEEL-V, ``peel_tips_stored``) of the
port on the CPU against the reference package's
``repro.core.peel.peel_tips_stored``.

Both packages peel the same seeded graphs from the same int64 counts;
the tip numbers, the peeled side, ``rounds``, ``sub_rounds`` and
``round_sizes`` must be equal, as must the stored-wedge CSR arrays and
the plan (tolerance 0: they are integers). The reference's results come
from its host engine, once per graph, side and peel mode; every knob
combination of the port is one case.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.peel as ref_peel  # noqa: E402
from repro.core import count_butterflies as ref_count  # noqa: E402
from repro.core.pipeline import plan_peel as ref_plan_peel  # noqa: E402
from repro.data import graphs as ref_graphs  # noqa: E402
from repro_torch.core import ResiliencePolicy, peel_tips_stored  # noqa: E402
from repro_torch.core import peel as port_peel  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

GRAPHS = {
    # the reference's frontier-overflow graph, and one power-law graph
    "random": ("random_bipartite", (30, 20, 300), 0),
    "powerlaw": ("powerlaw_bipartite", (150, 120, 1_500), 3),
}
MODES = ("exact", "range")
PORT_TILE = 1 << 20  # the port's default tile target (the reference's: 1024)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops under parallel test workers: one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Case:
    """One graph in both packages, the int64 per-vertex counts of both
    sides, and the reference's stored-wedge results per (side, mode)."""

    def __init__(self, name):
        gen, shape, seed = GRAPHS[name]
        self.ref_g = getattr(ref_graphs, gen)(*shape, seed=seed)
        self.g = getattr(graphs, gen)(*shape, seed=seed)
        assert np.array_equal(self.g.edges, self.ref_g.edges)
        r = ref_count(self.ref_g, mode="vertex")
        self.counts = (np.asarray(r.per_u, np.int64),
                       np.asarray(r.per_v, np.int64))
        self.want = {
            (side, mode): ref_peel.peel_tips_stored(
                self.ref_g, counts=self.counts[side], side=side,
                peel_mode=mode)
            for side in (0, 1) for mode in MODES
        }


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def case(request):
    return Case(request.param)


def assert_same(got, want):
    assert got.numbers.dtype == np.int64
    assert np.array_equal(got.numbers, np.asarray(want.numbers, np.int64))
    assert got.side == want.side
    assert got.rounds == want.rounds
    assert got.sub_rounds == want.sub_rounds
    assert np.array_equal(got.round_sizes,
                          np.asarray(want.round_sizes, np.int64))


@pytest.mark.parametrize("block", [7, 1 << 24])
@pytest.mark.parametrize("side", [0, 1])
def test_stored_wedge_csr_equals_reference(case, side, block):
    """``(woff, w_u2)`` equal the reference's, built in one block or in
    many (a block of 7 candidates holds one vertex, or a heavier one
    alone); ``w_u2`` is int32."""
    woff, w_u2 = port_peel._stored_wedge_csr(case.g, side, block=block)
    r_woff, r_w_u2 = ref_peel._stored_wedge_csr(case.ref_g, side)
    assert woff.dtype == np.int64 and w_u2.dtype == np.int32
    assert np.array_equal(woff, r_woff)
    assert np.array_equal(w_u2, r_w_u2)


@pytest.mark.parametrize("subtract", ["fused", "materialize"])
@pytest.mark.parametrize("peel_mode", MODES)
@pytest.mark.parametrize("decrease_key", ["bucket", "scatter"])
@pytest.mark.parametrize("aggregation", ["sort", "hash"])
@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("side", [0, 1])
def test_peel_tips_stored_matches_reference(case, side, engine, aggregation,
                                            decrease_key, peel_mode,
                                            subtract):
    got = peel_tips_stored(case.g, counts=case.counts[side], side=side,
                           engine=engine, aggregation=aggregation,
                           decrease_key=decrease_key, peel_mode=peel_mode,
                           subtract=subtract, device="cpu")
    want = case.want[(side, peel_mode)]
    assert_same(got, want)
    assert got.report.final_rung == engine and not got.report.degraded
    assert got.report.segments == (1 if engine == "device" else 0)
    assert got.report.plan == want.report.plan.replace(
        "tile_budget=1024", f"tile_budget={PORT_TILE}").replace(
        "engine=host", f"engine={engine}").replace(
        "agg=sort", f"agg={aggregation}")


@pytest.mark.parametrize("side", [0, 1])
def test_stored_plan_equals_reference(case, side):
    """``plan_peel`` for WPEEL-V (stored-wedge capacity, per-vertex row
    lengths as the entity work) equals the reference's, field for
    field."""
    woff, _ = port_peel._stored_wedge_csr(case.g, side)
    n_side = case.g.n_u if side == 0 else case.g.n_v
    kw = dict(expansion="peel_tips_stored", engine="device",
              aggregation="hash", n_out=n_side, dtype="int64",
              capacity=(("max_frontier", 99), ("tile_budget", 1024),
                        ("stored_wedges", int(woff[-1]))),
              hash_bits=7, entity_work=np.diff(woff))
    got = pipeline.plan_peel("peel_tips_stored", **kw)
    want = ref_plan_peel("peel_tips_stored", **kw)
    assert got.to_dict() == want.to_dict()
    assert got.summary() == want.summary()
    assert pipeline.WedgePlan.from_dict(want.to_dict()) == got


def test_max_frontier_rungs_match_reference():
    """``max_frontier=1`` on the reference's overflow graph: the
    materializing subtract latches overflow and the host rung answers;
    fused WPEEL-V keeps no frontier buffer and stays on the device (the
    reference's tests/test_peeling.py pins the same rungs)."""
    gen, shape, seed = GRAPHS["random"]
    ref_g = getattr(ref_graphs, gen)(*shape, seed=seed)
    g = getattr(graphs, gen)(*shape, seed=seed)
    for fn, ref_fn, subtract, path in (
        (peel_tips_stored, ref_peel.peel_tips_stored, "fused",
         [("device", "ok")]),
        (peel_tips_stored, ref_peel.peel_tips_stored, "materialize",
         [("device", "capacity-overflow"), ("host", "ok")]),
        (port_peel.peel_tips, ref_peel.peel_tips, "materialize",
         [("device", "capacity-overflow"), ("host", "ok")]),
    ):
        kw = dict(side=0, engine="device", max_frontier=1,
                  subtract=subtract)
        got = fn(g, device="cpu", **kw)
        want = ref_fn(ref_g, **kw)
        assert_same(got, want)
        attempts = [(a.rung, a.outcome) for a in got.report.attempts]
        assert attempts == [(a.rung, a.outcome)
                            for a in want.report.attempts] == path


@pytest.mark.parametrize("engine", ["host", "device"])
def test_hash_overflow_falls_back_to_sort(case, engine, monkeypatch):
    """A 4-slot hash table must overflow; the shared sort fallback then
    carries the tile and the numbers equal the reference's."""
    calls = []
    sort = pipeline.aggregate_sort

    def spy(w):
        calls.append(int(w.x1.shape[0]))
        return sort(w)

    monkeypatch.setattr(pipeline, "aggregate_sort", spy)
    got = peel_tips_stored(case.g, counts=case.counts[0], side=0,
                           engine=engine, aggregation="hash", hash_bits=2,
                           device="cpu")
    assert calls
    assert_same(got, case.want[(0, "exact")])


@pytest.mark.parametrize("fault,outcome", [
    ("oom", "resource-exhausted"), ("poison", "invalid-result")])
def test_device_faults_descend_to_host(case, fault, outcome):
    policy = ResiliencePolicy(backoff_base_s=0.0)
    with faults.inject(fault, site="peel_tips_stored.device"):
        got = peel_tips_stored(case.g, counts=case.counts[1], side=1,
                               engine="device", device="cpu",
                               resilience=policy)
    assert [(a.rung, a.outcome) for a in got.report.attempts] == [
        ("device", outcome), ("host", "ok")]
    assert_same(got, case.want[(1, "exact")])


def test_counts_computed_by_the_entry_point(case):
    """With ``counts`` and ``side`` omitted each package picks the side
    and counts for itself."""
    got = peel_tips_stored(case.g, engine="device", device="cpu")
    want = ref_peel.peel_tips_stored(case.ref_g)
    assert_same(got, want)


def test_entry_point_defaults_to_the_card(case):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peel_tips_stored(case.g, counts=case.counts[0], side=0)
