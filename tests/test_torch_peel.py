"""Tip and wing decomposition of the port (``repro_torch.core.peel`` on
the CPU) against the reference package's ``repro.core.peel``.

Both packages peel the same seeded graphs from the same int64 count
arrays; the tip/wing numbers, the peeled side, ``rounds``,
``sub_rounds`` and ``round_sizes`` must be equal (tolerance 0: they are
integers). The reference's results are computed once per graph in a
module-scoped fixture; each knob combination of the port is one case.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax  # noqa: E402

import repro.core.peel as ref_peel  # noqa: E402
from repro.core import count_butterflies as ref_count  # noqa: E402
from repro.core.pipeline import peel_tile_bounds as ref_tile_bounds  # noqa: E402
from repro.core.pipeline import plan_peel as ref_plan_peel  # noqa: E402
from repro.core.wedges import aligned_tile_end as ref_aligned_tile_end  # noqa: E402
from repro.core.wedges import expand_ragged as ref_expand_ragged  # noqa: E402
from repro.data import graphs as ref_graphs  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ResiliencePolicy,
    peel_tips,
    peel_tips_stored,
    peel_wings,
)
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.wedges import aligned_tile_end, expand_ragged  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN = os.path.join(ROOT, "tests", "data", "torch_peel_reference.json")

# the reference's peel_small, and one uniform random graph
GRAPHS = {
    "peel_small": ("powerlaw_bipartite", (600, 500, 4_000), 7),
    "random": ("random_bipartite", (150, 120, 1_500), 3),
}
ENGINES = ("host", "device")
KEYS = ("bucket", "scatter")
MODES = ("exact", "range")
AGGS = ("sort", "hash")
PORT_TILE = 1 << 20  # the port's default tile target (the reference's: 1024)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's loops issue many small ops; under the test runner's
    parallel workers PyTorch's intra-op thread pool only contends for
    the cores, so this module runs torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Case:
    """One graph in both packages, its int64 counts, and the
    reference's results (host engine) in both peel modes."""

    def __init__(self, name):
        gen, shape, seed = GRAPHS[name]
        self.ref_g = getattr(ref_graphs, gen)(*shape, seed=seed)
        self.g = getattr(graphs, gen)(*shape, seed=seed)
        assert np.array_equal(self.g.edges, self.ref_g.edges)
        r = ref_count(self.ref_g, mode="all")
        self.side = ref_peel.peel_tips(self.ref_g, peel_mode="exact").side
        per_side = r.per_u if self.side == 0 else r.per_v
        self.tip_counts = np.asarray(per_side, np.int64)
        self.wing_counts = np.asarray(r.per_edge, np.int64)
        self.tips = {m: ref_peel.peel_tips(
            self.ref_g, counts=self.tip_counts, side=self.side, peel_mode=m)
            for m in MODES}
        self.wings = {m: ref_peel.peel_wings(
            self.ref_g, counts=self.wing_counts, peel_mode=m)
            for m in MODES}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def case(request):
    return Case(request.param)


def assert_same(got, want):
    """numbers (the port's in int64), side, rounds, sub_rounds and
    round_sizes equal."""
    assert got.numbers.dtype == np.int64
    assert np.array_equal(got.numbers, np.asarray(want.numbers, np.int64))
    assert got.side == want.side
    assert got.rounds == want.rounds
    assert got.sub_rounds == want.sub_rounds
    assert np.array_equal(got.round_sizes,
                          np.asarray(want.round_sizes, np.int64))


def port_plan(want):
    return want.report.plan.replace("tile_budget=1024",
                                    f"tile_budget={PORT_TILE}")


@pytest.mark.parametrize("aggregation", AGGS)
@pytest.mark.parametrize("peel_mode", MODES)
@pytest.mark.parametrize("decrease_key", KEYS)
@pytest.mark.parametrize("engine", ENGINES)
def test_peel_tips_matches_reference(case, engine, decrease_key, peel_mode,
                                     aggregation):
    got = peel_tips(case.g, counts=case.tip_counts, side=case.side,
                    engine=engine, decrease_key=decrease_key,
                    peel_mode=peel_mode, aggregation=aggregation,
                    device="cpu")
    want = case.tips[peel_mode]
    assert_same(got, want)
    assert got.report.final_rung == engine and not got.report.degraded
    assert got.report.host_syncs > 0
    assert got.report.plan == port_plan(want).replace(
        "engine=host", f"engine={engine}").replace(
        "agg=sort", f"agg={aggregation}")


@pytest.mark.parametrize("aggregation", AGGS)
@pytest.mark.parametrize("peel_mode", MODES)
@pytest.mark.parametrize("decrease_key", KEYS)
@pytest.mark.parametrize("engine", ENGINES)
def test_peel_wings_matches_reference(case, engine, decrease_key, peel_mode,
                                      aggregation):
    got = peel_wings(case.g, counts=case.wing_counts, engine=engine,
                     decrease_key=decrease_key, peel_mode=peel_mode,
                     aggregation=aggregation, device="cpu")
    want = case.wings[peel_mode]
    assert_same(got, want)
    assert got.report.final_rung == engine and not got.report.degraded
    assert got.report.plan == port_plan(want).replace(
        "engine=host", f"engine={engine}").replace(
        "agg=sort", f"agg={aggregation}")


@pytest.mark.parametrize("kind", ["tips", "wings"])
def test_small_tiles_match_reference(case, kind):
    """The reference's own 1024-lane tile target: multi-tile rounds,
    aligned at peeled-vertex boundaries for tips, and the device loop's
    extra tile-plan fetch."""
    if kind == "tips":
        got = peel_tips(case.g, counts=case.tip_counts, side=case.side,
                        engine="device", tile_budget=1024, device="cpu")
        want = case.tips["exact"]
    else:
        got = peel_wings(case.g, counts=case.wing_counts, engine="device",
                         tile_budget=1024, device="cpu")
        want = case.wings["exact"]
    assert_same(got, want)
    assert got.report.plan == want.report.plan.replace(
        "engine=host", "engine=device")


@pytest.mark.parametrize("kind", ["tips", "wings"])
def test_hash_overflow_falls_back_to_sort(case, kind, monkeypatch):
    """A 4-slot hash table must overflow; the shared sort fallback then
    carries the tile and the numbers still equal the reference's."""
    calls = []
    sort = pipeline.aggregate_sort

    def spy(w):
        calls.append(int(w.x1.shape[0]))
        return sort(w)

    monkeypatch.setattr(pipeline, "aggregate_sort", spy)
    if kind == "tips":
        got = peel_tips(case.g, counts=case.tip_counts, side=case.side,
                        engine="device", aggregation="hash", hash_bits=2,
                        device="cpu")
        want = case.tips["exact"]
    else:
        got = peel_wings(case.g, counts=case.wing_counts, engine="device",
                         aggregation="hash", hash_bits=2, device="cpu")
        want = case.wings["exact"]
    assert calls  # the fallback ran
    assert_same(got, want)


def test_max_frontier_descends_to_host():
    """A level-1 frontier budget the first round exceeds: K_{20,20}
    beside a disjoint K_{30,30}, so round one peels 20 vertices of
    degree 20 (400 level-1 slots, above the 128 budget) while the larger
    block stays alive. The device rung reports a capacity overflow and
    the host rung finishes, as in the reference."""
    a = np.stack([np.repeat(np.arange(20), 20), np.tile(np.arange(20), 20)])
    b = np.stack([np.repeat(np.arange(30), 30), np.tile(np.arange(30), 30)])
    e = np.concatenate([a.T, b.T + 20])
    ref_g = ref_graphs.BipartiteGraph(50, 50, e)
    g = graphs.BipartiteGraph(50, 50, e)
    kw = dict(engine="device", max_frontier=128)
    got = peel_tips(g, device="cpu", **kw)
    want = ref_peel.peel_tips(ref_g, **kw)
    assert_same(got, want)
    path = [(a.rung, a.outcome) for a in got.report.attempts]
    assert path == [(a.rung, a.outcome) for a in want.report.attempts]
    assert path == [("device", "capacity-overflow"), ("host", "ok")]
    assert got.report.final_rung == "host" and got.report.degraded


@pytest.mark.parametrize("kind", ["tips", "wings"])
@pytest.mark.parametrize("fault,outcome", [
    ("oom", "resource-exhausted"), ("poison", "invalid-result")])
def test_device_faults_descend_to_host(case, kind, fault, outcome):
    """An allocator failure (after its shrink-retries) or a poisoned
    count on the device rung descends to the host rung, which gives the
    reference's numbers."""
    fn, counts, want = (
        (peel_tips, case.tip_counts, case.tips["exact"]) if kind == "tips"
        else (peel_wings, case.wing_counts, case.wings["exact"]))
    kw = dict(side=case.side) if kind == "tips" else {}
    policy = ResiliencePolicy(backoff_base_s=0.0)
    with faults.inject(fault, site=f"peel_{kind}.device"):
        got = fn(case.g, counts=counts, engine="device", device="cpu",
                 resilience=policy, **kw)
    assert [(a.rung, a.outcome) for a in got.report.attempts] == [
        ("device", outcome), ("host", "ok")]
    assert_same(got, want)


def test_counts_computed_by_the_entry_point(case):
    """With ``counts`` omitted each package counts for itself (the
    reference's default count engine and dtype, the port's int64)."""
    got = peel_tips(case.g, engine="device", device="cpu")
    want = ref_peel.peel_tips(case.ref_g)
    assert_same(got, want)
    got_w = peel_wings(case.g, engine="device", device="cpu")
    want_w = ref_peel.peel_wings(case.ref_g)
    assert_same(got_w, want_w)


@pytest.mark.parametrize("kind", ["tips", "wings"])
def test_peel_plan_equals_reference(case, kind):
    """``plan_peel`` over the same inputs gives the reference's plan,
    field for field."""
    if kind == "tips":
        from repro_torch.core.peel import _csr, _level2_totals
        off, nbr, _ = _csr(case.g)
        n_side = case.g.n_u if case.side == 0 else case.g.n_v
        base = 0 if case.side == 0 else case.g.n_u
        work = _level2_totals(off, nbr, base, n_side)
        kw = dict(expansion="peel_tips_2hop", n_out=n_side)
    else:
        from repro_torch.core.peel import _csr, _wing_work_totals
        off, nbr, _ = _csr(case.g)
        work = _wing_work_totals(case.g, off, nbr)[3]
        kw = dict(expansion="peel_wings_triples", n_out=case.g.m)
    kw.update(engine="device", aggregation="hash", dtype="int64",
              capacity=(("max_frontier", 99), ("tile_budget", 1024)),
              hash_bits=7, entity_work=work)
    got = pipeline.plan_peel(f"peel_{kind}", **kw)
    want = ref_plan_peel(f"peel_{kind}", **kw)
    assert got.to_dict() == want.to_dict()
    assert got.summary() == want.summary()
    assert pipeline.WedgePlan.from_dict(want.to_dict()) == got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peel_tile_bounds_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for n, tiles in ((1, 4), (50, 8), (500, 64)):
        work = rng.integers(0, 50, n) * (rng.random(n) < 0.7)
        assert pipeline.peel_tile_bounds(work, tiles) == ref_tile_bounds(
            work, tiles)
    assert pipeline.peel_tile_bounds(np.zeros(9, np.int64), 4) == \
        ref_tile_bounds(np.zeros(9, np.int64), 4)
    assert pipeline.peel_tile_bounds(np.zeros(0, np.int64)) == ((), ())


@pytest.mark.parametrize("seed", [0, 1])
def test_ragged_helpers_equal_reference(seed):
    """expand_ragged and aligned_tile_end against the reference's
    in-graph versions; compact against numpy."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 6, 40)
    starts = rng.integers(0, 1000, 40)
    total = int(lens.sum())
    seg, pos, valid, tot = expand_ragged(torch.as_tensor(starts),
                                         torch.as_tensor(lens), total)
    r_seg, r_pos, r_valid, r_tot = ref_expand_ragged(
        jnp.asarray(starts, jnp.int32), jnp.asarray(lens, jnp.int32), total)
    assert int(tot) == int(r_tot) == total and bool(valid.all())
    assert np.array_equal(seg.numpy(), np.asarray(r_seg))
    assert np.array_equal(pos.numpy(), np.asarray(r_pos))
    roff = np.concatenate([[0], np.cumsum(lens)])
    for ts in sorted(set(roff.tolist()))[:-1]:
        for cap in (6, 13, 50):
            assert aligned_tile_end(roff, ts, cap) == int(
                ref_aligned_tile_end(jnp.asarray(roff, jnp.int32),
                                     jnp.int32(ts), cap))
    mask = torch.as_tensor(rng.random(300) < 0.3)
    assert np.array_equal(
        pipeline.compact(mask, int(mask.sum())).numpy(),
        np.flatnonzero(mask.numpy()))
    bounds = pipeline.tile_bounds(total, 7, roff)
    assert bounds[0][0] == 0 and bounds[-1][1] == total
    assert all(te in set(roff.tolist()) for _ts, te in bounds)


def test_out_of_slice_knobs_raise(case):
    """The distributed rung's knobs are still refused, on all three
    entry points, naming the ROADMAP step that ports them; unknown knob
    values are ValueErrors."""
    g = case.g
    calls = ((peel_tips, dict(counts=case.tip_counts, side=case.side)),
             (peel_tips_stored, dict(counts=case.tip_counts,
                                     side=case.side)),
             (peel_wings, dict(counts=case.wing_counts)))
    for kw in (dict(devices=2), dict(devices="auto"),
               dict(checkpoint="ckpt"), dict(deadline_s=1.0),
               dict(round_deadline_s=1.0)):
        for fn, args in calls:
            with pytest.raises(NotImplementedError, match="step 7"):
                fn(g, device="cpu", **args, **kw)
    with pytest.raises(ValueError, match="decrease_key"):
        peel_tips(g, counts=case.tip_counts, decrease_key="heap",
                  device="cpu")
    with pytest.raises(ValueError, match="subtract"):
        peel_tips_stored(g, counts=case.tip_counts, subtract="copy",
                         device="cpu")
    with pytest.raises(ValueError, match="capacity_schedule"):
        peel_wings(g, counts=case.wing_counts, capacity_schedule="sometimes",
                   device="cpu")
    with pytest.raises(ValueError, match="engine"):
        peel_wings(g, counts=case.wing_counts, engine="mesh", device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("schedule", ["fixed", "adaptive"])
@pytest.mark.parametrize("subtract", ["fused", "materialize"])
@pytest.mark.parametrize("kind", ["tips", "wings"])
def test_subtract_schedule_match_reference(case, kind, subtract, schedule,
                                          engine):
    """The materializing subtract (the whole round frontier in one
    tile) and the adaptive capacity schedule give the reference's
    numbers, rounds and round sizes on both engines; the device engine
    reports one capacity segment under the fixed schedule."""
    kw = dict(engine=engine, subtract=subtract, capacity_schedule=schedule,
              device="cpu")
    if kind == "tips":
        got = peel_tips(case.g, counts=case.tip_counts, side=case.side,
                        **kw)
        want = case.tips["exact"]
    else:
        got = peel_wings(case.g, counts=case.wing_counts, **kw)
        want = case.wings["exact"]
    assert_same(got, want)
    assert got.report.final_rung == engine and not got.report.degraded
    if engine == "host":
        assert got.report.segments == 0
    elif schedule == "fixed":
        assert got.report.segments == 1


def rand_graph(nu, nv, m, seed):
    """The reference tests' seeded random graph, in both packages."""
    rng = np.random.default_rng(seed)
    e = np.stack([rng.integers(0, nu, m), rng.integers(0, nv, m)], axis=1)
    return ref_graphs.BipartiteGraph(nu, nv, e), graphs.BipartiteGraph(
        nu, nv, e)


@pytest.mark.parametrize("schedule", ["fixed", "adaptive"])
@pytest.mark.parametrize("subtract", ["fused", "materialize"])
@pytest.mark.parametrize("kind", ["tips", "stored", "wings"])
@pytest.mark.parametrize("seed", [0, 1])
def test_segments_match_reference(seed, kind, subtract, schedule,
                                  monkeypatch):
    """``report.segments`` equals the number of ``jax.device_get`` calls
    of the reference's device engine on the same call (one per capacity
    segment, counts given), as the reference's own segment test counts
    them on the same graph (tests/test_peeling.py), and the adaptive
    re-entries leave the numbers alone."""
    ref_g, g = rand_graph(30, 20, 300, seed)
    r = ref_count(ref_g, mode="all")
    counts = (np.asarray(r.per_u, np.int64) if kind != "wings"
              else np.asarray(r.per_edge, np.int64))
    fn, ref_fn, kw = {
        "tips": (peel_tips, ref_peel.peel_tips, dict(side=0)),
        "stored": (peel_tips_stored, ref_peel.peel_tips_stored,
                   dict(side=0)),
        "wings": (peel_wings, ref_peel.peel_wings, {}),
    }[kind]
    kw.update(counts=counts, engine="device", subtract=subtract,
              capacity_schedule=schedule)
    calls = []
    orig = jax.device_get
    monkeypatch.setattr(jax, "device_get",
                        lambda x: (calls.append(1), orig(x))[1])
    want = ref_fn(ref_g, **kw)
    monkeypatch.setattr(jax, "device_get", orig)
    got = fn(g, device="cpu", **kw)
    assert_same(got, want)
    assert got.report.final_rung == want.report.final_rung == "device"
    assert got.report.segments == len(calls)
    if schedule == "adaptive" and (kind == "tips" or subtract ==
                                   "materialize"):
        # a planned capacity shrank: the loop left and re-entered
        assert got.report.segments > 1


def test_wing_materialize_max_frontier_rungs_match_reference():
    """Under ``subtract="materialize"`` a wing round overflows when its
    level-1 candidates or the level-2 scans of the candidates that pass
    the presence test exceed the ``max_frontier``-derived capacities,
    as in the reference: across budgets, the rung that answers is the
    reference's, and both outcomes occur."""
    ref_g, g = rand_graph(30, 20, 300, 0)
    r = ref_count(ref_g, mode="edge")
    counts = np.asarray(r.per_edge, np.int64)
    outcomes = set()
    for budget in (1, 256, 1024, 2048, 4096, 1 << 14, 1 << 16):
        kw = dict(counts=counts, engine="device", subtract="materialize",
                  max_frontier=budget)
        want = ref_peel.peel_wings(ref_g, **kw)
        got = peel_wings(g, device="cpu", **kw)
        assert_same(got, want)
        path = [(a.rung, a.outcome) for a in got.report.attempts]
        assert path == [(a.rung, a.outcome) for a in want.report.attempts]
        outcomes.add(got.report.final_rung)
    assert outcomes == {"device", "host"}


def test_entry_points_default_to_the_card(case):
    """Without ``device=`` the entry points ask for CUDA and raise on a
    host without a card, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peel_tips(case.g, counts=case.tip_counts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peel_wings(case.g, counts=case.wing_counts)


@pytest.mark.parametrize("name", ["PEEL_TIPS", "PEEL_WINGS",
                                  "PEEL_WINGS_HOST"])
def test_pinned_peel_graphs_match_port_generator(name):
    """The port's generator rebuilds each graph of the pinned peeling
    reference with its recorded edge count and content hash, so a wrong
    pin shows here and not first on the card."""
    with open(PIN) as f:
        pin = json.load(f)[name]
    spec = pin["generator"]
    g = graphs.powerlaw_bipartite(spec["n_u"], spec["n_v"], spec["m"],
                                  seed=spec["seed"])
    assert g.m == pin["m"]
    assert g.content_hash() == pin["content_hash"]
