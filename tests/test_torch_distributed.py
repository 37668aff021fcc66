"""Distributed execution of the port (``repro_torch.core.distributed``)
against the reference package's ``repro.core.distributed``, on the CPU.

Mirrors ``tests/test_distributed_peel.py`` case for case: the supervised
peeling rung on 1, 2 and 4 workers must give the reference's numbers,
round data and per-worker report rows with ``==`` (tolerance 0: all are
integers or strings), also under an injected device loss, a straggler
and a resume. Mesh-partitioned counting equals the reference's counts
bit for bit, in process against ``count_butterflies`` and in one
subprocess against the reference's own ``distributed_count`` on four
forced host devices. The exhaustive chaos cells (a kill at every round
boundary, a shrinking mesh) run only under ``REPRO_FAULTS=1``, as the
reference's do. Real-time cells (stragglers, subprocess timeouts) keep
wide margins between the injected delays and the deadlines.
"""
import hashlib
import json
import os
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

import repro.core as ref_core  # noqa: E402
from repro.core import distributed as ref_dist  # noqa: E402
from repro.core import peel as ref_peel  # noqa: E402
from repro.core.graph import preprocess as ref_preprocess  # noqa: E402
from repro.core.ranking import make_order as ref_make_order  # noqa: E402
from repro.testing import faults as ref_faults  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BipartiteGraph,
    DeviceLost,
    peel_tips,
    peel_tips_stored,
    peel_wings,
)
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.device import DeviceMesh  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    PeelSupervisor,
    distributed_count,
    distributed_count_fn,
    launch_device_worker,
    plan_fused_partition,
    plan_partition,
)
from repro_torch.core.graph import preprocess  # noqa: E402
from repro_torch.core.ranking import make_order  # noqa: E402
from repro_torch.core.resilience import DeadlineExceeded  # noqa: E402
from repro_torch.core.wedges import host_wedge_counts  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN = os.path.join(ROOT, "tests", "data", "torch_peel_reference.json")

FAULTS_ENABLED = os.environ.get("REPRO_FAULTS") == "1"
needs_faults_job = pytest.mark.skipif(
    not FAULTS_ENABLED,
    reason="exhaustive chaos cells run in the REPRO_FAULTS=1 CI job",
)


def rand_edges(nu, nv, m, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, nu, m), rng.integers(0, nv, m)], 1)


# the reference's graph for its distributed-peeling tests
EDGES = rand_edges(40, 30, 300, 11)
GRAPH = BipartiteGraph(40, 30, EDGES)
REF_GRAPH = ref_core.BipartiteGraph(40, 30, EDGES)

PORT = {
    "tips": lambda g, **kw: peel_tips(g, side=0, device="cpu", **kw),
    "tips_stored": lambda g, **kw: peel_tips_stored(g, side=0, device="cpu",
                                                    **kw),
    "wings": lambda g, **kw: peel_wings(g, device="cpu", **kw),
}
REF = {
    "tips": lambda g, **kw: ref_peel.peel_tips(g, side=0, **kw),
    "tips_stored": lambda g, **kw: ref_peel.peel_tips_stored(g, side=0, **kw),
    "wings": lambda g, **kw: ref_peel.peel_wings(g, **kw),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The supervisor's worker threads each run small torch ops; under
    the test runner's parallel workers PyTorch's intra-op pool only
    contends for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def counts():
    """int64 counts from the reference, handed to both packages, so both
    supervisors run the same plan dtype."""
    r = ref_core.count_butterflies(REF_GRAPH, mode="all")
    return {"tips": np.asarray(r.per_u, np.int64),
            "tips_stored": np.asarray(r.per_u, np.int64),
            "wings": np.asarray(r.per_edge, np.int64)}


def rows(report, served=True):
    """The per-worker child rows: workload, rung, outcome, detail. Under
    a device loss the sub-rounds a worker served before the loss surfaced
    depend on thread timing (in both packages), so ``served=False`` drops
    that count from the detail."""

    def detail(d):
        return d if served else " ".join(d.split()[1:])

    return [(c.workload, c.final_rung,
             [(a.rung, a.outcome, detail(a.detail), a.retries)
              for a in c.attempts])
            for c in report.children]


def assert_same(got, want):
    assert got.numbers.dtype == np.asarray(want.numbers).dtype
    assert np.array_equal(got.numbers, np.asarray(want.numbers))
    assert got.side == want.side
    assert got.rounds == want.rounds
    assert got.sub_rounds == want.sub_rounds
    assert np.array_equal(got.round_sizes,
                          np.asarray(want.round_sizes, np.int64))


# ---------------------------------------------------------------------------
# Parity: N workers == the reference's N devices, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PORT))
@pytest.mark.parametrize("devices", [1, 2, 4])
def test_distributed_parity(name, devices, counts):
    c = counts[name]
    want = REF[name](REF_GRAPH, counts=c, devices=devices)
    got = PORT[name](GRAPH, counts=c, devices=devices)
    assert_same(got, want)
    assert got.report.final_rung == "distributed"
    assert not got.report.degraded
    assert got.report.checkpoint_restores == want.report.checkpoint_restores
    assert rows(got.report) == rows(want.report)
    assert len(got.report.children) == devices
    # one read to seed the scan, one per sub-round but the last, one per
    # committed round (the round-0 snapshot reads none)
    assert got.report.host_syncs == got.sub_rounds + got.rounds
    # and the single-device rungs of the port agree
    rng = PORT[name](GRAPH, counts=c, peel_mode="range")
    assert_same(got, rng)


@pytest.mark.parametrize("name", sorted(PORT))
def test_distributed_parity_int32_counts(name, counts):
    """int32 counts (the reference's default dtype) keep int32 numbers
    and the reference's round data."""
    c = counts[name].astype(np.int32)
    want = REF[name](REF_GRAPH, counts=c, devices=2)
    got = PORT[name](GRAPH, counts=c, devices=2)
    assert_same(got, want)
    assert got.numbers.dtype == np.int32


def test_distributed_default_counts_and_auto_devices():
    """With no counts the port counts in int64 (the reference in
    int32); the numbers are the same. ``devices="auto"`` is one worker
    on the CPU."""
    want = ref_peel.peel_tips(REF_GRAPH, side=0, devices=1)
    got = peel_tips(GRAPH, side=0, devices="auto", device="cpu")
    assert np.array_equal(got.numbers, np.asarray(want.numbers, np.int64))
    assert got.rounds == want.rounds
    assert len(got.report.children) == 1


def test_distributed_report_has_device_rows(counts):
    r = peel_tips(GRAPH, counts=counts["tips"], side=0, devices=2,
                  device="cpu")
    s = r.report.summary()
    assert "@dev0" in s and "@dev1" in s
    assert [c.workload for c in r.report.children] == [
        "peel_tips@dev0", "peel_tips@dev1"
    ]
    assert all(c.attempts[0].outcome == "ok" for c in r.report.children)


def test_peel_checkpoint_dir_stays_bounded_with_retain_last(tmp_path,
                                                            counts):
    from repro_torch.core import CheckpointStore

    d = str(tmp_path / "bounded_run")
    host = peel_tips(GRAPH, counts=counts["tips"], side=0, device="cpu")
    store = CheckpointStore(directory=d, retain_last=3)
    r = peel_tips(GRAPH, counts=counts["tips"], side=0, devices=2,
                  checkpoint=store, device="cpu")
    assert np.array_equal(r.numbers, host.numbers)
    assert r.rounds + 1 > 3
    assert len(os.listdir(d)) == 3
    assert CheckpointStore(directory=d).restore() is not None


def test_peel_with_checkpoint_dir_writes_rounds(tmp_path, counts):
    d = str(tmp_path / "run")
    r = peel_tips(GRAPH, counts=counts["tips"], side=0, devices=2,
                  checkpoint=d, device="cpu")
    files = sorted(os.listdir(d))
    # round-0 anchor + one snapshot per committed bucket round
    assert len(files) == r.rounds + 1
    assert files[0] == "checkpoint_round_000000.json"


@pytest.mark.parametrize("name", sorted(PORT))
def test_cross_process_style_resume(tmp_path, name, counts):
    """A run over a rewound store resumes from its latest snapshot and
    ends on the uninterrupted run's numbers and round data."""
    d = str(tmp_path / name)
    c = counts[name]
    first = PORT[name](GRAPH, counts=c, devices=2, checkpoint=d)
    for f in sorted(os.listdir(d))[3:]:
        os.remove(os.path.join(d, f))
    again = PORT[name](GRAPH, counts=c, devices=2, checkpoint=d)
    assert_same(again, first)
    assert again.report.resumed_from_round == 2
    assert again.report.final_rung == "distributed"


# ---------------------------------------------------------------------------
# Counts at or above INT32_MAX: the exact min behind the clamped kernels
# ---------------------------------------------------------------------------


def _k2_graph(extra: bool):
    """K_{2,65537} (each U vertex in C(65537, 2) = 2,147,516,416
    butterflies, above INT32_MAX), optionally with a third U vertex on
    two of the V vertices, peeled first at κ = 2, after which the two
    big counts (each less one) are the alive min."""
    nv = 65537
    e = [(u, v) for u in (0, 1) for v in range(nv)]
    if extra:
        e += [(2, 0), (2, 1)]
    return np.asarray(e, np.int64), (3 if extra else 2), nv


@pytest.mark.parametrize("extra", [False, True])
def test_int64_min_above_int32_max_stays_exact(extra):
    e, nu, nv = _k2_graph(extra)
    c = (np.array([2147516417, 2147516417, 2], np.int64) if extra
         else np.array([2147516416, 2147516416], np.int64))
    g = BipartiteGraph(nu, nv, e)
    want = ref_peel.peel_tips(ref_core.BipartiteGraph(nu, nv, e), counts=c,
                              side=0, devices=2)
    got = peel_tips(g, counts=c, side=0, devices=2, device="cpu")
    assert_same(got, want)
    assert got.report.final_rung == "distributed"
    assert int(got.numbers.max()) == 2147516416
    host = peel_tips(g, counts=c, side=0, peel_mode="range", device="cpu")
    assert_same(got, host)


# ---------------------------------------------------------------------------
# Recovery: device loss, stragglers, full descent
# ---------------------------------------------------------------------------


def test_kill_one_device_at_round_boundary_recovers(counts):
    c = counts["tips"]
    with ref_faults.inject("device_loss", site="round1", times=1, device=1):
        want = ref_peel.peel_tips(REF_GRAPH, counts=c, side=0, devices=4)
    with faults.inject("device_loss", site="round1", times=1,
                       device=1) as f:
        got = peel_tips(GRAPH, counts=c, side=0, devices=4, device="cpu")
    assert f.fired == 1 and f.hits == ["distributed.peel.round1.dev1"]
    assert_same(got, want)
    assert got.report.checkpoint_restores == 1
    assert got.report.final_rung == "distributed"
    assert "restores=1" in got.report.summary()
    assert rows(got.report, False) == rows(want.report, False)
    dev1 = [ch for ch in got.report.children if ch.workload.endswith("@dev1")]
    assert dev1[0].attempts[0].outcome == "device-lost"
    assert dev1[0].final_rung is None


def test_slow_straggler_redispatch_keeps_parity(counts):
    """The first dispatch of worker 0 sleeps 3 s past a 1 s deadline; the
    supervisor re-dispatches its slice and keeps the first answer."""
    host = peel_wings(GRAPH, counts=counts["wings"], device="cpu")
    with faults.inject("slow", times=1, device=0, delay=3.0) as f:
        r = peel_wings(GRAPH, counts=counts["wings"], devices=2,
                       round_deadline_s=1.0, device="cpu")
    assert f.fired == 1
    assert np.array_equal(r.numbers, host.numbers)
    assert r.report.final_rung == "distributed"
    assert r.report.retries >= 1
    dev0 = r.report.children[0].attempts[0]
    assert dev0.retries >= 1 and "redispatches=" in dev0.detail


def test_persistent_straggler_descends_ladder(counts):
    host = peel_tips_stored(GRAPH, counts=counts["tips_stored"], side=0,
                            device="cpu")
    with faults.inject("slow", times=None, delay=0.5):
        r = peel_tips_stored(GRAPH, counts=counts["tips_stored"], side=0,
                             devices=2, round_deadline_s=0.05, device="cpu")
    assert np.array_equal(r.numbers, host.numbers)
    assert r.report.attempts[0].outcome == "straggler-timeout"
    assert r.report.final_rung == "host"
    assert r.report.degraded


def test_all_devices_lost_descends_ladder(counts):
    host = peel_tips(GRAPH, counts=counts["tips"], side=0, device="cpu")
    with faults.inject("device_loss", times=None):
        r = peel_tips(GRAPH, counts=counts["tips"], side=0, devices=2,
                      device="cpu")
    assert np.array_equal(r.numbers, host.numbers)
    assert r.report.attempts[0].outcome == "unavailable"
    assert "all 2 mesh devices lost" in r.report.attempts[0].detail
    assert r.report.final_rung == "host"


def test_run_deadline_leaves_committed_rounds_then_resumes(tmp_path,
                                                           counts):
    """A run budget that expires mid-run raises DeadlineExceeded out of
    the supervisor (the ladder records it and descends); the committed
    rounds stay in the store and a run with no deadline resumes them."""
    d = str(tmp_path / "deadline")
    c = counts["tips"]
    clean = peel_tips(GRAPH, counts=c, side=0, devices=2, device="cpu")
    # round 2's workers sleep 4 s, twice the 2 s budget; rounds 0 and 1
    # take milliseconds, so the budget runs out inside round 2
    with faults.inject("slow", site="round2.", times=None, delay=4.0):
        r = peel_tips(GRAPH, counts=c, side=0, devices=2, checkpoint=d,
                      deadline_s=2.0, device="cpu")
    assert r.report.attempts[0].outcome == "deadline-exceeded"
    assert r.report.final_rung == "host"
    assert np.array_equal(r.numbers, clean.numbers)
    committed = max(int(f[len("checkpoint_round_"):-5])
                    for f in os.listdir(d))
    assert 1 <= committed <= 2
    again = peel_tips(GRAPH, counts=c, side=0, devices=2, checkpoint=d,
                      device="cpu")
    assert again.report.final_rung == "distributed"
    assert again.report.resumed_from_round == committed
    assert_same(again, clean)


def test_supervisor_raises_deadline_exceeded(counts):
    plan = pipeline.plan_peel("peel_tips", expansion="peel_tips_2hop",
                              engine="host", aggregation="sort",
                              n_out=GRAPH.n_u, dtype="int64")

    def expand(a_ids, alive, peel):
        time.sleep(0.3)
        return np.empty(0, np.int64), ()

    sup = PeelSupervisor("w", plan, counts["tips"], expand=expand,
                         subtract=None, devices=1, deadline_s=0.1,
                         device="cpu")
    with pytest.raises(DeadlineExceeded, match="exhausted after"):
        sup.run()
    assert sup.store.latest().round_index >= 1


def test_invalid_devices_rejected():
    with pytest.raises(ValueError, match="devices"):
        PeelSupervisor(
            "w", pipeline.plan_peel(
                "w", expansion="peel_tips_2hop", engine="host",
                aggregation="sort", n_out=1,
            ),
            np.zeros(1, np.int64), expand=None, subtract=None, devices=0,
            device="cpu",
        )
    with pytest.raises(ValueError, match="devices"):
        peel_wings(GRAPH, devices=0, device="cpu")


# ---------------------------------------------------------------------------
# REPRO_FAULTS=1 chaos cells: every round boundary, a shrinking mesh
# ---------------------------------------------------------------------------


@needs_faults_job
@pytest.mark.parametrize("name", sorted(PORT))
def test_kill_at_every_round_boundary(name, counts):
    """Kill a worker at each round boundary in turn: every cell recovers
    to the clean run's numbers with exactly one rollback, and its report
    rows equal the reference's under the same fault."""
    c = counts[name]
    clean = PORT[name](GRAPH, counts=c, devices=4)
    assert clean.report.checkpoint_restores == 0
    hit = 0
    for rnd in range(clean.rounds):
        kw = dict(site=f"round{rnd}.", times=1, device=rnd % 4)
        with ref_faults.inject("device_loss", **kw):
            want = REF[name](REF_GRAPH, counts=c, devices=4)
        with faults.inject("device_loss", **kw) as f:
            r = PORT[name](GRAPH, counts=c, devices=4)
        assert_same(r, clean)
        assert r.report.checkpoint_restores == (1 if f.fired else 0)
        assert rows(r.report, False) == rows(want.report, False)
        hit += f.fired
    assert hit >= 1


@needs_faults_job
@pytest.mark.parametrize("name", sorted(PORT))
def test_mesh_shrink_mid_run(name, counts):
    c = counts[name]
    clean = PORT[name](GRAPH, counts=c)
    with faults.inject("device_loss", site="round0.", times=1, device=3) \
            as f0, \
         faults.inject("device_loss", site="round1.", times=1, device=2) \
            as f1:
        r = PORT[name](GRAPH, counts=c, devices=4)
    fired = f0.fired + f1.fired
    assert np.array_equal(r.numbers, clean.numbers)
    assert r.report.checkpoint_restores == fired
    lost = [ch for ch in r.report.children
            if ch.attempts[0].outcome == "device-lost"]
    assert len(lost) == fired >= 1


# ---------------------------------------------------------------------------
# Mesh-partitioned counting
# ---------------------------------------------------------------------------


COUNT_GRAPHS = {"small": (40, 30, 220, 0), "medium": (50, 40, 400, 3)}


def _graphs(key):
    nu, nv, m, seed = COUNT_GRAPHS[key]
    e = rand_edges(nu, nv, m, seed)
    return BipartiteGraph(nu, nv, e), ref_core.BipartiteGraph(nu, nv, e)


@pytest.mark.parametrize("direction", ["low", "high"])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
@pytest.mark.parametrize("key", sorted(COUNT_GRAPHS))
def test_partition_plans_equal_the_reference(key, n_dev, direction):
    g, rg_ref = _graphs(key)
    rg = preprocess(g, make_order(g, "degree", device="cpu"))
    rg_r = ref_preprocess(rg_ref, ref_make_order(rg_ref, "degree"))
    wv = host_wedge_counts(rg, direction)
    w, cap = plan_partition(rg, n_dev, direction, wv_slots=wv)
    w_r, cap_r = ref_dist.plan_partition(rg_r, n_dev, direction)
    assert np.array_equal(w, np.asarray(w_r)) and cap == cap_r
    for max_chunk in (16, 64, 1 << 20):
        t, c = plan_fused_partition(rg, n_dev, direction,
                                    max_chunk=max_chunk, device="cpu",
                                    wv_slots=wv)
        t_r, c_r = ref_dist.plan_fused_partition(rg_r, n_dev, direction,
                                                 max_chunk=max_chunk)
        assert t.shape == t_r.shape and np.array_equal(t, np.asarray(t_r))
        assert c == c_r


@pytest.fixture(scope="module")
def count_refs():
    out = {}
    for key in COUNT_GRAPHS:
        for cache_opt in (False, True):
            out[key, cache_opt] = ref_core.count_butterflies(
                _graphs(key)[1], mode="all", cache_opt=cache_opt)
    return out


@pytest.mark.parametrize("cache_opt", [False, True])
@pytest.mark.parametrize("engine", ["fused", "slice"])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("key", sorted(COUNT_GRAPHS))
def test_distributed_count_equals_reference(key, n_dev, engine, cache_opt,
                                            count_refs):
    want = count_refs[key, cache_opt]
    g, _ = _graphs(key)
    mesh = launch_mesh.make_test_mesh((n_dev,), ("data",), device="cpu")
    kw = dict(engine=engine, cache_opt=cache_opt, max_chunk=64)
    tot, rg = distributed_count(g, mesh, mode="global", **kw)
    assert tot.dtype == torch.int32 and int(tot) == int(want.total)
    v, rg = distributed_count(g, mesh, mode="vertex", **kw)
    v = v.numpy()
    assert np.array_equal(v[rg.rank_of_u], np.asarray(want.per_u))
    assert np.array_equal(v[rg.rank_of_v], np.asarray(want.per_v))
    e, _ = distributed_count(g, mesh, mode="edge", **kw)
    assert np.array_equal(e.numpy(), np.asarray(want.per_edge))
    shards, _ = distributed_count(g, mesh, mode="vertex", combine="scatter",
                                  precomputed_offsets=False, **kw)
    assert len(shards) == n_dev
    flat = torch.cat(shards).numpy()
    assert np.array_equal(flat[: v.shape[0]], v)
    assert not flat[v.shape[0]:].any()


def test_distributed_count_int64_and_overflow_refusal():
    """``count_dtype=None`` narrows to int32 after one check and refuses
    counts beyond it (the reference wraps); int64 is exact."""
    from repro_torch.core import AccumulatorOverflowRisk

    e = np.asarray([(u, v) for u in range(310) for v in range(310)],
                   np.int64)
    g = BipartiteGraph(310, 310, e)
    mesh = launch_mesh.make_test_mesh((2,), ("data",), device="cpu")
    with pytest.raises(AccumulatorOverflowRisk):
        distributed_count(g, mesh, mode="global", max_chunk=1 << 20)
    got, _ = distributed_count(g, mesh, mode="global", max_chunk=1 << 20,
                               count_dtype=torch.int64)
    assert int(got) == (310 * 309 // 2) ** 2


@pytest.mark.parametrize("engine", ["fused", "slice"])
def test_distributed_count_plans_from_its_prepared_graph(engine, monkeypatch,
                                                         count_refs):
    """Mesh counting plans and takes its wedge prefix from the one pass
    of its prepared graph: the numpy ``host_wedge_counts`` never runs."""
    def boom(*_a, **_k):
        raise AssertionError("host_wedge_counts called by mesh counting")

    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch") and hasattr(mod,
                                                      "host_wedge_counts"):
            monkeypatch.setattr(mod, "host_wedge_counts", boom)
    g, _ = _graphs("small")
    want = count_refs["small", False]
    mesh = launch_mesh.make_test_mesh((2,), ("data",), device="cpu")
    tot, vert, edge = distributed_count(g, mesh, mode="all", engine=engine,
                                        max_chunk=64)[0]
    assert int(tot) == int(want.total)
    assert np.array_equal(edge.numpy(), np.asarray(want.per_edge))


def test_distributed_count_fn_contract():
    g, _ = _graphs("small")
    rg = preprocess(g, make_order(g, "degree", device="cpu"))
    mesh = launch_mesh.make_test_mesh((2,), ("data",), device="cpu")
    tiles, cap = plan_fused_partition(
        rg, 2, max_chunk=64, device="cpu",
        wv_slots=host_wedge_counts(rg, "low"))
    fn = distributed_count_fn(mesh, ("data",), w_cap=cap, mode="all",
                              dtype=torch.int64, engine="fused")
    tot, vert, edge = fn(rg, tiles)
    want = ref_core.count_butterflies(_graphs("small")[1], mode="all")
    assert int(tot) == int(want.total)
    assert np.array_equal(edge.numpy(), np.asarray(want.per_edge))
    with pytest.raises(ValueError, match="rows"):
        fn(rg, tiles[:1])
    with pytest.raises(ValueError, match="engine"):
        distributed_count_fn(mesh, ("data",), w_cap=cap, mode="all",
                             engine="shard_map")
    pre = distributed_count_fn(mesh, ("data",), w_cap=cap, mode="global",
                               precomputed_offsets=True, engine="fused")
    with pytest.raises(ValueError, match="w_off"):
        pre(rg, tiles)


def test_distributed_count_matches_reference_on_4_forced_devices():
    """The reference's own ``distributed_count`` on 4 forced host devices
    (``shard_map``, through the reference's ``launch_device_worker``)
    against the port's on a 4-worker CPU mesh, bit for bit."""
    code = """
import json
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import BipartiteGraph
from repro.core.distributed import distributed_count

mesh = Mesh(np.array(jax.devices()), ("data",))
rng = np.random.default_rng(3)
e = np.stack([rng.integers(0, 50, 400), rng.integers(0, 40, 400)], axis=1)
g = BipartiteGraph(50, 40, e)
out = {}
for engine in ("fused", "slice"):
    for mode in ("global", "vertex", "edge"):
        got, rg = distributed_count(g, mesh, mode=mode, engine=engine,
                                    max_chunk=64)
        out[engine + "/" + mode] = np.asarray(got).tolist()
print("RESULT" + json.dumps(out))
"""
    out = ref_dist.launch_device_worker(code, devices=4, retries=1)
    want = json.loads(out.split("RESULT", 1)[1])
    g, _ = _graphs("medium")
    mesh = launch_mesh.make_test_mesh((4,), ("data",), device="cpu")
    for key, ref_val in want.items():
        engine, mode = key.split("/")
        got, _ = distributed_count(g, mesh, mode=mode, engine=engine,
                                   max_chunk=64)
        got = got.numpy()
        assert got.dtype == np.int32, key
        assert np.array_equal(got, np.asarray(ref_val, np.int32)), key


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def test_meshes():
    m = launch_mesh.make_test_mesh((2, 2), ("data", "model"), device="cpu")
    assert isinstance(m, DeviceMesh) and m.shape == {"data": 2, "model": 2}
    assert m.size == 4 and len(m.workers()) == 4
    assert len(m.workers(("model",))) == 2
    assert launch_mesh.available_devices("cpu") == 1
    a = launch_mesh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert a.shape == {"pod": 2, "data": 16, "model": 16}
    assert a.workers()[0] is None
    with pytest.raises(ValueError, match="256 cpu devices"):
        launch_mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        DeviceMesh(np.empty((2,), object), ("a", "b"))
    with pytest.raises(ValueError, match="unknown mesh axes"):
        m.workers(("pod",))


# ---------------------------------------------------------------------------
# Subprocess device workers
# ---------------------------------------------------------------------------


def test_device_loss_hard_raises_typed_with_index():
    with pytest.raises(DeviceLost) as ei:
        with faults.inject("device_loss"):
            launch_device_worker(
                "print('unreachable')", device_index=2, retries=1,
                backoff_s=0.01, timeout_s=120,
            )
    assert ei.value.device == 2
    assert ei.value.attempts == 2
    assert "exit code 13" in str(ei.value)
    assert isinstance(ei.value, RuntimeError)


def test_device_loss_targets_only_the_faulted_device():
    with faults.inject("device_loss", device=5) as f:
        out = launch_device_worker(
            "import os; print('OK0', os.environ['REPRO_WORKER_DEVICES'],"
            " 'XLA_FLAGS' in os.environ)",
            device_index=0, devices=3, retries=0, timeout_s=120,
        )
    assert out.split() == ["OK0", "3", "False"]
    assert f.fired == 0


def test_device_loss_transient_retry_recovers_parity():
    """``times=1`` kills only the first attempt; the retry counts with
    the port in the child and matches the count in this process."""
    code = (
        "import numpy as np\n"
        "from repro_torch.core import BipartiteGraph, count_butterflies\n"
        "rng = np.random.default_rng(7)\n"
        "e = np.stack([rng.integers(0, 30, 260),"
        " rng.integers(0, 20, 260)], axis=1)\n"
        "g = BipartiteGraph(30, 20, e)\n"
        "print('TOTAL', int(count_butterflies(g, device='cpu').total))\n"
    )
    with faults.inject("device_loss", times=1) as f:
        out = launch_device_worker(code, retries=1, backoff_s=0.05,
                                   timeout_s=300)
    assert f.fired == 1
    rng = np.random.default_rng(7)
    e = np.stack([rng.integers(0, 30, 260), rng.integers(0, 20, 260)], 1)
    want = ref_core.count_butterflies(ref_core.BipartiteGraph(30, 20, e))
    assert int(out.split("TOTAL")[1]) == int(want.total)


def test_device_loss_hang_times_out_typed():
    with pytest.raises(DeviceLost, match="timed out"):
        with faults.inject("device_loss", mode="hang"):
            launch_device_worker("print('X')", retries=0, timeout_s=1)


def test_dispatch_deadline_raises_deadline_exceeded():
    """Every attempt dies; the backoff (1 s, doubling) is clamped to the
    0.5 s budget, after which the dispatch raises DeadlineExceeded, not
    DeviceLost."""
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded, match="dispatch budget"):
        with faults.inject("device_loss"):
            launch_device_worker("print('X')", retries=5, backoff_s=1.0,
                                 timeout_s=120, deadline_s=0.5)
    assert time.monotonic() - t0 < 60


def test_subprocess_worker_slow_preamble():
    with faults.inject("slow", delay=0.5, times=1):
        t0 = time.monotonic()
        out = launch_device_worker("print(6 * 7)", timeout_s=120.0,
                                   retries=0)
        dt = time.monotonic() - t0
    assert out.strip() == "42"
    assert dt >= 0.5


def test_fault_kinds_and_worker_env():
    assert faults.KINDS == ref_faults.KINDS
    assert faults.active_kinds() == ()
    with faults.inject("slow", delay=1.5, device=1), \
            faults.inject("device_loss", mode="hang", device=2):
        assert faults.active_kinds() == ("device_loss", "slow")
        assert faults.worker_env({}, device=0) == {}
        assert faults.worker_env({}, device=1) == {
            "REPRO_FAULT_DEVICE_SLOW": "1.5"}
        assert faults.worker_env({}, device=2) == {
            "REPRO_FAULT_DEVICE_LOSS": "hang"}


# ---------------------------------------------------------------------------
# The peeling pin: the new entries are added, the old ones unchanged
# ---------------------------------------------------------------------------


# sha256 of the canonical JSON of every key the pin held before its
# PEEL_WINGS_HOST tips and range entries and PEEL_WINGS range entry
# were added, each at the values it had then
OLD_PIN_DIGEST = (
    "01dcc3681d1bab198b3fb08b979f37c0bddcca0950cda04a3abf133508670f32")
OLD_PIN_KEYS = {
    "PEEL_TIPS": ("content_hash", "exact", "generator", "graph", "m",
                  "range", "side"),
    "PEEL_WINGS": ("content_hash", "exact", "generator", "graph", "m"),
    "PEEL_WINGS_HOST": ("content_hash", "exact", "generator", "graph", "m"),
    "count_dtype": None, "engine": None, "how": None,
}


def test_peel_pin_old_entries_unchanged_and_new_ones_present():
    with open(PIN) as f:
        pin = json.load(f)
    old = {k: (pin[k] if keys is None else {kk: pin[k][kk] for kk in keys})
           for k, keys in OLD_PIN_KEYS.items()}
    digest = hashlib.sha256(json.dumps(old, sort_keys=True).encode())
    assert digest.hexdigest() == OLD_PIN_DIGEST
    host = pin["PEEL_WINGS_HOST"]
    assert host["range"]["sub_rounds"] == host["exact"]["rounds"]
    assert host["range"]["sha256_int64"] == host["exact"]["sha256_int64"]
    assert host["tips"]["range"]["sub_rounds"] == \
        host["tips"]["exact"]["rounds"]
    assert host["tips"]["side"] in (0, 1)
    assert pin["PEEL_WINGS"]["range"]["sub_rounds"] == \
        pin["PEEL_WINGS"]["exact"]["rounds"]
