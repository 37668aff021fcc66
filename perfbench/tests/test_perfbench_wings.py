"""The wing cell, ``graph500-s12.peel-wings``: the plain wing reference
against the k-wing's definition and against the program's two engines;
a sound run on the CPU at a small size is correct, and each fault
planted in the timed path, an approximate decomposition in the
program's place, and a call answered off the device rung make it
incorrect; the wing problem's roofline counts its triples as brute
force does; a traced run prints the cell's per-layer metrics."""
import json

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.devtrace import Tracer
from perfbench.generator import cell_graph
from perfbench.reference.counting import count_all
from perfbench.reference.wings import wing_numbers
from perfbench.wing_roofline import wing_bound, wing_triples

CELL = "graph500-s12.peel-wings"
SMALL = {"SCALE": 9}  # 2 x 512 vertices, about 5.7k edges
SPEC = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())
METRICS = {"round_ms.wings", "round_host_ms.wings", "prep_s.wings",
           "idle_share.wings", "wings_roofline"}
SPAN_METRICS = {"round_ms.wings", "round_host_ms.wings", "prep_s.wings"}


def _kronecker(scale, seed):
    cfg = dict(harness.load_json("configs", "graph500-s12"), SCALE=scale)
    return cell_graph(cfg, seed)


def _random(n_u, n_v, m, seed):
    rng = np.random.default_rng(seed)
    key = rng.choice(n_u * n_v, size=m, replace=False)
    return n_u, n_v, np.stack([key // n_v, key % n_v], 1)


SMALL_GRAPHS = [
    _random(8, 7, 30, 0), _random(12, 10, 60, 1), _random(20, 15, 120, 2),
    _random(30, 25, 200, 3),
    (3, 4, np.array([[0, 0], [0, 1], [1, 0], [1, 1], [2, 3]])),
    _kronecker(5, 7),
]
KRONECKER = [_kronecker(8, 2**31 + 5), _kronecker(9, 2**40 + 3)]


def _gid(g):
    return f"{g[0]}x{g[1]}-{len(g[2])}"


def _butterflies_per_edge(a):
    """Per-edge butterfly counts of the dense 0/1 matrix ``a``, zero
    off its edges."""
    p = a @ a.T
    np.fill_diagonal(p, 0)
    c = p @ a - (a.sum(0, keepdims=True) - 1)
    return np.where(a > 0, c, 0)


def brute_wings(n_u, n_v, e):
    """By the definition: the k-wing is what is left once every edge in
    fewer than k butterflies of what is left has gone; an edge's wing
    number is the largest k whose k-wing holds it. The k-wings nest, so
    each is cut from the one before."""
    a = np.zeros((n_u, n_v), dtype=np.int64)
    a[e[:, 0], e[:, 1]] = 1
    out = np.zeros(len(e), dtype=np.int64)
    k = 0
    while a.any():
        k += 1
        while True:
            low = (a > 0) & (_butterflies_per_edge(a) < k)
            if not low.any():
                break
            a[low] = 0
        out[a[e[:, 0], e[:, 1]] > 0] = k  # still in the k-wing
    return out


@pytest.mark.parametrize("g", SMALL_GRAPHS, ids=_gid)
@pytest.mark.parametrize("block", [1 << 24, 5])
def test_reference_is_the_k_wing(g, block):
    n_u, n_v, e = g
    counts = count_all(n_u, n_v, e).per_edge
    kept = counts.clone()
    got = wing_numbers(n_u, n_v, e, counts, block=block)
    assert np.array_equal(got.numbers.numpy(), brute_wings(n_u, n_v, e))
    assert torch.equal(counts, kept)  # the caller's counts stay


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("g", KRONECKER, ids=_gid)
def test_reference_equals_the_program(g, engine):
    from repro_torch.core import BipartiteGraph, peel_wings

    n_u, n_v, e = g
    want = wing_numbers(n_u, n_v, e, count_all(n_u, n_v, e).per_edge)
    r = peel_wings(BipartiteGraph(n_u, n_v, e), engine=engine,
                   device="cpu")
    assert np.array_equal(np.asarray(r.numbers), want.numbers.numpy())
    assert want.rounds > 1


def _run(seconds=0.5, patch=None, trace=False):
    run = harness.Run(CELL, 2**31 + 99, seconds, trace, "cpu", sizes=SMALL)
    if patch:
        patch(run)
    return run, harness.execute(run)


def test_sound_run_is_correct():
    run, out = _run(seconds=1.5)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"missing", "wing_diff"}
    assert all(c["limit"] == 0 for c in out["checks"].values())
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"peel_s", "setup_s"}
    assert all(c["report"].final_rung == "device" for c in run.calls)


def _wing_fault(kind):
    import repro_torch.core as core

    orig = core.peel_wings

    def broken(g, **kw):
        r = orig(g, **kw)
        num = np.asarray(r.numbers).copy()
        if kind == "unpeeled":
            # rounds that take nothing away: each edge keeps its count
            c = core.count_butterflies(g, mode="edge", device="cpu",
                                       count_dtype=torch.int64)
            num = np.asarray(c.per_edge)
        elif kind == "half":
            num[num.size // 2:] = 0
        else:
            num[0] += 1
        return r._replace(numbers=num)

    return core, broken


@pytest.mark.parametrize("kind", ["unpeeled", "half", "altered"])
def test_wing_faults_fail(kind, monkeypatch):
    core, broken = _wing_fault(kind)
    monkeypatch.setattr(core, "peel_wings", broken)
    _r, out = _run()
    assert not out["correct"], out["checks"]
    assert out["checks"]["wing_diff"]["value"] > 0


def bucketed_wings(n_u, n_v, e, counts):
    """Wing numbers from rounds that peel every edge below twice the
    least count at once and give them all the least: an approximation,
    not the decomposition."""
    e = torch.as_tensor(e)
    m = e.shape[0]
    cnt = torch.as_tensor(counts).clone()
    live = torch.ones(m, dtype=torch.bool)
    out = torch.zeros(m, dtype=torch.int64)
    level = 0
    while bool(live.any()):
        low = int(torch.where(live, cnt, cnt.max() + 1).min())
        level = max(level, low)
        out[live & (cnt < 2 * low + 1)] = level
        live &= ~(cnt < 2 * low + 1)
        # what the surviving edges lose: recount the live subgraph
        keep = torch.nonzero(live).squeeze(1)
        if keep.numel():
            cnt[keep] = count_all(n_u, n_v, e[keep]).per_edge
    return out.numpy()


class _Wings:
    def __init__(self, numbers, report):
        self.numbers, self.report = numbers, report


class _Report:
    final_rung = "device"


def test_bucketed_control_in_the_programs_place():
    def patch(run):
        def call(run, st):
            e = st["edges"]
            c = count_all(*run.sizes, e).per_edge
            return _Wings(bucketed_wings(*run.sizes, e, c), _Report())

        run.kind._call = call

    _r, out = _run(seconds=0.01, patch=patch)
    assert not out["correct"] and out["checks"]["wing_diff"]["value"] > 0


def test_call_off_the_device_rung_fails(monkeypatch):
    """A decomposition that the ladder answered on the host rung is a
    failed call: counted, missing from the comparison, not correct."""
    import repro_torch.core as core

    orig = core.peel_wings
    made = []

    def on_host(g, **kw):
        r = orig(g, **kw)
        if made:  # the warm call of set-up stays as it was
            r.report.final_rung = "host"
        made.append(r)
        return r

    monkeypatch.setattr(core, "peel_wings", on_host)
    _r, out = _run()
    assert not out["correct"]
    assert out["failed"] == out["attempted"] >= 1
    assert out["checks"]["missing"]["value"] == out["attempted"]


def _brute_triples(n_u, n_v, e):
    du = np.bincount(e[:, 0], minlength=n_u)
    nbr_v = [e[e[:, 1] == v, 0] for v in range(n_v)]
    return sum(min(du[u1], du[u2]) for u1, v1 in e for u2 in nbr_v[v1])


@pytest.mark.parametrize("g", SMALL_GRAPHS + KRONECKER[:1], ids=_gid)
def test_wing_triples_by_brute_force(g):
    n_u, n_v, e = g
    assert wing_triples(n_u, n_v, e) == _brute_triples(n_u, n_v, e)


def test_wing_triples_are_the_programs_triple_space():
    from repro_torch.core import BipartiteGraph
    from repro_torch.core.peel import _csr, _wing_work_totals

    n_u, n_v, e = KRONECKER[1]
    g = BipartiteGraph(n_u, n_v, e)
    l2 = _wing_work_totals(g, *_csr(g)[:2])[3]
    assert wing_triples(n_u, n_v, e) == int(l2.sum())


def test_wing_bound():
    # SCALE 12's figures: ops set the bound
    t, by = wing_bound(53_463, 254_850_309)
    assert by == "ops" and t == pytest.approx(2 * 254_850_309 / 16.7e12)
    t, by = wing_bound(10**6, 10)
    assert by == "bytes" and t == pytest.approx(24e6 / 3.35e12)


def test_traced_run_prints_the_metrics():
    """On the CPU the device-only trace records nothing, so the trace
    records the host: the span metrics and the roofline, whose kernel
    time is then the CPU's, read; idle share needs device records."""

    def host_trace(run):
        run.tracer = Tracer(True, run.tracer.trace_s, True)

    run, out = _run(seconds=1.5, trace=True, patch=host_trace)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert SPAN_METRICS <= set(got), sorted(got)
    assert set(got) <= METRICS
    for name in SPAN_METRICS:
        assert got[name]["value"] > 0, (name, got[name])
    assert run.facts["triples"] == wing_triples(*run.sizes, _kronecker(
        9, 2**31 + 99)[2])
    for c in run.steady("wings"):
        ph = c["report"].phases
        assert ph["peel"].s <= c["t1"] - c["t0"]
        assert {"peel.count", "peel.csr", "peel.wing_totals",
                "peel.setup"} <= set(ph)
        assert c["report"].counters["triple_lanes"] > 0


def test_metrics_name_their_one_cell():
    by_name = {m["name"]: m for m in SPEC["per_layer"]}
    for name in METRICS:
        m = by_name[name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "peel_s"
    peel_s = next(e for e in SPEC["end_to_end"] if e["name"] == "peel_s")
    assert CELL in peel_s["workloads"]


def test_other_kinds_read_no_wing_metric():
    """The wing readers stay silent in the other cells' runs, and theirs
    in this cell's: each reads its own op or kind alone."""
    run = harness.Run("graph500-s14.peel-tips", 1, 0.1, False, "cpu",
                      sizes={"SCALE": 6})
    run.calls = [{"op": "peel", "report": None}]
    for name in METRICS:
        mod = harness.load_module(harness.BENCH / "metrics" / f"{name}.py")
        assert mod.read(run) is None, name

