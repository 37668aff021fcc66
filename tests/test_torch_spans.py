"""Spans and counters of the port's entry points (``repro_torch.core.spans``)
on the CPU: the nesting, parents and self time of spans; the documented
span names of a count and of device-engine tip and wing decompositions;
the root covered by its children; the ``rounds``, ``triple_lanes`` and
``tiles`` counters against the result; a wing decomposition's numbers
alike with spans recording, under a profiler and not at all; the
timeline, empty without a profiler and on the profiler's own clock with
one; and separate reports for threads that call at once. The card test
holds a traced count's kernel inside its spans."""
import os
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import (  # noqa: E402
    count_butterflies, peel_tips, peel_wings)
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.resilience import ExecutionReport  # noqa: E402
from repro_torch.data.graphs import powerlaw_bipartite  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the span names PERF.md lists for a fused_cuda count and a device-engine
# tip decomposition
COUNT_SPANS = {
    "count", "count.rank", "count.csr", "count.preflight",
    "count.plan_report", "count.rung", "count.wedge_counts", "count.plan",
    "count.work_list", "count.kernel", "count.to_host", "count.validate",
    "count.interpret",
}
PEEL_SPANS = {
    "peel", "peel.count", "peel.csr", "peel.level2", "peel.plan",
    "peel.rung", "peel.setup", "peel.round.select", "peel.round.fetch",
    "peel.round.expand", "peel.finish", "peel.validate",
}
WING_SPANS = {
    "peel", "peel.count", "peel.csr", "peel.wing_totals", "peel.rung",
    "peel.setup", "peel.round.select", "peel.round.fetch",
    "peel.round.expand", "peel.finish", "peel.validate",
}
COUNT_KW = dict(mode="all", engine="fused_cuda", count_dtype=torch.int64,
                device="cpu")


@pytest.fixture(scope="module")
def graph():
    return powerlaw_bipartite(600, 500, 4000, seed=7)


def _count(g):
    return count_butterflies(g, **COUNT_KW)


def _peel(g, **kw):
    return peel_tips(g, engine="device",
                     count_kwargs={"engine": "fused_cuda"}, device="cpu",
                     **kw)


def _wings(g, fn=peel_wings, **kw):
    return fn(g, engine="device", count_kwargs={"engine": "fused_cuda"},
              device="cpu", **kw)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _recorded(call: spans.Call) -> ExecutionReport:
    rep = ExecutionReport("test", "test")
    call.fill(rep)
    return rep


def _tree():
    """root a: span a.b (a.b.c inside it), then span a.d twice."""
    with spans.root("a") as call:
        with spans.span("a.b"):
            time.sleep(0.002)
            with spans.span("a.b.c"):
                time.sleep(0.003)
        for _ in range(2):
            with spans.span("a.d"):
                time.sleep(0.001)
    return call


def test_span_nesting_parents_and_self_time():
    call, _prof = _traced(_tree)
    rep = _recorded(call)
    ph = rep.phases
    assert set(ph) == {"a", "a.b", "a.b.c", "a.d"}
    assert [ph[k].n for k in ("a", "a.b", "a.b.c", "a.d")] == [1, 1, 1, 2]
    assert ph["a.b.c"].self_s == ph["a.b.c"].s >= 0.003
    assert ph["a.b"].self_s == pytest.approx(ph["a.b"].s - ph["a.b.c"].s,
                                             abs=1e-12)
    assert ph["a.b"].self_s >= 0.002
    assert ph["a"].self_s == pytest.approx(
        ph["a"].s - ph["a.b"].s - ph["a.d"].s, abs=1e-12)
    assert ph["a"].s >= ph["a.b"].s + ph["a.d"].s
    parent = {name: p for name, p, _s, _e in rep.timeline}
    assert parent == {"a": None, "a.b": "a", "a.b.c": "a.b", "a.d": "a"}
    assert [n for n, *_ in rep.timeline] == ["a.b.c", "a.b", "a.d", "a.d",
                                             "a"]
    when = {}
    for name, _p, s, e in rep.timeline:
        assert s <= e
        when.setdefault(name, []).append((s, e))
    (a0, a1), = when["a"]
    (b0, b1), = when["a.b"]
    (c0, c1), = when["a.b.c"]
    assert a0 <= b0 <= c0 <= c1 <= b1 <= a1
    assert all(b1 <= s <= e <= a1 for s, e in when["a.d"])


def test_nothing_recorded_outside_a_call():
    assert spans._CALL.get() is None
    with spans.span("loose"):
        spans.add("loose")
    assert spans._CALL.get() is None
    rep = ExecutionReport("count", "torch")
    assert rep.phases == {} and rep.counters == {} and rep.timeline == []


def test_counters_add_on_the_call():
    with spans.root("a") as call:
        spans.add("x")
        spans.add("x", 4)
        spans.add("y", 0)
    assert _recorded(call).counters == {"x": 5, "y": 0}


@pytest.mark.parametrize("mode", ["global", "all"])
def test_count_phases_are_the_documented_names(graph, mode):
    r = count_butterflies(graph, **dict(COUNT_KW, mode=mode))
    assert set(r.report.phases) == COUNT_SPANS
    ph = r.report.phases
    assert ph["count"].n == ph["count.rung"].n == ph["count.kernel"].n == 1
    assert r.report.timeline == []
    # a count bumps no counter
    assert r.report.counters == {}


@pytest.mark.parametrize("peel_mode", ["exact", "range"])
def test_tip_phases_and_rounds(graph, peel_mode):
    r = _peel(graph, peel_mode=peel_mode)
    rep = r.report
    assert set(rep.phases) == PEEL_SPANS
    assert rep.counters == {"rounds": r.rounds}
    assert r.rounds > 0
    ph = rep.phases
    # one fetch a round plus the closing one, as host_syncs counts them
    assert ph["peel.round.fetch"].n + ph["peel.finish"].n == rep.host_syncs
    assert ph["peel.round.select"].n == r.sub_rounds
    assert rep.timeline == []


@pytest.fixture(scope="module")
def wing_graph():
    return powerlaw_bipartite(200, 150, 1200, seed=7)


def test_wing_phases_and_counters(wing_graph):
    r = _wings(wing_graph)
    rep = r.report
    assert rep.final_rung == "device"
    assert set(rep.phases) == WING_SPANS
    assert set(rep.counters) == {"rounds", "triple_lanes", "tiles",
                                 "multi_tile_rounds"}
    assert rep.counters["rounds"] == r.rounds > 0
    assert rep.counters["multi_tile_rounds"] == 0  # 2^20-lane tiles
    ph = rep.phases
    for name in ("peel.count", "peel.csr", "peel.wing_totals",
                 "peel.setup"):
        assert ph[name].n == 1, name
    assert ph["peel.round.fetch"].n + ph["peel.finish"].n == rep.host_syncs
    # the last round expands nothing: at most one tile a round before it
    assert 0 < rep.counters["tiles"] <= r.rounds - 1
    assert rep.counters["triple_lanes"] > 0


def test_wing_counters_follow_the_tiles(wing_graph):
    """The triple space streamed does not depend on the tiling; small
    tiles multiply the tile enqueues by about the lanes over the tile."""
    from repro_torch.core.peel import _csr, _wing_work_totals

    big = _wings(wing_graph).report.counters
    # 256 lanes a tile: a power of two above the 128-lane floor
    small = _wings(wing_graph, tile_budget=256).report.counters
    lanes = big["triple_lanes"]
    assert small["triple_lanes"] == lanes
    _eu, _ev, _l1, l2 = _wing_work_totals(wing_graph,
                                          *_csr(wing_graph)[:2])
    assert lanes <= int(l2.sum())
    assert lanes / 256 <= small["tiles"] <= lanes / 256 + big["rounds"]
    # each round the counter counts took two tiles or more
    assert 0 < 2 * small["multi_tile_rounds"] <= small["tiles"]
    assert big["multi_tile_rounds"] == 0


def test_wing_numbers_alike_with_spans_on_and_off(wing_graph):
    """Spans recording under a profiler, recording with none, and not
    recording at all (the undecorated function opens no call) give the
    same numbers, which are the host engine's."""
    plain = _wings(wing_graph)
    traced, _prof = _traced(lambda: _wings(wing_graph))
    bare = _wings(wing_graph, fn=peel_wings.__wrapped__)
    assert bare.report.phases == {} and bare.report.counters == {}
    host = peel_wings(wing_graph, device="cpu")
    for r in (traced, bare, host):
        assert np.array_equal(r.numbers, plain.numbers)
        assert r.rounds == plain.rounds
    assert {name for name, *_ in traced.report.timeline} == WING_SPANS
    assert plain.report.timeline == []


@pytest.mark.parametrize("which", ["count", "peel"])
def test_root_children_cover_the_root(graph, which):
    r = _count(graph) if which == "count" else _peel(graph)
    root = r.report.phases[which]
    assert root.s - root.self_s >= 0.95 * root.s
    rung = r.report.phases[which + ".rung"]
    assert rung.s <= root.s


def test_nested_count_is_one_span_of_the_decomposition(graph):
    r = _peel(graph)
    assert not any(k.startswith("count") for k in r.report.phases)
    assert r.report.phases["peel.count"].n == 1


def test_disabled_policy_attaches_no_report(graph):
    r = count_butterflies(graph, resilience=False, **COUNT_KW)
    assert r.report is None


def test_timeline_only_under_a_profiler(graph):
    assert _count(graph).report.timeline == []
    r, _prof = _traced(lambda: _count(graph))
    tl = r.report.timeline
    assert {name for name, *_ in tl} == COUNT_SPANS
    assert len(tl) == sum(p.n for p in r.report.phases.values())
    assert [p for name, p, *_ in tl if name == "count"] == [None]
    assert {p for name, p, *_ in tl if name == "count.kernel"} == {
        "count.rung"}


def test_aten_ops_lie_inside_their_span_on_the_profilers_clock(graph):
    """The kernel's plain version runs its aten ops inside
    ``count.kernel``: the profiler stamps them on its clock, the span on
    the one it documents, and the span holds every one."""
    r, prof = _traced(lambda: _count(graph))
    (k0, k1), = [(s, e) for name, _p, s, e in r.report.timeline
                 if name == "count.kernel"]
    events = list(prof.profiler.kineto_results.events())
    rf, = [(ev.start_ns(), ev.end_ns()) for ev in events
           if ev.name() == "count.kernel"]
    ops = [(ev.start_ns(), ev.end_ns()) for ev in events
           if ev.name().startswith("aten::")
           and rf[0] <= ev.start_ns() and ev.end_ns() <= rf[1]]
    assert len(ops) > 10
    assert all(k0 <= s <= e <= k1 for s, e in ops)


def test_threads_keep_separate_reports(graph):
    """More threads than cores, counting and peeling at once with a short
    switch interval: every report holds its own call's spans alone."""
    other = powerlaw_bipartite(300, 250, 2000, seed=3)
    n = (os.cpu_count() or 1) + 1
    start = threading.Barrier(n)
    out = [None] * n

    def run(i):
        start.wait()
        out[i] = [_count(graph) if i % 2 else _peel(other)
                  for _ in range(2)]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i, results in enumerate(out):
        assert results is not None and len(results) == 2
        for r in results:
            rep = r.report
            if i % 2:
                assert set(rep.phases) == COUNT_SPANS
                assert rep.phases["count"].n == 1
                assert rep.phases["count.rung"].n == 1
                assert "rounds" not in rep.counters
            else:
                assert set(rep.phases) == PEEL_SPANS
                assert rep.phases["peel"].n == 1
                assert rep.counters["rounds"] == r.rounds
                assert rep.phases["peel.round.fetch"].n + 1 == rep.host_syncs
    assert spans._CALL.get() is None


@pytest.mark.cuda
def test_traced_count_kernel_lies_inside_its_spans():
    """In a traced count on the card, each ``fused_heavy_kernel`` device
    interval lies between the start of its call's ``count.kernel`` and
    the end of its ``count.to_host``: the program's spans and the
    profiler's device records share one clock. A one-call trace can drop
    its device records, so three calls are traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = powerlaw_bipartite(20_000, 15_000, 200_000, seed=7)
    kw = dict(COUNT_KW, device="cuda")
    count_butterflies(g, **kw)  # warm: the kernels' library
    launched = ops.LAUNCHES["fused_count_tiles"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runs = [count_butterflies(g, **kw) for _ in range(3)]
    assert ops.LAUNCHES["fused_count_tiles"] - launched == len(runs)
    windows = []
    for r in runs:
        tl = {name: (s, e) for name, _p, s, e in r.report.timeline}
        windows.append((tl["count.kernel"][0], tl["count.to_host"][1]))
    heavy = [(ev.start_ns(), ev.end_ns())
             for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == torch.autograd.DeviceType.CUDA
             and "fused_heavy_kernel" in ev.name()]
    assert heavy, "no fused_heavy_kernel record in the trace"
    for s, e in heavy:
        assert any(w0 <= s <= e <= w1 for w0, w1 in windows), (s, e, windows)
    assert np.all(np.diff([w[0] for w in windows]) > 0)
