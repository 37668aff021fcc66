"""The SCALE 14 wing cell, ``graph500-s14.peel-wings-limited``: a sound
run on the CPU at a small size is correct; a call still running at the
mix's ``call_limit_s`` is cut, a failed call in the window and the end of
the run in set-up; its one metric, ``multi_tile_share.wings14``, prints
in a traced run, reads the program's ``multi_tile_rounds`` counter and
stays silent in the other cells, whose readers stay silent in this
one's."""
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from perfbench import harness
from perfbench.devtrace import Tracer

CELL = "graph500-s14.peel-wings-limited"
METRIC = "multi_tile_share.wings14"
SPEC = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())
SEED = 2**33 + 17


def _run(seconds, sizes, trace=False, patch=None):
    run = harness.Run(CELL, SEED, seconds, trace, "cpu", sizes=sizes)
    if patch:
        patch(run)
    return run, harness.execute(run)


def _host_trace(run):
    """The CPU has no device records: trace the host, so that every
    reader that reads a trace has one."""
    run.tracer = Tracer(True, run.tracer.trace_s, True)


def test_the_mix_is_the_wing_call_with_a_limit():
    limited = harness.load_json("traffic", "peel-wings-limited")
    plain = harness.load_json("traffic", "peel-wings")
    assert limited["call"] == plain["call"]
    assert limited["kind"] == "closed_wings_limited"
    assert limited["call_limit_s"] == 120
    assert (limited["trace_s"], limited["trace_host"]) == (1, False)


def test_sound_small_run_is_correct():
    run, out = _run(1.5, {"SCALE": 10})
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == {"missing", "wing_diff"}
    assert all(c["limit"] == 0 for c in out["checks"].values())
    assert set(out["metrics"]) == {"peel_s", "setup_s"}
    assert all(c["op"] == "wings_limited" for c in run.calls)
    assert all(c["report"].final_rung == "device" for c in run.calls)


def _slow_after(n_fast):
    """``peel_wings`` that answers its first ``n_fast`` calls and sleeps
    through every later one."""
    import repro_torch.core as core

    orig, made = core.peel_wings, []

    def slow(g, **kw):
        made.append(1)
        if len(made) > n_fast:
            time.sleep(60)
        return orig(g, **kw)

    return core, slow


def test_slow_call_in_the_window_fails(monkeypatch):
    """The warm call answers, the window's first call sleeps: it is cut
    at the limit, counted as failed and missing, and the reference is
    not run (each answered call's edges count as not compared)."""
    core, slow = _slow_after(1)
    monkeypatch.setattr(core, "peel_wings", slow)

    def short_limit_in_the_window(run):
        window = run.kind.window

        def limited(run_, st):
            run_.mix["call_limit_s"] = 0.5
            window(run_, st)

        monkeypatch.setattr(run.kind, "window", limited)

    t = time.perf_counter()
    run, out = _run(0.2, {"SCALE": 8}, patch=short_limit_in_the_window)
    assert time.perf_counter() - t < 60
    assert not out["correct"]
    assert out["failed"] == out["attempted"] == 1
    assert "cut" in run.calls[0]["error"]
    assert out["checks"]["missing"]["value"] == 1
    assert out["checks"]["wing_diff"]["value"] == 0  # no call answered
    assert 0.5 <= run.calls[0]["t1"] < 5


def test_slow_warm_call_ends_set_up(monkeypatch):
    """A warm call past the limit ends the run in set-up, within about
    the limit of the call's start."""
    core, slow = _slow_after(0)
    monkeypatch.setattr(core, "peel_wings", slow)
    run = harness.Run(CELL, SEED, 0.2, False, "cpu", sizes={"SCALE": 8})
    run.mix["call_limit_s"] = 0.5
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="cut at its limit"):
        harness.execute(run)
    assert time.perf_counter() - t < 15
    assert run.calls == []


def test_slow_warm_call_exits_non_zero():
    """The same in a process of its own: it exits non-zero, and soon."""
    script = textwrap.dedent(f"""
        import time
        from perfbench import harness
        import repro_torch.core as core

        def slow(g, **kw):
            time.sleep(60)

        core.peel_wings = slow
        run = harness.Run({CELL!r}, 1, 0.2, False, "cpu",
                          sizes={{"SCALE": 6}})
        run.mix["call_limit_s"] = 1.0
        harness.execute(run)
    """)
    root = harness.BENCH.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "src")]))
    t = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "cut at its limit of 1.0 s" in p.stderr
    assert time.perf_counter() - t < 60


def test_limit_restores_the_alarm():
    from perfbench.traffic import closed_wings_limited as kind
    import signal

    before = signal.getsignal(signal.SIGALRM)
    with kind._limited(30):
        assert signal.getitimer(signal.ITIMER_REAL)[0] > 0
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0
    assert signal.getsignal(signal.SIGALRM) == before
    with pytest.raises(kind.CallCut):
        with kind._limited(0.05):
            time.sleep(5)


def test_traced_run_prints_the_metric_alone():
    """With every trace reader given a trace, the cell's run prints its
    own metric and no other cell's; the share is a per cent of rounds."""
    run, out = _run(1.5, {"SCALE": 10}, trace=True, patch=_host_trace)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {METRIC}
    got = out["metrics"][METRIC]
    assert got["unit"] == "%"
    assert 0 <= got["value"] <= 100
    c = run.steady("wings_limited")
    multi = sum(x["report"].counters["multi_tile_rounds"] for x in c)
    rounds = sum(x["report"].counters["rounds"] for x in c)
    assert got["value"] == pytest.approx(100.0 * multi / rounds)


def test_metric_names_its_one_cell():
    m = next(x for x in SPEC["per_layer"] if x["name"] == METRIC)
    assert m["workloads"] == [CELL]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == \
        ("%", "lower", "program_counter", "peel_s")
    assert m["layer"] == \
        "peeling round loop (core/peel.py, core/pipeline.py)"
    peel_s = next(e for e in SPEC["end_to_end"] if e["name"] == "peel_s")
    assert CELL in peel_s["workloads"]
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("graph500-s14-wings", "peel-wings-limited", 1)


def test_the_configuration_is_the_tip_graph_under_the_wing_query():
    """``graph500-s14-wings`` draws the tip cell's graph (the same
    generator numbers, so the same graph at every seed) and states the
    wing query's guarantee, under a source of its own."""
    wings = harness.load_json("configs", "graph500-s14-wings")
    tips = harness.load_json("configs", "graph500-s14")
    gen = ("SCALE", "edgefactor", "initiator", "reduced", "source_SCALE",
           "assumed", "deployment")
    assert {k: wings[k] for k in gen} == {k: tips[k] for k in gen}
    assert "the exact wing number of every edge" in wings["guarantees"]
    assert wings["source"] != tips["source"]
    entry = next(c for c in SPEC["configs"]
                 if c["name"] == "graph500-s14-wings")
    assert entry["source"] == wings["source"]
    assert [w["name"] for w in SPEC["workloads"]
            if w["config"] == "graph500-s14-wings"] == [CELL]


class _Report:
    def __init__(self, counters):
        self.counters = counters


def _reader():
    return harness.load_module(harness.BENCH / "metrics" / f"{METRIC}.py")


@pytest.mark.parametrize("cell,op", [
    ("graph500-s17.count-all", "count"),
    ("graph500-s14.peel-tips", "peel"),
    ("graph500-s12.peel-wings", "wings"),
])
def test_metric_is_silent_in_the_other_cells(cell, op):
    """Another cell's calls, even with the counter on their reports."""
    run = harness.Run(cell, 1, 0.1, False, "cpu", sizes={"SCALE": 6})
    run.calls = [{"op": op, "report": _Report(
        {"multi_tile_rounds": 3, "rounds": 10})}]
    assert _reader().read(run) is None


def test_metric_is_silent_without_the_counter():
    """A program that keeps no ``multi_tile_rounds`` counter reads
    nothing, and does not raise."""
    run = harness.Run(CELL, 1, 0.1, False, "cpu", sizes={"SCALE": 6})
    run.calls = [{"op": "wings_limited", "report": _Report({"rounds": 10})}]
    assert _reader().read(run) is None
    run.calls[0]["report"] = _Report({"rounds": 8, "multi_tile_rounds": 2})
    assert _reader().read(run) == 25.0
