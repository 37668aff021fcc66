"""The per-layer metrics that read the program's spans and counters: a
traced run of each cell on the CPU at the small size prints every one,
none negative, and no span of a call outlasts the call."""
import json

import pytest

from perfbench import harness
from perfbench.devtrace import Tracer

SMALL = {"SCALE": 10}  # the size of test_perfbench_checks.py's runs
SPEC = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())
SPAN_METRICS = {
    "graph500-s17.count-all": {
        "rank_s.count", "csr_s.count", "plan_report_s.count",
        "host_plan_s.count", "device_wait_s.count", "unspanned_s.count"},
    "graph500-s14.peel-tips": {
        "prep_s.peel", "round_host_ms.peel", "round_wait_ms.peel"},
}
OP = {"graph500-s17.count-all": "count", "graph500-s14.peel-tips": "peel"}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_run_prints_the_span_metrics(cell):
    run = harness.Run(cell, 2**31 + 11, 1.5, True, "cpu", sizes=SMALL)
    if not run.tracer.host:
        # a mix that traces the device alone has nothing to record on
        # the CPU: the test's trace records the host instead
        run.tracer = Tracer(True, run.tracer.trace_s, True)
    out = harness.execute(run)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert SPAN_METRICS[cell] <= set(got), sorted(got)
    for name in SPAN_METRICS[cell]:
        assert got[name]["value"] >= 0, (name, got[name])
    calls = run.steady(OP[cell])
    assert calls
    for c in calls:
        ph = c["report"].phases
        root = ph[OP[cell]]
        assert root.s <= c["t1"] - c["t0"]
        assert all(p.s <= root.s and 0 <= p.self_s <= p.s + 1e-9
                   for p in ph.values())


def test_span_metrics_name_their_one_cell():
    by_name = {m["name"]: m for m in SPEC["per_layer"]}
    for cell, names in SPAN_METRICS.items():
        for name in names:
            m = by_name[name]
            assert m["workloads"] == [cell]
            assert m["source"] == "program_span"
