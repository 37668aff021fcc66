"""The correctness check fails where it must: each fault a cell can
have, planted in the timed path under a run driven on the CPU at a small
size, and the control (the reference in the program's place, one step
below the stated precision) make ``correct`` false; a sound run and the
exact reference in the program's place make it true."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference.counting import count_all

SMALL = {"SCALE": 10}  # 2 x 1,024 vertices, about 13k edges
COUNT = "graph500-s17.count-all"
PEEL = "graph500-s14.peel-tips"
CELLS = [COUNT, PEEL]


def _run(cell, seconds=0.5, sizes=SMALL, patch=None, trace=False):
    run = harness.Run(cell, 2**31 + 99, seconds, trace, "cpu", sizes=sizes)
    if patch:
        patch(run)
    return harness.execute(run)


def _dense(cfg, seed):
    """A graph dense enough that counts pass 2**24 (float32) and the
    total 2**31 (int32) at a size the CPU holds; a Kronecker graph
    that small is too sparse for either."""
    rng = np.random.default_rng(seed % (1 << 32))
    key = rng.choice(100 * 3000, size=200_000, replace=False)
    return 100, 3000, np.stack([key // 3000, key % 3000], 1)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell, seconds=1.5)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(c["limit"] == 0 for c in out["checks"].values())


def _alter(field_fn):
    """Patch the program where a count's answer is produced."""
    import repro_torch.core.count as count

    orig = count.interpret_counts

    def altered(rg, g, mode, out, aggregation, order):
        r = orig(rg, g, mode, out, aggregation, order)
        return field_fn(r)

    return count, altered


def _plus_one(r):
    if r.per_edge is not None:
        pe = r.per_edge.copy()
        pe[0] += 1
        return r._replace(per_edge=pe)
    if r.per_u is not None:
        pu = r.per_u.copy()
        pu[0] += 1
        return r._replace(per_u=pu)
    return r._replace(total=np.asarray(r.total) + 1)


def _half_left_out(r):
    """Half of the vertices and edges left out, the rest kept."""
    out = {}
    for f in ("per_u", "per_v", "per_edge"):
        a = getattr(r, f)
        if a is not None:
            a = a.copy()
            a[a.size // 2:] = 0
            out[f] = a
    if r.total is not None:
        out["total"] = np.asarray(r.total) // 2
    return r._replace(**out)


@pytest.mark.parametrize("fault", [_plus_one, _half_left_out],
                         ids=["answer_altered", "half_left_out"])
def test_count_faults_fail(fault, monkeypatch):
    count, altered = _alter(fault)
    monkeypatch.setattr(count, "interpret_counts", altered)
    out = _run(COUNT, seconds=1.5)
    assert not out["correct"], out["checks"]


def _peel_fault(kind):
    import repro_torch.core as core

    orig = core.peel_tips

    def broken(g, **kw):
        r = orig(g, **kw)
        num = np.asarray(r.numbers).copy()
        if kind == "unchanged":
            # rounds that take nothing away: each vertex keeps its count
            c = core.count_butterflies(g, mode="vertex", device="cpu",
                                       count_dtype=torch.int64)
            num = np.asarray(c.per_u if r.side == 0 else c.per_v)
        elif kind == "half":
            num[num.size // 2:] = 0
        else:
            num[0] += 1
        return r._replace(numbers=num)

    return core, broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_peel_faults_fail(kind, monkeypatch):
    core, broken = _peel_fault(kind)
    monkeypatch.setattr(core, "peel_tips", broken)
    out = _run(PEEL)
    assert not out["correct"], out["checks"]
    assert out["checks"]["tip_diff"]["value"] > 0


def _reference_in_place(dtype):
    """The kind's call replaced by the reference's answer in ``dtype``."""

    def patch(run):
        def call(run, st):
            c = count_all(*run.sizes, st["edges"], dtype=dtype)
            return _Answer(np.asarray(c.total), c.per_u.numpy(),
                           c.per_v.numpy(), c.per_edge.numpy(), None)

        run.kind._call = call

    return patch


class _Answer:
    def __init__(self, total, per_u, per_v, per_edge, report):
        self.total, self.per_u, self.per_v = total, per_u, per_v
        self.per_edge, self.report = per_edge, report


@pytest.mark.parametrize("dtype,correct", [(torch.int64, True),
                                           (torch.int32, False),
                                           (torch.float32, False)])
def test_control_in_the_programs_place(dtype, correct, monkeypatch):
    import perfbench.loop

    monkeypatch.setattr(perfbench.loop, "cell_graph", _dense)
    out = _run(COUNT, seconds=0.01, patch=_reference_in_place(dtype))
    assert out["correct"] is correct, out["checks"]


def test_traced_run_reads_per_layer_metrics():
    out = _run(COUNT, seconds=0.5, trace=True)
    assert {"exec_s.count", "prep_s.count"} <= set(out["metrics"])
    assert "count_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         COUNT, "--seed", str(2**31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def _no_result(p):
    last = (p.stdout.strip().splitlines() or [""])[-1]
    return p.returncode != 0 and not last.startswith("{")


def test_cli_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    assert _no_result(_cli(harness.BENCH.parent, env))


def _bench_only(tmp_path):
    root = harness.BENCH.parent
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_benchmark_alone_prints_no_result(tmp_path):
    assert _no_result(_cli(_bench_only(tmp_path)))


@pytest.mark.cuda
def test_benchmark_alone_prints_no_result_on_the_card(tmp_path,
                                                      cuda_device):
    p = _cli(_bench_only(tmp_path))
    assert _no_result(p), p.stdout[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_run_on_the_card(cell, cuda_device):
    run = harness.Run(cell, 2**31 + 7, 1.5, False, cuda_device, sizes=SMALL)
    out = harness.execute(run)
    assert out["correct"], json.dumps(out["checks"])


def test_bucketed_control_in_the_programs_place():
    """The tip cell's control: approximate rounds in place of the
    decomposition."""
    from perfbench.control import bucketed_tips
    from perfbench.reference.tips import peel_side

    class _Peel:
        def __init__(self, side, numbers):
            self.side, self.numbers, self.report = side, numbers, None

    def patch(run):
        def call(run, st):
            e = st["edges"]
            side = peel_side(*run.sizes, e)
            c = count_all(*run.sizes, e)
            return _Peel(side, bucketed_tips(
                *run.sizes, e, side,
                c.per_u if side == 0 else c.per_v, "cpu").numpy())

        run.kind._call = call

    out = _run(PEEL, seconds=0.01, patch=patch)
    assert not out["correct"] and out["checks"]["tip_diff"]["value"] > 0
