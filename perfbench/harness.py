"""The benchmark's harness: one cell, one process, one result line.

Everything that belongs to one cell is data found by name:

* ``workloads/<cell>.json``: the configuration, the traffic mix and the
  chips of the cell;
* ``configs/<config>.json``: the deployment (the generator's
  parameters, the cuts of scale, the guarantees);
* ``traffic/<mix>.json``: the mix's parameters, with the ``kind`` of
  loop that drives it, ``traffic/<kind>.py``;
* ``metrics/<metric>.py``: one reader per per-layer metric.

A run: set-up (generation, the program's objects, one warm pass of the
cell's own calls), a window of ``--seconds``, then, with the program's
state freed, the comparison with the plain reference. With ``--trace 1``
the window is traced (``devtrace.Tracer``) and the per-layer metrics are
printed in place of the end-to-end ones.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import resource
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from .devtrace import Tracer

__all__ = ["BENCH", "Run", "load_json", "load_module", "execute",
           "FORBIDDEN_MODULES", "forbidden_loaded"]

BENCH = Path(__file__).resolve().parent
# top-level modules the process may not hold once the window has closed
# (the reference package and its framework), compared as whole names
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(folder: str, name: str) -> dict:
    path = BENCH / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    """Import a file by path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (by default the
    modules this process holds)."""
    tops = {n.split(".")[0] for n in (list(sys.modules) if names is None
                                      else names)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


class Run:
    """One run of one cell: its files, its arguments, and what the
    window recorded (``calls``, one dict per call or query, and the
    harness's ``spans``)."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device, t0: Optional[float] = None,
                 sizes: Optional[dict] = None):
        self.name = workload
        self.cell = load_json("workloads", workload)
        self.cfg = load_json("configs", self.cell["config"])
        self.mix = load_json("traffic", self.cell["traffic"])
        self.cfg.update(sizes or {})  # the tests' small graphs
        self.sizes = None  # (n_u, n_v) of the run's graph, set by set-up
        self.kind_name = self.mix["kind"]
        self.kind = load_module(BENCH / "traffic" / f"{self.kind_name}.py")
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t0 = time.perf_counter() if t0 is None else t0
        self.tracer = Tracer(self.trace, self.mix.get("trace_s",
                                                      self.seconds),
                             self.mix.get("trace_host", True))
        self.calls: List[dict] = []
        self.spans: List[tuple] = []
        self.facts: Dict[str, float] = {}
        self.host: Dict[str, float] = {}  # the window's wall and CPU time

    @contextlib.contextmanager
    def span(self, name: str):
        """A harness span around one call into a layer (host clock,
        and a named range in the trace)."""
        t = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.spans.append((name, t, time.perf_counter()))

    def steady(self, op: str) -> List[dict]:
        """The window's answered calls of ``op`` that ran with the trace
        off (all of them where every call was traced): what the
        program's own clocks and counters are read from."""
        done = [c for c in self.calls
                if c["op"] == op and c.get("report") is not None]
        return [c for c in done if not c.get("traced")] or done

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _metric_readers() -> Dict[str, ModuleType]:
    return {p.name[:-3]: load_module(p)
            for p in sorted((BENCH / "metrics").glob("*.py"))}


def execute(run: Run) -> dict:
    """Set-up, window, reference check; returns the result object (the
    contract's keys, ``checks`` last)."""
    state = run.kind.setup(run)
    run.sync()
    # set-up's objects leave the collector's generations, so the window
    # does not walk them again in its collections
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - run.t0
    before = _host_sample()
    run.kind.window(run, state)
    run.tracer.stop()
    run.sync()
    run.host = _host_delta(before, _host_sample())
    run.tracer.read()
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    if run.trace and hasattr(run.kind, "after_window"):
        run.kind.after_window(run, state)
    e2e = run.kind.end_to_end(run)
    e2e["setup_s"] = (setup_s, "s")
    gc.unfreeze()  # the program's state is freed before the reference
    checks = run.kind.verify(run, state)
    del state
    gc.collect()
    if run.trace:
        metrics = {}
        for name, mod in _metric_readers().items():
            value = mod.read(run)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
    else:
        metrics = {k: {"value": float(v), "unit": u}
                   for k, (v, u) in e2e.items()}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(peak)}
    out = {
        "correct": all(v <= lim for _n, v, lim in checks),
        "attempted": len(run.calls),
        "failed": sum(1 for c in run.calls if c.get("error")),
        "metrics": metrics,
        "device": device,
    }
    if run.trace:
        tr = run.tracer
        device["busy_s"] = tr.busy_s if tr.busy_s is not None else 0.0
        device["window_s"] = tr.window_s or 0.0
        out["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def _host_sample() -> dict:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu_s": r.ru_utime + r.ru_stime}


def _host_delta(a: dict, b: dict) -> dict:
    """The window's wall and the process's CPU seconds in it: a host-bound
    window is on the CPU nearly all of its wall, so its pace is the
    CPU's."""
    return {"wall_s": b["t"] - a["t"], "cpu_s": b["cpu_s"] - a["cpu_s"]}


def _power_line() -> str:
    import subprocess

    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not readable: {e}"


def main(args, t0: float) -> int:
    """The command line: refuse without the card, run, print."""
    cell = load_json("workloads", args.workload)
    want = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: cell {args.workload} needs {want} CUDA "
              f"device(s), this process sees {have}", file=sys.stderr)
        return 2
    print(f"device: {_power_line()}", flush=True)
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              "cuda:0", t0=t0)
    out = execute(run)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    print(f"memory_peak_bytes {out['device']['memory_peak_bytes']}",
          flush=True)
    print("host " + json.dumps(run.host), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
