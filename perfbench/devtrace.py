"""The device trace of a ``--trace 1`` run.

``torch.profiler`` (CUPTI) records every device operation and, unless a
mix sets ``trace_host`` false, the host's operations, from the moment
the window opens until the first call that ends after ``trace_s``
seconds of it, so the trace covers whole calls and many of them, never
one short operation (a one-call trace can drop its device records).
Recording the host's operations costs host time for each one, so a mix
whose calls launch many small operations (a peeling round loop) traces
the device alone and leaves its gaps unnamed. Read from the same traced
window:

* ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills; the device-side copies of the harness's spans are left
  out);
* ``window_s``: the traced window on the host clock, from a
  synchronised start to a synchronised end;
* ``kernel_s``: the summed time of the kernels alone (copies and fills
  left out), for rooflines;
* the device operations that took most time, and the longest idle gaps
  with the innermost host operation or span that was open at the gap's
  middle.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

__all__ = ["Tracer", "idle_share"]

_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


class Tracer:
    """Starts and stops ``torch.profiler`` around part of the window."""

    def __init__(self, enabled: bool, trace_s: float, host: bool = True):
        self.enabled = bool(enabled)
        self.trace_s = float(trace_s)
        self.host = bool(host)
        self.calls = 0  # calls that ended while the trace was on
        self._prof = None
        self._done = None
        self._t0 = 0.0
        self.window_s: Optional[float] = None
        self.busy_s: Optional[float] = None
        self.kernel_s: Optional[float] = None
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if self.host else []
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def call_done(self, elapsed_s: float) -> None:
        """After each whole call of the window: count it, and end the
        trace once ``trace_s`` seconds have passed."""
        if not self.active:
            return
        self.calls += 1
        if elapsed_s >= self.trace_s:
            self.stop()

    def stop(self) -> None:
        """End the trace; its events are read later, by ``read``, so a
        trace that ends inside the window costs the window little."""
        if not self.active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._done, self._prof = self._prof, None
        self._done.__exit__(None, None, None)

    def read(self) -> None:
        """Reduce the ended trace (after the window)."""
        prof, self._done = self._done, None
        if prof is not None:
            self._read(prof)

    def _read(self, prof) -> None:
        dev, host = [], []
        for ev in prof.profiler.kineto_results.events():
            start, end = ev.start_ns(), ev.end_ns()
            if end <= start:
                continue
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if not ev.is_user_annotation():  # a span, not device work
                    dev.append((start, end, ev.name()))
            elif ev.device_type() == torch.autograd.DeviceType.CPU:
                host.append((start, end, ev.name()))
        if not dev:
            return  # no device record: busy time not measured
        dev.sort()
        merged = []
        for s, e, _n in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        self.kernel_s = sum(e - s for s, e, n in dev
                            if not n.startswith(_NOT_KERNELS)) / 1e9
        by_name: dict = {}
        for s, e, n in dev:
            by_name[n] = by_name.get(n, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        self.device_ops = [(n[:160], ns / 1e9) for n, ns in top]
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(merged, merged[1:])), reverse=True)
        self.idle_gaps = [(_host_at(host, (s + e) // 2), ns / 1e9)
                          for ns, s, e in gaps[:10]]


def _host_at(host: list, t: int) -> str:
    """The innermost (shortest) host operation open at time ``t``."""
    best = None
    for s, e, n in host:
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, n)
    return "host: " + (best[1][:150] if best else "not traced")


def idle_share(run, kind: str):
    """Per cent of the traced window in which the device ran nothing,
    for a run of traffic ``kind``; None where nothing was traced."""
    tr = run.tracer
    if run.kind_name != kind or not tr.busy_s or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
