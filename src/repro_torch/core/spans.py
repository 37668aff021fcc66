"""Spans and counters of one call into the program.

An entry point (``count_butterflies``, ``peel_tips``,
``peel_tips_stored``, ``peel_wings``) opens a *root* span for the call
(:func:`entry`); code it runs opens named :class:`span` blocks and bumps
named counters with :func:`add`. When the call returns, what it
recorded lands on its :class:`~repro_torch.core.resilience.ExecutionReport`:

  - ``report.phases[name]``: a :class:`Phase`, the span's seconds
    summed over its entries (``s``), the number of entries (``n``) and
    its self time (``self_s``: ``s`` less the time in spans opened
    inside it). Always filled.
  - ``report.counters[name]``: the counter's sum over the call. Always
    filled.
  - ``report.timeline``: ``(name, parent, start_ns, end_ns)`` per span
    entry, ``parent`` the enclosing span's name (None for the root).
    Filled only while a ``torch.profiler`` session is active, on the
    profiler's own clock (nanoseconds of the Unix epoch, as
    ``time.time_ns()`` reads it), so a span and a kernel's device
    interval in the profiler's trace compare directly. While a session
    is active each span also runs under
    ``torch.profiler.record_function(name)``, so a trace that records
    host activity shows it.

The current call is held in a :class:`contextvars.ContextVar`: threads
(the service's workers) keep separate calls, and a nested entry point
(the count a tip decomposition makes) opens its own root and report and
shows in the outer call as the span around it. Outside any call a span
or a counter records nothing. The profiler being on is the only switch:
with it off a span costs two clock reads and a dict update.
"""
from __future__ import annotations

import contextvars
import functools
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["Phase", "Call", "span", "root", "entry", "spanned", "add"]


class Phase(NamedTuple):
    """One span name's totals over a call."""

    s: float  # seconds inside the span, over its entries
    n: int  # entries
    self_s: float  # s less the seconds in spans opened inside it


class Call:
    """What one call into an entry point recorded."""

    __slots__ = ("phases", "counters", "timeline", "stack")

    def __init__(self):
        self.phases: Dict[str, list] = {}  # name -> [s, n, self_s]
        self.counters: Dict[str, int] = {}
        self.timeline: List[Tuple[str, Optional[str], int, int]] = []
        self.stack: List["span"] = []  # the open spans, innermost last

    def fill(self, report) -> None:
        """Put the call's phases, counters and timeline on ``report``
        (an :class:`~repro_torch.core.resilience.ExecutionReport`, or
        None where the policy attaches none)."""
        if report is None:
            return
        report.phases = {k: Phase(*v) for k, v in self.phases.items()}
        report.counters = dict(self.counters)
        report.timeline = list(self.timeline)


_CALL: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_call", default=None)


class span:
    """``with span(name):`` times its body into the current call."""

    __slots__ = ("name", "call", "t0", "child_s", "ns0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        call = self.call = _CALL.get()
        if call is None:
            return self
        self.child_s = 0.0
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.ns0 = time.time_ns()
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        call.stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        call = self.call
        if call is None:
            return False
        dt = time.perf_counter() - self.t0
        stack = call.stack
        stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            ns1 = time.time_ns()
            call.timeline.append((self.name, stack[-1].name if stack
                                  else None, self.ns0, ns1))
        if stack:
            stack[-1].child_s += dt
        p = call.phases.get(self.name)
        if p is None:
            call.phases[self.name] = [dt, 1, dt - self.child_s]
        else:
            p[0] += dt
            p[1] += 1
            p[2] += dt - self.child_s
        return False


class root(span):
    """The span of a whole call: a new :class:`Call` is current inside
    it; ``with root(name) as call``."""

    __slots__ = ("token",)

    def __enter__(self) -> Call:
        self.token = _CALL.set(Call())
        super().__enter__()
        return self.call

    def __exit__(self, *exc) -> bool:
        try:
            return super().__exit__(*exc)
        finally:
            _CALL.reset(self.token)


def entry(name: str):
    """Decorate an entry point: each call runs under ``root(name)`` and
    what it recorded is put on its result's ``report``."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with root(name) as call:
                out = fn(*args, **kwargs)
            call.fill(getattr(out, "report", None))
            return out

        return run

    return wrap


def spanned(name: str, fn: Callable) -> Callable:
    """``fn`` run under ``span(name)`` (a ladder rung, a validator)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return run


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the current call's counter ``name``."""
    call = _CALL.get()
    if call is not None:
        call.counters[name] = call.counters.get(name, 0) + int(n)
