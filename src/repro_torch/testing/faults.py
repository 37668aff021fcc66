"""Deterministic fault injection for the resilience ladder.

Faults are armed explicitly and process-locally with the
:func:`inject` context manager: nothing fires unless a test arms it,
and the disabled-path cost at every hook is one truthiness check of an
empty list.

Injection points on the counting path:

  - ``kernels/ops.py``: ``maybe_oom`` on every op wrapper (simulate
    RESOURCE_EXHAUSTED at kernel dispatch) and ``maybe_poison`` on the
    ``fused_count_tiles`` output (a sentinel-poisoned tile result).
  - ``core/count.py`` / ``core/pipeline.py``: per-engine ``maybe_oom``
    and ``maybe_slow_rung`` sites (``count.<engine>``),
    ``hash_bits_override`` (force the bounded-probe table into overflow
    so the sort fallback must fire) and ``capacity_override`` (force the
    fused kernel's tile bound so the ladder must descend).
  - ``core/distributed.py``: ``worker_env`` marks a subprocess device
    worker for death (exit or hang) or a startup delay (``slow``) on its
    next launch attempt; the in-process peeling supervisor asks
    ``maybe_device_loss`` / ``maybe_slow`` at every per-worker round
    dispatch (sites ``distributed.peel.round<r>.dev<d>``), which is how
    the chaos tests kill a worker at an exact round boundary or make one
    straggle past the supervisor's per-round deadline.

Counting the sites: ``times=N`` makes a fault fire on its first N
matching hook hits then go quiet (a transient fault: the retry or the
next rung runs clean); ``times=None`` models a hard fault.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "POISON",
    "KINDS",
    "Fault",
    "inject",
    "active",
    "active_kinds",
    "should_fire",
    "maybe_oom",
    "maybe_poison",
    "maybe_device_loss",
    "maybe_slow",
    "maybe_slow_rung",
    "maybe_overload",
    "hash_bits_override",
    "capacity_override",
    "worker_env",
]

# Sentinel planted by the poison fault: large positive so it provably
# violates the result invariants on any test-sized graph, while still
# fitting int32.
POISON = np.int32(1 << 30)

KINDS = (
    "oom",  # raise ResourceExhausted at the site
    "poison",  # plant POISON in the site's value
    "hash_overflow",  # shrink the bounded-probe hash table
    "capacity_overflow",  # shrink the fused kernel's tile capacity
    "device_loss",  # kill/hang a device worker
    "slow",  # delay a device worker (straggler; configurable seconds)
    "slow_rung",  # delay an engine rung's entry (deadline pressure)
    "overload",  # delay a serving worker (fill the admission queue)
)


@dataclasses.dataclass
class Fault:
    """One armed fault. ``site=None`` matches every site of the kind;
    otherwise substring match on the hook's site label. ``times=None``
    fires on every hit, else on the first ``times`` hits only."""

    kind: str
    site: Optional[str] = None
    times: Optional[int] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fired: int = 0
    hits: List[str] = dataclasses.field(default_factory=list)


_active: List[Fault] = []


def active() -> bool:
    return bool(_active)


def active_kinds() -> tuple:
    return tuple(sorted({f.kind for f in _active}))


@contextlib.contextmanager
def inject(kind: str, site: Optional[str] = None,
           times: Optional[int] = None, **params):
    """Arm one fault for the duration of the ``with`` block."""
    if kind not in KINDS:
        raise ValueError(f"fault kind must be one of {KINDS}, got {kind}")
    f = Fault(kind=kind, site=site, times=times, params=params)
    _active.append(f)
    try:
        yield f
    finally:
        _active.remove(f)


def should_fire(kind: str, site: str) -> Optional[Fault]:
    """Match-and-consume: returns the armed fault (bumping its fired
    counter) or None. Site matching is substring containment so one
    fault can cover a family of sites."""
    for f in _active:
        if f.kind != kind:
            continue
        if f.site is not None and f.site not in site:
            continue
        if f.times is not None and f.fired >= f.times:
            continue
        f.fired += 1
        f.hits.append(site)
        return f
    return None


def maybe_oom(site: str) -> None:
    """Raise a typed RESOURCE_EXHAUSTED if an ``oom`` fault matches."""
    if not _active:
        return
    if should_fire("oom", site):
        from ..core.resilience import ResourceExhausted

        raise ResourceExhausted(
            f"RESOURCE_EXHAUSTED: injected OOM at {site}"
        )


def _poison_leaf(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:
        return x
    y = x.clone()
    y.view(-1)[0] = int(POISON)
    return y


def maybe_poison(site: str, value):
    """Plant POISON in the first element of every tensor leaf of
    ``value`` (tuples and lists supported) when a ``poison`` fault
    matches; otherwise return ``value`` untouched."""
    if not _active:
        return value
    if should_fire("poison", site) is None:
        return value
    if isinstance(value, (tuple, list)):
        return type(value)(_poison_leaf(v) for v in value)
    return _poison_leaf(value)


def hash_bits_override(site: str, default: Optional[int]) -> Optional[int]:
    """``hash_overflow`` fault: return a tiny table size (default 2
    bits = 4 slots) so the bounded-probe table must overflow and the
    sort fallback must carry the tile."""
    if not _active:
        return default
    f = should_fire("hash_overflow", site)
    if f is None:
        return default
    return int(f.params.get("bits", 2))


def capacity_override(site: str, default) -> Any:
    """``capacity_overflow`` fault: return a tiny capacity budget
    (default 1) so the fused kernel's tile bound must fire and the
    ladder must descend."""
    if not _active:
        return default
    f = should_fire("capacity_overflow", site)
    if f is None:
        return default
    return int(f.params.get("budget", 1))


def _fire_device_fault(kind: str, site: str, device: int) -> Optional[Fault]:
    """Match-and-consume for per-device fault kinds: like
    :func:`should_fire` plus an optional ``device`` param filter so one
    armed fault can target a single mesh worker."""
    for f in _active:
        if f.kind != kind:
            continue
        if f.site is not None and f.site not in site:
            continue
        if "device" in f.params and int(f.params["device"]) != device:
            continue
        if f.times is not None and f.fired >= f.times:
            continue
        f.fired += 1
        f.hits.append(site)
        return f
    return None


def maybe_device_loss(site: str, *, device: int = 0) -> None:
    """``device_loss`` fault, in-process flavor: raise a typed
    :class:`~repro_torch.core.resilience.DeviceLost` at a supervisor
    dispatch site (the subprocess flavor is :func:`worker_env`). Site
    labels carry the round and worker index
    (``distributed.peel.round<r>.dev<d>``), so ``site="round3"`` kills
    exactly one round boundary and ``device=1`` exactly one worker."""
    if not _active:
        return
    f = _fire_device_fault("device_loss", site, device)
    if f is not None:
        from ..core.resilience import DeviceLost

        raise DeviceLost(
            f"injected device loss at {site}", device=device, attempts=1
        )


def maybe_slow(site: str, *, device: int = 0) -> None:
    """``slow`` fault, in-process flavor: sleep ``delay`` seconds
    (default 0.25) at a supervisor dispatch site, a straggler the
    per-round deadline must catch."""
    if not _active:
        return
    f = _fire_device_fault("slow", site, device)
    if f is not None:
        time.sleep(float(f.params.get("delay", 0.25)))


def maybe_slow_rung(site: str) -> None:
    """``slow_rung`` fault: sleep ``delay`` seconds (default 0.05) at
    an engine rung's entry (sites ``count.<engine>``), burning a
    deadline budget inside one specific rung."""
    if not _active:
        return
    f = should_fire("slow_rung", site)
    if f is not None:
        time.sleep(float(f.params.get("delay", 0.05)))


def maybe_overload(site: str) -> None:
    """``overload`` fault: sleep ``delay`` seconds (default 0.05) on the
    serving layer's worker path (site ``serve.worker``), pinning workers
    so the bounded queue fills and the admission controller must shed
    with a typed ``AdmissionRejected``."""
    if not _active:
        return
    f = should_fire("overload", site)
    if f is not None:
        time.sleep(float(f.params.get("delay", 0.05)))


def worker_env(env: dict, *, device: int = 0,
               site: str = "distributed.worker") -> dict:
    """``device_loss`` / ``slow`` faults, subprocess flavor: mark a
    device worker's next launch attempt via the env vars its preamble
    checks. ``device_loss`` -> ``mode="exit"`` (default) dies
    immediately with a nonzero code, ``mode="hang"`` sleeps past the
    per-attempt timeout; ``slow`` -> the worker sleeps ``delay`` seconds
    (default 0.25) before running its payload. A ``device`` param
    restricts either fault to one worker index."""
    if not _active:
        return env
    f = _fire_device_fault("device_loss", site, device)
    if f is not None:
        env = dict(env)
        env["REPRO_FAULT_DEVICE_LOSS"] = str(f.params.get("mode", "exit"))
        return env
    f = _fire_device_fault("slow", site, device)
    if f is not None:
        env = dict(env)
        env["REPRO_FAULT_DEVICE_SLOW"] = str(
            float(f.params.get("delay", 0.25))
        )
    return env
