"""Per-(graph, rung) circuit breakers for the serving ladder.

A rung that keeps dying — a device that went away
(:class:`~repro_torch.core.resilience.DeviceLost`), an allocator that
keeps raising ``torch.cuda.OutOfMemoryError`` or RESOURCE_EXHAUSTED —
should not charge every subsequent query the cost of rediscovering
that. The breaker is the standard three-state machine, keyed per
(graph version, rung) by the service:

::

            failure (threshold-th consecutive)
   CLOSED ────────────────────────────────────▶ OPEN
     ▲                                           │ cooldown_s elapses
     │ probe succeeds                            ▼
     └──────────────────────────────────── HALF-OPEN
                  probe fails (reopen, fresh cooldown)

- **closed**: queries flow; ``threshold`` *consecutive* breaker-class
  failures (the service feeds ``record_failure`` from ``device-lost``
  and ``resource-exhausted`` rung outcomes) trip it open.
- **open**: ``allow()`` vetoes the rung (the ladder's ``rung_gate``
  turns that into a ``skipped`` attempt and descends) until
  ``cooldown_s`` has elapsed.
- **half-open**: exactly one probe query is admitted through the rung;
  success closes the breaker, another breaker-class failure reopens it
  with a fresh cooldown. Outcomes that say nothing about rung health
  (validation demotions, capacity descent, deadline skips) must call
  ``record_neutral`` so an abandoned probe slot is returned instead of
  wedging the breaker half-open forever.

The clock is injectable (monotonic seconds) so tests drive the
cooldown deterministically.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Three-state breaker guarding one (graph version, rung) pair."""

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if int(threshold) < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if float(cooldown_s) < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_in_flight = False
        self.trips = 0  # closed/half-open -> open transitions

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        # lazily promote open -> half-open once the cooldown elapses;
        # the transition is observed, not scheduled
        if (self._state == OPEN and self._opened_at is not None
                and self.clock() - self._opened_at >= self.cooldown_s):
            self._state = HALF_OPEN
            self._probe_in_flight = False
        return self._state

    def allow(self) -> Optional[str]:
        """Gate check: None admits the rung; a string is the veto
        reason (the ladder records it on the ``skipped`` attempt).
        In half-open state the first caller takes the single probe
        slot; concurrent queries stay vetoed until it resolves."""
        with self._lock:
            state = self._state_locked()
            if state == CLOSED:
                return None
            if state == OPEN:
                remaining = self.cooldown_s - (
                    self.clock() - (self._opened_at or 0.0)
                )
                return (f"breaker open ({self._consecutive_failures} "
                        f"consecutive failures; probe in "
                        f"{max(0.0, remaining):.3f}s)")
            if self._probe_in_flight:
                return "breaker half-open: probe already in flight"
            self._probe_in_flight = True
            return None

    def record_success(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._consecutive_failures = 0
            self._opened_at = None
            self._probe_in_flight = False

    def record_failure(self) -> None:
        """A breaker-class failure (DeviceLost / ResourceExhausted)."""
        with self._lock:
            state = self._state_locked()
            self._consecutive_failures += 1
            if state == HALF_OPEN or (
                    state == CLOSED
                    and self._consecutive_failures >= self.threshold):
                self._state = OPEN
                self._opened_at = self.clock()
                self._probe_in_flight = False
                self.trips += 1

    def record_neutral(self) -> None:
        """An outcome that says nothing about rung health: free an
        in-flight probe slot without moving the state machine."""
        with self._lock:
            self._probe_in_flight = False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state_locked(),
                "consecutive_failures": self._consecutive_failures,
                "trips": self.trips,
            }
