"""Admission control for the butterfly query service.

The service's latency story starts *before* execution: a bounded
worker pool can only keep p99 within deadlines if the line in front of
it is bounded too. :class:`AdmissionController` implements the classic
shed-on-full front door — ``capacity = workers + queue_cap`` slots,
one per in-flight-or-queued query, acquired synchronously at submit
time. A full house rejects the new query *immediately* with the typed
:class:`~repro_torch.core.resilience.AdmissionRejected` (never an unbounded
queue, never a blocking submit): under a 2x-capacity overload the
excess load turns into fast typed rejections the client can retry
against another replica, while every admitted query still sees a
bounded queue wait it can afford out of its deadline budget.
"""
from __future__ import annotations

import threading

from ..core.resilience import AdmissionRejected

__all__ = ["AdmissionController"]


class AdmissionController:
    """Counting semaphore with shed-on-full semantics and stats.

    ``try_admit()`` either takes a slot or raises
    :class:`AdmissionRejected` carrying the observed occupancy;
    ``release()`` frees the slot in the worker's ``finally``. All
    methods are thread-safe; none of them block.
    """

    def __init__(self, capacity: int):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._occupied = 0
        self.admitted = 0
        self.rejected = 0
        self.peak_occupancy = 0

    def try_admit(self) -> None:
        with self._lock:
            if self._occupied >= self.capacity:
                self.rejected += 1
                raise AdmissionRejected(
                    f"service at capacity: {self._occupied}/"
                    f"{self.capacity} queries in flight — shedding",
                    queue_depth=self._occupied,
                    capacity=self.capacity,
                )
            self._occupied += 1
            self.admitted += 1
            self.peak_occupancy = max(self.peak_occupancy, self._occupied)

    def release(self) -> None:
        with self._lock:
            if self._occupied <= 0:
                raise RuntimeError("release() without a matching admit")
            self._occupied -= 1

    @property
    def occupied(self) -> int:
        with self._lock:
            return self._occupied

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "occupied": self._occupied,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "peak_occupancy": self.peak_occupancy,
            }
