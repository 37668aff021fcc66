"""Resilient execution layer: the unified degradation ladder.

A PyTorch port of the reference package's resilience layer; the policy,
the error taxonomy and the report are the same objects with the same
semantics, so a ladder walk records the same audit trail in both.

  - A **degradation ladder** of :class:`Rung` objects, tried in order:
    ``fused_cuda -> fused -> torch`` for counting. A rung that raises
    :class:`CapacityOverflow` or :class:`RungUnavailable` cedes to the
    next rung; every rung on the ladder is bitwise-identical where it
    applies, so descent never changes results, only the execution
    strategy.
  - **Capacity-shrink retry with backoff**: a device allocator failure
    (``torch.cuda.OutOfMemoryError``, an injected
    :class:`ResourceExhausted`, or any error carrying the canonical
    ``RESOURCE_EXHAUSTED`` status) re-enters the same rung with a
    halved tile/chunk budget, a bounded number of times, sleeping
    ``backoff_base_s * 2**attempt`` between tries, before descending.
  - **Result-invariant validation**: a caller-supplied validator runs
    over each rung's host-side result (butterfly totals must not exceed
    C(W, 2)). A violating result demotes to the next rung instead of
    being returned; at the bottom of the ladder it raises
    :class:`ResultInvariantViolation`. Never a silent wrong answer.
  - An :class:`ExecutionReport` attached to count results recording
    which rungs fired, their outcomes, retry counts, and final budget
    shrinks.

Every error class multiple-inherits the closest builtin so
``except ValueError`` call sites keep working, while new code can
catch the whole family via :class:`ResilienceError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

__all__ = [
    "ResilienceError",
    "GraphValidationError",
    "CapacityOverflow",
    "AccumulatorOverflowRisk",
    "DeviceLost",
    "StragglerTimeout",
    "CheckpointCorrupt",
    "ResourceExhausted",
    "RungUnavailable",
    "ResultInvariantViolation",
    "AdmissionRejected",
    "DeadlineExceeded",
    "Deadline",
    "is_resource_exhausted",
    "RungAttempt",
    "ExecutionReport",
    "Rung",
    "ResiliencePolicy",
    "resolve_policy",
    "require_rung",
]


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class ResilienceError(Exception):
    """Root of the structured failure taxonomy."""


class GraphValidationError(ResilienceError, ValueError):
    """Malformed graph input: ragged/non-monotone CSR, out-of-range or
    duplicate edges, empty sides, non-permutation orders. Raised before
    any kernel ever sees the data; never degradable."""


class CapacityOverflow(ResilienceError, ValueError):
    """A bounded buffer (frontier cap, kernel tile) cannot hold the
    workload. Degradable: the ladder descends to a rung without that
    bound (e.g. ``fused_cuda -> fused``)."""


class AccumulatorOverflowRisk(ResilienceError, OverflowError):
    """The worst-case butterfly bound C(min(w_u, w_v), 2) exceeds the
    accumulator budget (two-limb int32 = 2^63 by default): exact counts
    cannot be guaranteed on any rung, so this raises up front instead
    of risking a silent wraparound."""


class DeviceLost(ResilienceError, RuntimeError):
    """A per-device worker died or timed out after bounded retries.
    Carries the failed device index and attempt count."""

    def __init__(self, message: str, *, device: Optional[int] = None,
                 attempts: int = 0):
        super().__init__(message)
        self.device = device
        self.attempts = attempts


class StragglerTimeout(ResilienceError, TimeoutError):
    """A device's sub-plan missed its per-round deadline twice — once
    on the original worker and once on the first-completion
    re-dispatch. The distributed supervisor treats one miss as a
    straggler (duplicate the work, keep whichever finishes first); a
    second consecutive miss means the round cannot make progress on
    this mesh, so the ladder descends to the single-device rungs.
    Carries the device index and the deadline that was missed."""

    def __init__(self, message: str, *, device: Optional[int] = None,
                 deadline_s: float = 0.0):
        super().__init__(message)
        self.device = device
        self.deadline_s = deadline_s


class CheckpointCorrupt(ResilienceError, ValueError):
    """A round checkpoint failed its integrity check (digest mismatch,
    wrong plan hash, unparseable payload) — recovery from it would risk
    a silently wrong decomposition, so the supervisor refuses and the
    ladder descends to a rung that needs no checkpoint."""


class ResourceExhausted(ResilienceError, MemoryError):
    """Device memory exhaustion (the canonical RESOURCE_EXHAUSTED
    status). The ladder retries the same rung with a halved budget
    before descending. The fault harness raises this directly."""


class RungUnavailable(ResilienceError, RuntimeError):
    """A rung is statically inapplicable to this workload (counts
    beyond int32, empty side, expansion totals beyond int32 indexing).
    Internal control flow: the ladder records it and descends."""


class ResultInvariantViolation(ResilienceError, RuntimeError):
    """Every rung either failed or produced a result violating the
    workload's invariants — surfaced instead of a silent wrong answer."""


class AdmissionRejected(ResilienceError, RuntimeError):
    """The serving layer's admission controller shed this query: the
    bounded worker pool plus queue is full, so the service refuses
    synchronously instead of letting latency grow without bound.
    Carries the observed ``queue_depth`` and configured ``capacity``."""

    def __init__(self, message: str, *, queue_depth: int = 0,
                 capacity: int = 0):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.capacity = capacity


class DeadlineExceeded(ResilienceError, TimeoutError):
    """A query's deadline budget ran out before any remaining rung
    could plausibly finish — the ladder stops descending and the
    serving layer falls back to a cached-stale result (if allowed) or
    surfaces this typed error. Carries the requested ``deadline_s``
    and the ``elapsed_s`` at the point of exhaustion."""

    def __init__(self, message: str, *, deadline_s: float = 0.0,
                 elapsed_s: float = 0.0):
        super().__init__(message)
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s


class Deadline:
    """A monotonic countdown threaded from the service front door into
    :meth:`ResiliencePolicy.execute`. Created when a query is
    *admitted* (queue wait consumes budget too), consulted at every
    rung boundary. ``clock`` is injectable so tests can drive time."""

    __slots__ = ("budget_s", "clock", "started_at")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if budget_s is None or budget_s <= 0:
            raise ValueError(f"deadline budget must be > 0, got {budget_s}")
        self.budget_s = float(budget_s)
        self.clock = clock
        self.started_at = clock()

    def elapsed_s(self) -> float:
        return self.clock() - self.started_at

    def remaining_s(self) -> float:
        return self.budget_s - self.elapsed_s()

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def exceeded(self, message: str) -> "DeadlineExceeded":
        return DeadlineExceeded(
            message, deadline_s=self.budget_s, elapsed_s=self.elapsed_s()
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Deadline(budget_s={self.budget_s:.3f}, "
                f"remaining_s={self.remaining_s():.3f})")


def is_resource_exhausted(e: BaseException) -> bool:
    """True for our typed :class:`ResourceExhausted`, for PyTorch's
    ``torch.cuda.OutOfMemoryError``, and for any error carrying the
    canonical ``RESOURCE_EXHAUSTED`` status string, so a live allocator
    failure triggers the shrink-retry path."""
    return (
        isinstance(e, (ResourceExhausted, torch.cuda.OutOfMemoryError))
        or "RESOURCE_EXHAUSTED" in str(e)
    )


def require_rung(result: Any, notes: Sequence[str]) -> Any:
    """Translate the device engines' ``None`` return (the seed's
    overflow-latch / inapplicability contract, kept so callers and
    tests can still observe it) into the typed taxonomy: overflow notes
    become :class:`CapacityOverflow`, anything else
    :class:`RungUnavailable`."""
    if result is not None:
        return result
    msg = "; ".join(notes) or "rung unavailable"
    if any("overflow" in s for s in notes):
        raise CapacityOverflow(msg)
    raise RungUnavailable(msg)


# ---------------------------------------------------------------------------
# Execution report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RungAttempt:
    """Outcome of one ladder rung (including its shrink-retries)."""

    rung: str
    outcome: str  # ok | unavailable | capacity-overflow |
    #               resource-exhausted | invalid-result |
    #               straggler-timeout | checkpoint-corrupt |
    #               deadline-skipped | deadline-exceeded |
    #               device-lost | skipped
    detail: str = ""
    retries: int = 0  # RESOURCE_EXHAUSTED retries burned on this rung
    budget_shrinks: int = 0  # budget halvings applied by those retries
    wall_s: float = 0.0  # elapsed seconds spent inside this rung


@dataclasses.dataclass
class ExecutionReport:
    """Attached to :class:`~repro_torch.core.count.CountResult` as
    ``.report`` when the
    resilience policy is enabled: the audit trail of the ladder."""

    workload: str  # e.g. "count", "peel_tips"
    requested: str  # the rung the caller asked for
    attempts: List[RungAttempt] = dataclasses.field(default_factory=list)
    final_rung: Optional[str] = None  # rung that produced the result
    plan: Optional[str] = None  # WedgePlan.summary() (set by the pipeline)
    # estimator parameters when the result is an approximate-tier
    # estimate (ApproxCount.describe(): method, p/eps, samples, seed,
    # applied scale) — None for exact results
    estimator: Optional[str] = None
    checkpoint_restores: int = 0  # supervisor rollbacks to a snapshot
    # blocking device -> host fetches the peeling round loops made,
    # summed over every rung attempted
    host_syncs: int = 0
    # capacity segments the device peeling loop ran (1 under the fixed
    # schedule; more under the adaptive one), summed over attempts
    segments: int = 0
    # largest level-2 frontier of one device peeling round, in lanes
    frontier_lanes: int = 0
    wall_s: float = 0.0  # total seconds across all rung attempts
    deadline_s: Optional[float] = None  # requested budget (if any)
    deadline_slack_s: Optional[float] = None  # budget left at completion
    # Per-device worker reports from a distributed rung. The supervisor
    # produces one small report per mesh device (rounds served, losses,
    # straggler re-dispatches); the parent frontend merges them here so
    # the audit trail survives instead of dying with the worker.
    children: List["ExecutionReport"] = dataclasses.field(
        default_factory=list
    )

    @property
    def degraded(self) -> bool:
        return self.final_rung is not None and self.final_rung != self.requested

    @property
    def retries(self) -> int:
        return sum(a.retries for a in self.attempts) + sum(
            c.retries for c in self.children
        )

    def merge_child(self, child: "ExecutionReport") -> None:
        """Aggregate one per-device worker report into this run's
        audit trail (shown as an indented row by ``summary()``)."""
        self.children.append(child)

    @property
    def final_budget_shrinks(self) -> int:
        for a in self.attempts:
            if a.rung == self.final_rung:
                return a.budget_shrinks
        return 0

    def summary(self) -> str:
        path = " -> ".join(
            f"{a.rung}[{a.outcome}"
            + (f",retries={a.retries}" if a.retries else "")
            + "]"
            for a in self.attempts
        )
        base = f"{self.workload}: requested={self.requested} {path}"
        if self.checkpoint_restores:
            base += f" restores={self.checkpoint_restores}"
        if self.host_syncs:
            base += f" syncs={self.host_syncs}"
        if self.segments:
            base += f" segments={self.segments}"
        if self.wall_s:
            base += f" wall={self.wall_s:.3f}s"
        if self.deadline_slack_s is not None:
            base += f" slack={self.deadline_slack_s:.3f}s"
        if self.estimator:
            base += f" | estimator: {self.estimator}"
        if self.plan:
            base += f" | plan: {self.plan}"
        if self.children:
            base += "".join(
                "\n  " + child.summary() for child in self.children
            )
        return base


@dataclasses.dataclass(frozen=True)
class Rung:
    """One ladder rung. ``run(budget_shrinks)`` executes the rung with
    its budget halved ``budget_shrinks`` times (the shrink-retry knob);
    ``shrinkable=False`` rungs (host loops with no static buffers) get
    no shrink-retry."""

    name: str
    run: Callable[[int], Any]
    shrinkable: bool = True
    # zero_cost rungs (e.g. a cached-result lookup) are never
    # deadline-skipped: even an expired budget can afford them
    zero_cost: bool = False


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResiliencePolicy:
    """The one policy object driving every engine's fallback behavior.

    ``max_retries`` bounds per-rung RESOURCE_EXHAUSTED shrink-retries;
    ``backoff_base_s`` seeds the exponential backoff between them.
    ``validate_results=False`` skips result-invariant validation and
    ``attach_report=False`` drops the report (together these are the
    "ladder disabled" benchmark configuration — the rung *descent*
    itself always runs, because it is the engines' documented
    semantics, not an optional extra)."""

    max_retries: int = 2
    backoff_base_s: float = 0.02
    validate_results: bool = True
    attach_report: bool = True
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    def _finalize(self, report: ExecutionReport,
                  deadline: Optional[Deadline]) -> None:
        report.wall_s = sum(a.wall_s for a in report.attempts)
        if deadline is not None:
            report.deadline_s = deadline.budget_s
            report.deadline_slack_s = deadline.remaining_s()

    def execute(
        self,
        workload: str,
        rungs: Sequence[Rung],
        validate: Optional[Callable[[Any], Optional[str]]] = None,
        *,
        deadline: Optional[Deadline] = None,
        rung_gate: Optional[Callable[[Rung], Optional[str]]] = None,
        on_rung: Optional[Callable[[RungAttempt], None]] = None,
    ):
        """Run ``rungs`` in order until one returns a valid result.

        Returns ``(result, report)``. Degradable failures
        (:class:`CapacityOverflow`, :class:`RungUnavailable`,
        :class:`StragglerTimeout`, :class:`CheckpointCorrupt`,
        :class:`DeadlineExceeded` raised *by a rung*, exhausted
        RESOURCE_EXHAUSTED retries, invariant violations) descend;
        input/world errors (:class:`GraphValidationError`,
        :class:`AccumulatorOverflowRisk`, :class:`DeviceLost`) and
        unknown exceptions propagate — no rung fixes a malformed graph
        and masking a genuine bug as a fallback would hide corruption.

        ``deadline`` threads a remaining-time budget through the walk:
        once it expires, non-``zero_cost`` rungs are *skipped* (outcome
        ``deadline-skipped``) rather than started, retry backoff sleeps
        are clamped to the remaining budget, and an exhausted ladder
        raises :class:`DeadlineExceeded` instead of the last rung
        error. ``rung_gate(rung) -> reason | None`` lets a caller (the
        serving layer's circuit breakers / cost model) veto a rung
        before it runs (outcome ``skipped``). ``on_rung(attempt)``
        observes every recorded :class:`RungAttempt` as it lands —
        the breaker-feedback hook. Every exception raised out of this
        method carries the partial audit trail as ``e.report``.
        """
        if not rungs:
            raise ValueError("resilience ladder needs at least one rung")
        report = ExecutionReport(workload=workload, requested=rungs[0].name)
        last_err: Optional[BaseException] = None
        last_invalid: Optional[str] = None
        deadline_skips = 0

        def record(attempt: RungAttempt) -> None:
            report.attempts.append(attempt)
            if on_rung is not None:
                on_rung(attempt)

        def raise_with_report(err: BaseException) -> None:
            self._finalize(report, deadline)
            try:
                err.report = report
            except Exception:
                pass  # exotic __slots__ exceptions: lose the audit trail
            raise err

        for rung in rungs:
            # deadline check precedes the gate: an expired budget must
            # not consume a half-open breaker's single probe slot
            if (deadline is not None and deadline.expired()
                    and not rung.zero_cost):
                deadline_skips += 1
                record(RungAttempt(
                    rung.name, "deadline-skipped",
                    f"budget {deadline.budget_s:.3f}s exhausted "
                    f"({deadline.elapsed_s():.3f}s elapsed)"))
                continue
            if rung_gate is not None:
                reason = rung_gate(rung)
                if reason is not None:
                    record(RungAttempt(rung.name, "skipped", reason))
                    continue
            shrinks = 0
            retries = 0
            t_rung = self.clock()
            while True:
                try:
                    out = rung.run(shrinks)
                except RungUnavailable as e:
                    record(RungAttempt(
                        rung.name, "unavailable", str(e), retries, shrinks,
                        self.clock() - t_rung))
                    last_err = e
                    break
                except CapacityOverflow as e:
                    record(RungAttempt(
                        rung.name, "capacity-overflow", str(e), retries,
                        shrinks, self.clock() - t_rung))
                    last_err = e
                    break
                except StragglerTimeout as e:
                    # a round missed its deadline twice: the mesh can't
                    # make progress — descend to the single-device rungs
                    record(RungAttempt(
                        rung.name, "straggler-timeout", str(e), retries,
                        shrinks, self.clock() - t_rung))
                    last_err = e
                    break
                except CheckpointCorrupt as e:
                    # recovery state is unusable; rungs below need none
                    record(RungAttempt(
                        rung.name, "checkpoint-corrupt", str(e), retries,
                        shrinks, self.clock() - t_rung))
                    last_err = e
                    break
                except DeadlineExceeded as e:
                    # the rung itself ran out of budget mid-flight
                    # (e.g. a supervisor round): cheaper rungs may still
                    # fit what little remains — descend, don't abort
                    record(RungAttempt(
                        rung.name, "deadline-exceeded", str(e), retries,
                        shrinks, self.clock() - t_rung))
                    deadline_skips += 1
                    last_err = e
                    break
                except DeviceLost as e:
                    # propagates (the mesh supervisor already burned its
                    # retries), but the breaker needs to see it: record
                    # the attempt before re-raising
                    record(RungAttempt(
                        rung.name, "device-lost", str(e), retries, shrinks,
                        self.clock() - t_rung))
                    raise_with_report(e)
                except (GraphValidationError, AccumulatorOverflowRisk) as e:
                    raise_with_report(e)
                except Exception as e:
                    if not is_resource_exhausted(e):
                        raise_with_report(e)
                    expired = deadline is not None and deadline.expired()
                    if (rung.shrinkable and retries < self.max_retries
                            and not expired):
                        retries += 1
                        shrinks += 1
                        if self.backoff_base_s > 0:
                            pause = self.backoff_base_s * (2 ** (retries - 1))
                            if deadline is not None:
                                pause = min(
                                    pause, max(0.0, deadline.remaining_s())
                                )
                            self.sleep(pause)
                        continue
                    record(RungAttempt(
                        rung.name, "resource-exhausted", str(e), retries,
                        shrinks, self.clock() - t_rung))
                    last_err = e
                    break
                if validate is not None and self.validate_results:
                    problem = validate(out)
                    if problem is not None:
                        record(RungAttempt(
                            rung.name, "invalid-result", problem, retries,
                            shrinks, self.clock() - t_rung))
                        last_invalid = f"{rung.name}: {problem}"
                        last_err = None
                        break
                record(RungAttempt(
                    rung.name, "ok", "", retries, shrinks,
                    self.clock() - t_rung))
                report.final_rung = rung.name
                self._finalize(report, deadline)
                return out, report
        if deadline is not None and deadline.expired() and deadline_skips:
            detail = f"; last error: {last_err}" if last_err else ""
            raise_with_report(deadline.exceeded(
                f"{workload}: deadline {deadline.budget_s:.3f}s exhausted "
                f"after {deadline.elapsed_s():.3f}s with "
                f"{deadline_skips} rung(s) skipped{detail} "
                f"({report.summary()})"
            ))
        if last_invalid is not None and last_err is None:
            raise_with_report(ResultInvariantViolation(
                f"{workload}: every rung failed or violated result "
                f"invariants; last violation: {last_invalid} "
                f"({report.summary()})"
            ))
        if last_err is None:
            # every rung was vetoed by the gate (open breakers) or
            # deadline-skipped without the budget having expired yet
            raise_with_report(RungUnavailable(
                f"{workload}: every rung was skipped "
                f"({report.summary()})"
            ))
        raise_with_report(last_err)

    def attach(self, result, report: ExecutionReport):
        """``result._replace(report=...)`` honoring ``attach_report``."""
        if not self.attach_report:
            return result
        return result._replace(report=report)


_DEFAULT_POLICY = ResiliencePolicy()
_DISABLED_POLICY = ResiliencePolicy(
    max_retries=0, backoff_base_s=0.0, validate_results=False,
    attach_report=False,
)


def resolve_policy(arg) -> ResiliencePolicy:
    """Resolve an engine entry point's ``resilience=`` knob:
    ``None``/``True`` -> the default policy, ``False`` -> the disabled
    policy (no validation, no retries, no report — rung descent only),
    a :class:`ResiliencePolicy` -> itself."""
    if arg is None or arg is True:
        return _DEFAULT_POLICY
    if arg is False:
        return _DISABLED_POLICY
    if isinstance(arg, ResiliencePolicy):
        return arg
    raise ValueError(
        f"resilience must be None, bool, or ResiliencePolicy, got {arg!r}"
    )
