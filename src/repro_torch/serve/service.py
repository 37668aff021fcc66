"""The butterfly analytics service: a concurrent, deadline-aware front
door over resident graphs, on the CUDA card unless asked for the host.

Layering: the service owns *queries* (admission, deadlines, caching,
breakers) and delegates *execution* to the same ladder substrate the
one-shot entry points use:

::

   ButterflyService.query()
     ├─ AdmissionController.try_admit()      (shed-on-full, typed)
     ├─ ResultCache.get(version, qkey)       (O(1) repeat queries)
     ├─ ResiliencePolicy.execute(            (core/resilience.py)
     │      rungs       = engine ladder over the *resident* RankedGraph
     │      deadline    = remaining per-request budget
     │      rung_gate   = CircuitBreaker.allow() + EWMA cost estimate
     │      on_rung     = breaker feedback + EWMA update)
     │        └─ count rungs / peel_* (core pipeline + kernels)
     └─ stale fallback                       (ResultCache.stale_get)

A port of the reference package's service. Graphs are registered once:
ranking and the host CSR run at ``register()`` time and every query
hits the resident :class:`~repro_torch.core.graph.RankedGraph`, keyed
by the graph's content-hash *version*; each count miss uploads the CSR
to the service's device and prepares it there once (one wedge-count
pass), and every rung it tries counts on that prepared graph. Every
response carries the engine-level
:class:`~repro_torch.core.resilience.ExecutionReport` (which rungs ran)
and a :class:`ServiceReport` (what the service did around them: queue
wait, cache tier, breaker snapshots, deadline slack). Every result the
service returns or caches is host numpy.

Degradation order under deadline pressure: ``fused_cuda -> fused ->
torch`` for counting, ``exact -> range`` and ``device -> host`` for
peeling, and, when no live rung fits the remaining budget, the last
good *stale* result for the same query shape, explicitly marked with
the version it was computed against. Every rung is bitwise-identical
where it applies, so degradation never changes accepted answers, only
how (or whether) they are computed.
"""
from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import approx as _approx
from ..core import count as _count
from ..core import peel as _peel
from ..core import resilience as _res
from ..core import sparsify as _sparsify
from ..core.device import resolve_device
from ..core.graph import BipartiteGraph, RankedGraph, preprocess
from ..core.ranking import make_order
from ..testing import faults as _faults
from .admission import AdmissionController
from .breaker import CircuitBreaker
from .cache import ResultCache

__all__ = [
    "Query",
    "ServiceReport",
    "ServiceResponse",
    "ButterflyService",
    "QUERY_KINDS",
]

QUERY_KINDS = ("count", "peel_tips", "peel_tips_stored", "peel_wings")

# service-side engine defaults: counting starts on the fused CUDA kernel
# (on a CPU device its plain version runs, so the same default serves
# both); peeling keeps the reference's host default (callers on the
# card ask for engine="device" per query)
DEFAULT_COUNT_ENGINE = "fused_cuda"
DEFAULT_PEEL_ENGINE = "host"


@dataclasses.dataclass(frozen=True)
class Query:
    """One analytics request against a registered graph.

    ``deadline_s=None`` takes the service default; the countdown
    starts at *admission*, so queue wait spends the same budget
    execution does. ``allow_stale`` opts into the cached-stale bottom
    rung when the budget dies before any live rung.

    ``accuracy="approx"`` (count/global only) opts into the
    approximate tier: the exact engine ladder gains a zero-cost
    ``sample`` rung at the bottom (``COUNT_LADDERS["sample"]``), so a
    deadline too tight for any exact engine still gets a seeded
    sampled :class:`~repro_torch.core.approx.ApproxCount` with error bars —
    explicitly marked via ``ServiceReport.approximate`` — while the
    service refines the exact answer in the background. ``eps`` is the
    sampling budget's relative-error target."""

    graph: str
    kind: str = "count"
    mode: str = "global"  # count only: global | vertex | edge | all
    engine: Optional[str] = None  # None -> service default for the kind
    aggregation: str = "sort"
    side: Optional[int] = None  # tips only: force the peeled side
    peel_mode: str = "exact"  # peel only: exact | range
    deadline_s: Optional[float] = None
    allow_stale: bool = True
    accuracy: str = "exact"  # exact | approx (count/global only)
    eps: float = 0.1  # approx only: relative-error target

    def validate(self) -> None:
        if self.accuracy not in ("exact", "approx"):
            raise ValueError(
                f"accuracy must be 'exact' or 'approx', "
                f"got {self.accuracy!r}"
            )
        if self.accuracy == "approx":
            if self.kind != "count" or self.mode != "global":
                raise ValueError(
                    "accuracy='approx' is only defined for "
                    "kind='count', mode='global' (the sampling "
                    f"estimator targets the global total), got "
                    f"kind={self.kind!r} mode={self.mode!r}"
                )
            if not (0.0 < float(self.eps) < 1.0):
                raise ValueError(
                    f"eps must be in (0, 1), got {self.eps}"
                )
        if self.kind not in QUERY_KINDS:
            raise ValueError(
                f"kind must be one of {QUERY_KINDS}, got {self.kind!r}"
            )
        if self.kind == "count":
            if self.mode not in _count.MODES:
                raise ValueError(
                    f"mode must be {'|'.join(_count.MODES)}, "
                    f"got {self.mode!r}"
                )
            eng = self.engine or DEFAULT_COUNT_ENGINE
            if eng not in _count.ENGINES:
                raise ValueError(
                    f"count engine must be {'|'.join(_count.ENGINES)}, "
                    f"got {eng!r}"
                )
        else:
            eng = self.engine or DEFAULT_PEEL_ENGINE
            if eng not in _peel.PEEL_ENGINES:
                raise ValueError(
                    f"peel engine must be "
                    f"{'|'.join(_peel.PEEL_ENGINES)}, got {eng!r}"
                )
            if self.peel_mode not in _peel.PEEL_MODES:
                raise ValueError(
                    f"peel_mode must be {'|'.join(_peel.PEEL_MODES)}, "
                    f"got {self.peel_mode!r}"
                )
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}"
            )

    def resolved_engine(self) -> str:
        if self.engine is not None:
            return self.engine
        return (DEFAULT_COUNT_ENGINE if self.kind == "count"
                else DEFAULT_PEEL_ENGINE)

    def cache_key(self) -> tuple:
        """The knobs that name a result. The requested engine is part
        of the key on purpose: rungs are bitwise-identical so sharing
        across engines would be sound, but keeping keys engine-exact
        makes cache behavior trivially auditable (a hit always came
        from an identically-shaped query)."""
        key = (self.kind, self.mode, self.resolved_engine(),
               self.aggregation, self.side, self.peel_mode)
        if self.accuracy == "approx":
            # approx results never share keys with exact ones: an
            # estimate must not satisfy a later exact query, and a
            # background refine overwrites only the exact-keyed entry
            key = key + ("approx", float(self.eps))
        return key

    def exact_equivalent(self) -> "Query":
        """The exact-accuracy query this approx query is a stand-in
        for — used for the cache-upgrade lookup and refine-behind."""
        return dataclasses.replace(
            self, accuracy="exact", deadline_s=None, allow_stale=False
        )


@dataclasses.dataclass
class ServiceReport:
    """What the service did around engine execution for one query."""

    graph: str
    version: str
    kind: str
    cache: str  # "hit" | "miss" | "stale"
    stale_version: Optional[str] = None  # version a stale result is from
    queue_wait_s: float = 0.0
    exec_wall_s: float = 0.0
    total_wall_s: float = 0.0
    deadline_s: Optional[float] = None
    deadline_slack_s: Optional[float] = None  # remaining at completion
    rungs_tried: List[str] = dataclasses.field(default_factory=list)
    final_rung: Optional[str] = None
    degraded: bool = False
    breakers: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # approximate tier: True when the answer is a sampled estimate
    # (final_rung == "sample"), with the estimator's parameters and
    # whether an exact refine was kicked off behind the response
    approximate: bool = False
    estimator: Optional[str] = None
    refining: bool = False

    def summary(self) -> str:
        parts = [
            f"{self.kind}@{self.graph}[{self.version[:8]}]",
            f"cache={self.cache}",
            f"wait={self.queue_wait_s:.3f}s",
            f"wall={self.exec_wall_s:.3f}s",
        ]
        if self.rungs_tried:
            parts.append("rungs=" + "->".join(self.rungs_tried))
        if self.final_rung:
            parts.append(f"final={self.final_rung}"
                         + ("(degraded)" if self.degraded else ""))
        if self.deadline_slack_s is not None:
            parts.append(f"slack={self.deadline_slack_s:.3f}s")
        if self.stale_version:
            parts.append(f"stale_from={self.stale_version[:8]}")
        if self.approximate:
            tag = "approximate"
            if self.refining:
                tag += "(refining)"
            parts.append(tag)
            if self.estimator:
                parts.append(self.estimator)
        return " ".join(parts)


@dataclasses.dataclass
class ServiceResponse:
    """``result`` is the engine-shaped CountResult/PeelResult;
    ``execution`` its ExecutionReport (None on an exact cache hit);
    ``service`` the serving-layer audit."""

    result: Any
    service: ServiceReport
    execution: Optional[_res.ExecutionReport] = None


@dataclasses.dataclass
class _Registration:
    """One resident graph version."""

    key: str
    version: str
    graph: BipartiteGraph
    rg: RankedGraph
    order: str
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock
    )
    # lazily-computed resident peel inputs, shared across queries
    tip_side: Optional[int] = None
    tip_counts: Optional[np.ndarray] = None
    wing_counts: Optional[np.ndarray] = None
    # lazily-built host CSR for the sampling estimator (approx tier)
    sample_state: Optional[_approx.SampleState] = None


class ButterflyService:
    """Concurrent deadline-aware butterfly analytics over resident
    graphs. See the module docstring for the execution pipeline; knob
    reference lives in README.md.

    ``workers`` bounds concurrent execution; ``queue_cap`` bounds the
    line behind them (admission capacity = workers + queue_cap).
    ``default_deadline_s`` applies when a query carries none
    (``None`` = no deadline). Breaker knobs are per-(version, rung);
    ``clock`` injects monotonic time for deterministic tests (every
    time the service reads goes through it). ``device`` is where every
    query runs (``None`` means CUDA, and raises without a card; pass
    ``device="cpu"`` for the host). Exact counts are int64
    (``default_count_dtype()``).
    """

    def __init__(
        self,
        *,
        workers: int = 2,
        queue_cap: int = 8,
        default_deadline_s: Optional[float] = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 5.0,
        ewma_alpha: float = 0.4,
        order: str = "degree",
        clock: Callable[[], float] = time.monotonic,
        policy: Optional[_res.ResiliencePolicy] = None,
        refine_approx: bool = True,
        device=None,
    ):
        if int(workers) < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if int(queue_cap) < 0:
            raise ValueError(f"queue_cap must be >= 0, got {queue_cap}")
        self.device = resolve_device(device)
        self.workers = int(workers)
        self.default_deadline_s = default_deadline_s
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.ewma_alpha = float(ewma_alpha)
        self.order = order
        self._clock = clock
        self._policy = policy or _res.ResiliencePolicy(clock=clock)
        self.admission = AdmissionController(self.workers + int(queue_cap))
        self.cache = ResultCache()
        self._graphs: Dict[str, _Registration] = {}
        self._breakers: Dict[Tuple[str, str], CircuitBreaker] = {}
        self._cost_ewma: Dict[Tuple[str, str], float] = {}
        self._lock = threading.Lock()
        self._pool = _cf.ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="bfly-serve"
        )
        self.shed = 0
        self.served = 0
        self.stale_served = 0
        self.approx_served = 0
        self.refine_approx = bool(refine_approx)
        self._refining: set = set()

    # -- registration --------------------------------------------------

    def register(self, key: str, graph: BipartiteGraph) -> str:
        """Make ``graph`` resident under ``key``; returns its version
        (content hash). Re-registering identical content is a no-op;
        new content preprocesses the new version and invalidates the
        old version's exact cache entries (stale entries survive as
        the explicitly-marked fallback tier)."""
        version = graph.content_hash()
        with self._lock:
            existing = self._graphs.get(key)
            if existing is not None and existing.version == version:
                return version
        # preprocess outside the lock: O(m log m) ranking + CSR build
        graph.accumulator_preflight()
        ordering = make_order(graph, self.order, device=self.device)
        rg = preprocess(graph, ordering, order_name=self.order)
        rec = _Registration(
            key=key, version=version, graph=graph, rg=rg, order=self.order
        )
        with self._lock:
            existing = self._graphs.get(key)
            if existing is not None and existing.version == version:
                return version  # raced with an identical register
            if existing is not None:
                self.cache.invalidate_version(existing.version)
            self._graphs[key] = rec
        return version

    def registered(self) -> Dict[str, str]:
        with self._lock:
            return {k: r.version for k, r in self._graphs.items()}

    def _registration(self, key: str) -> _Registration:
        with self._lock:
            rec = self._graphs.get(key)
        if rec is None:
            raise KeyError(
                f"graph {key!r} is not registered "
                f"(known: {sorted(self._graphs)})"
            )
        return rec

    # -- breakers / cost model ----------------------------------------

    def _breaker(self, version: str, rung: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get((version, rung))
            if br is None:
                br = CircuitBreaker(
                    threshold=self.breaker_threshold,
                    cooldown_s=self.breaker_cooldown_s,
                    clock=self._clock,
                )
                self._breakers[(version, rung)] = br
            return br

    def _estimate_s(self, version: str, rung: str) -> Optional[float]:
        with self._lock:
            return self._cost_ewma.get((version, rung))

    def _observe_cost(self, version: str, rung: str, wall_s: float) -> None:
        with self._lock:
            prev = self._cost_ewma.get((version, rung))
            self._cost_ewma[(version, rung)] = (
                wall_s if prev is None
                else self.ewma_alpha * wall_s
                + (1.0 - self.ewma_alpha) * prev
            )

    def breaker_snapshot(self, version: str) -> Dict[str, dict]:
        with self._lock:
            items = [
                (rung, br) for (v, rung), br in self._breakers.items()
                if v == version
            ]
        return {rung: br.snapshot() for rung, br in items}

    # -- query entry points -------------------------------------------

    def submit(self, query: Query) -> "_cf.Future[ServiceResponse]":
        """Admit-or-shed, then enqueue on the bounded pool. Raises
        :class:`~repro_torch.core.resilience.AdmissionRejected`
        *synchronously* when the house is full — shedding must cost
        the caller nothing but the refusal."""
        query.validate()
        rec = self._registration(query.graph)  # typed KeyError pre-admit
        try:
            self.admission.try_admit()
        except _res.AdmissionRejected:
            self.shed += 1
            raise
        budget = (query.deadline_s if query.deadline_s is not None
                  else self.default_deadline_s)
        deadline = (None if budget is None
                    else _res.Deadline(budget, clock=self._clock))
        t_submit = self._clock()
        fut = self._pool.submit(self._run, query, rec, deadline, t_submit)

        def _release(_f):
            self.admission.release()

        fut.add_done_callback(_release)
        return fut

    def query(self, query: Query) -> ServiceResponse:
        """Synchronous :meth:`submit`; raises the worker's typed error
        (AdmissionRejected / DeadlineExceeded / ResilienceError)
        directly rather than wrapped in a concurrent.futures error."""
        return self.submit(query).result()

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ButterflyService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- resident peel inputs -----------------------------------------

    def _counts(self, rec: _Registration, mode: str):
        """The int64 counts behind a peel query, on the default count
        engine (the reference counts them on its plain engine: the
        values are the same)."""
        return _count.count_butterflies(
            rec.graph, mode=mode, order=rec.order,
            count_dtype=_count.default_count_dtype(),
            engine=DEFAULT_COUNT_ENGINE, device=self.device,
        )

    def _tip_inputs(self, rec: _Registration, side: Optional[int]):
        """Resident per-vertex counts for tip peeling (computed once
        per version; the engines treat them as read-only)."""
        with rec.lock:
            if rec.tip_counts is None:
                w_u, w_v = rec.graph.wedge_totals()
                rec.tip_side = 0 if w_u <= w_v else 1
                r = self._counts(rec, "vertex")
                rec.tip_counts = np.asarray(
                    r.per_u if rec.tip_side == 0 else r.per_v
                )
            if side is not None and side != rec.tip_side:
                # forced off-default side: compute on demand, uncached
                r = self._counts(rec, "vertex")
                return side, np.asarray(r.per_u if side == 0 else r.per_v)
            return rec.tip_side, rec.tip_counts

    def _wing_inputs(self, rec: _Registration) -> np.ndarray:
        with rec.lock:
            if rec.wing_counts is None:
                rec.wing_counts = np.asarray(
                    self._counts(rec, "edge").per_edge
                )
            return rec.wing_counts

    def _sample_state(self, rec: _Registration) -> _approx.SampleState:
        """Resident host CSR for the sampling estimator (built once
        per version, like the peel inputs)."""
        with rec.lock:
            if rec.sample_state is None:
                rec.sample_state = _approx.SampleState.build(rec.graph)
            return rec.sample_state

    # -- ladder construction ------------------------------------------

    def _count_rungs(self, rec: _Registration, q: Query):
        engine = q.resolved_engine()
        ladder = _count.COUNT_LADDERS.get(engine, (engine,))
        # one upload and one wedge-count pass per miss, inside the first
        # rung attempt that counts: every later retry and descent counts
        # on it, and a failure there is that attempt's outcome
        rungs = _count._count_rungs(
            lambda: _count._prepare_ranked(rec.rg, "low", self.device),
            ladder, aggregation=q.aggregation, mode=q.mode,
            dtype=_count.default_count_dtype(), max_chunk=None,
            batch_rows=8,
        )
        exact_validate = _count.count_validator(rec.graph, q.mode)

        if q.accuracy != "approx":
            interpret = lambda out: _count.interpret_counts(  # noqa: E731
                rec.rg, rec.graph, q.mode, out, q.aggregation, rec.order
            )
            return rungs, exact_validate, interpret

        # approx tier: the exact ladder keeps first claim on the
        # budget; the zero-cost sample rung sits underneath so a
        # deadline too tight for any engine still yields an estimate
        # rather than a ResilienceError (COUNT_LADDERS["sample"])
        def run_sample(shrinks):
            state = self._sample_state(rec)
            return _approx.sample_count(state, eps=q.eps, seed=0)

        for name in _count.COUNT_LADDERS["sample"]:
            rungs.append(_res.Rung(
                name, run_sample, shrinkable=False, zero_cost=True
            ))

        approx_validate = _sparsify.approx_validator(rec.graph)

        def validate(out) -> Optional[str]:
            if isinstance(out, _approx.ApproxCount):
                return approx_validate(out)
            return exact_validate(out)

        def interpret(out):
            if isinstance(out, _approx.ApproxCount):
                return out  # already host-side, nothing to rank-unmap
            return _count.interpret_counts(
                rec.rg, rec.graph, q.mode, out, q.aggregation, rec.order
            )

        return rungs, validate, interpret

    def _peel_rungs(self, rec: _Registration, q: Query):
        engine = q.resolved_engine()
        engines = ("device", "host") if engine == "device" else ("host",)
        modes = (("exact", "range") if q.peel_mode == "exact"
                 else ("range",))
        # deadline degradation order: cheapen the round structure
        # first (exact -> range collapses ladder rounds), then give up
        # the device round loop (device -> host)
        combos = [(e, m) for e in engines for m in modes]

        if q.kind == "peel_wings":
            counts = self._wing_inputs(rec)
            frontend, kwargs = _peel.peel_wings, {}
        else:
            side, counts = self._tip_inputs(rec, q.side)
            frontend = (_peel.peel_tips if q.kind == "peel_tips"
                        else _peel.peel_tips_stored)
            kwargs = {"side": side}

        def make(eng, pm):
            def run(shrinks):
                # resilience=False: the service ladder owns descent,
                # retries, validation, and reporting for this rung
                return frontend(
                    rec.graph, counts=counts, engine=eng,
                    aggregation=q.aggregation, peel_mode=pm,
                    resilience=False, device=self.device, **kwargs,
                )

            return _res.Rung(f"{eng}/{pm}", run, shrinkable=False)

        validate = _peel.peel_validator(counts)
        return ([make(e, m) for e, m in combos], validate,
                lambda out: out)

    # -- the worker ---------------------------------------------------

    def _run(self, q: Query, rec: _Registration,
             deadline: Optional[_res.Deadline],
             t_submit: float) -> ServiceResponse:
        queue_wait = self._clock() - t_submit
        _faults.maybe_overload("serve.worker")
        qkey = q.cache_key()
        version = rec.version

        def finish(report: ServiceReport) -> ServiceReport:
            report.queue_wait_s = queue_wait
            report.total_wall_s = self._clock() - t_submit
            report.deadline_s = (
                None if deadline is None else deadline.budget_s
            )
            if deadline is not None:
                report.deadline_slack_s = deadline.remaining_s()
            report.breakers = self.breaker_snapshot(version)
            return report

        if q.accuracy == "approx":
            # upgrade path: a finished exact answer (possibly from an
            # earlier refine-behind) beats re-sampling — serve it and
            # drop the "approximate" marking entirely
            exact_hit = self.cache.get(
                version, q.exact_equivalent().cache_key()
            )
            if exact_hit is not None:
                self.served += 1
                return ServiceResponse(
                    result=exact_hit,
                    service=finish(ServiceReport(
                        graph=q.graph, version=version, kind=q.kind,
                        cache="hit",
                    )),
                    execution=None,
                )

        cached = self.cache.get(version, qkey)
        if cached is not None:
            self.served += 1
            return ServiceResponse(
                result=cached,
                service=finish(ServiceReport(
                    graph=q.graph, version=version, kind=q.kind,
                    cache="hit",
                    approximate=isinstance(cached, _approx.ApproxCount),
                    estimator=getattr(cached, "describe", lambda: None)()
                    if isinstance(cached, _approx.ApproxCount) else None,
                )),
                execution=None,
            )

        if q.kind == "count":
            rungs, validate, interpret = self._count_rungs(rec, q)
        else:
            rungs, validate, interpret = self._peel_rungs(rec, q)

        def gate(rung: _res.Rung) -> Optional[str]:
            if rung.zero_cost:
                # mirror the policy's own deadline rule: an expired
                # budget can always afford a zero-cost rung, so the
                # breaker/EWMA veto never applies to it either
                return None
            br = self._breaker(version, rung.name)
            reason = br.allow()
            if reason is not None:
                return reason
            if deadline is not None:
                est = self._estimate_s(version, rung.name)
                if est is not None and est > deadline.remaining_s():
                    br.record_neutral()  # return an unused probe slot
                    return (f"estimated {est:.3f}s exceeds remaining "
                            f"budget {deadline.remaining_s():.3f}s")
            return None

        def on_rung(attempt: _res.RungAttempt) -> None:
            br = self._breaker(version, attempt.rung)
            if attempt.outcome == "ok":
                br.record_success()
                self._observe_cost(version, attempt.rung, attempt.wall_s)
            elif attempt.outcome in ("resource-exhausted", "device-lost"):
                br.record_failure()
                self._observe_cost(version, attempt.rung, attempt.wall_s)
            elif attempt.outcome in ("skipped", "deadline-skipped"):
                pass  # never ran: no health or cost signal
            else:
                # degradable non-breaker outcomes (capacity, validation,
                # straggler, checkpoint, deadline-exceeded): clear any
                # probe slot, leave failure counts alone
                br.record_neutral()
                if attempt.wall_s:
                    self._observe_cost(
                        version, attempt.rung, attempt.wall_s
                    )

        try:
            out, report = self._policy.execute(
                f"serve.{q.kind}", rungs, validate,
                deadline=deadline, rung_gate=gate, on_rung=on_rung,
            )
        except _res.AdmissionRejected:
            raise
        except _res.ResilienceError as e:
            stale = (self.cache.stale_get(q.graph, qkey)
                     if q.allow_stale else None)
            if stale is None:
                raise
            stale_version, result = stale
            self.stale_served += 1
            self.served += 1
            return ServiceResponse(
                result=result,
                service=finish(ServiceReport(
                    graph=q.graph, version=version, kind=q.kind,
                    cache="stale", stale_version=stale_version,
                    exec_wall_s=getattr(
                        getattr(e, "report", None), "wall_s", 0.0
                    ) or 0.0,
                    rungs_tried=[
                        f"{a.rung}[{a.outcome}]"
                        for a in getattr(
                            getattr(e, "report", None), "attempts", []
                        )
                    ],
                )),
                execution=getattr(e, "report", None),
            )

        is_approx = isinstance(out, _approx.ApproxCount)
        if is_approx:
            report.estimator = out.describe()
        result = interpret(out)
        result = self._policy.attach(result, report)
        self.cache.put(version, q.graph, qkey, result)
        self.served += 1
        refining = False
        if is_approx:
            self.approx_served += 1
            if self.refine_approx:
                refining = self._refine_behind(q, rec)
        return ServiceResponse(
            result=result,
            service=finish(ServiceReport(
                graph=q.graph, version=version, kind=q.kind,
                cache="miss",
                exec_wall_s=report.wall_s,
                rungs_tried=[
                    f"{a.rung}[{a.outcome}]" for a in report.attempts
                ],
                final_rung=report.final_rung,
                degraded=report.degraded,
                approximate=is_approx,
                estimator=report.estimator,
                refining=refining,
            )),
            execution=report,
        )

    def _refine_behind(self, q: Query, rec: _Registration) -> bool:
        """Best-effort background exact recount after an approximate
        answer: submit the exact-equivalent query (no deadline, no
        stale fallback) so the next identical approx query upgrades
        to the cached exact result. Deduped per (version, exact key);
        admission rejection just means the house is busy — the
        estimate already answered the caller."""
        exact_q = q.exact_equivalent()
        token = (rec.version, exact_q.cache_key())
        with self._lock:
            if token in self._refining:
                return False
            self._refining.add(token)

        def _done(f: "_cf.Future") -> None:
            with self._lock:
                self._refining.discard(token)
            f.exception()  # swallow: refinement is best-effort

        try:
            self.submit(exact_q).add_done_callback(_done)
        except Exception:
            with self._lock:
                self._refining.discard(token)
            return False
        return True

    def stats(self) -> dict:
        return {
            "admission": self.admission.stats(),
            "cache": self.cache.stats(),
            "served": self.served,
            "stale_served": self.stale_served,
            "approx_served": self.approx_served,
            "shed": self.shed,
            "graphs": self.registered(),
        }
