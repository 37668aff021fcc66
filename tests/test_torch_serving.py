"""The port's query service against the reference's.

The serve primitives (admission, breakers, cache) are checked as
``tests/test_serving.py`` checks the reference's. The service itself
runs the same query streams as that file, on its graphs ``G1`` and
``G2``, through the reference's service and the port's (``device="cpu"``)
side by side: results bit for bit, cache tiers, the approximate and
degraded flags, and ``rungs_tried`` with engine names mapped through
``ENGINE_MAP`` must agree, and where the reference raises, the port
raises the same typed error.

Time is a fake clock wherever the reference's checks do not need real
time: deadlines run out on a clock that ticks at every read, breaker
cooldowns pass by advancing it. The chaos cells (overload shed,
slow-rung degradation) run under ``REPRO_FAULTS=1``, as the
reference's do.
"""
import concurrent.futures as cf
import dataclasses
import os
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.serve as ref_serve  # noqa: E402
from repro.core import peel as ref_peel  # noqa: E402
from repro.data import graphs as ref_graphs  # noqa: E402
from repro.testing import faults as ref_faults  # noqa: E402
from repro_torch.core import resilience as res  # noqa: E402
from repro_torch.core.approx import ApproxCount  # noqa: E402
from repro_torch.core.count import ENGINE_MAP  # noqa: E402
from repro_torch.data.graphs import powerlaw_bipartite  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionController,
    AdmissionRejected,
    ButterflyService,
    CircuitBreaker,
    Query,
    ResultCache,
)
from repro_torch.serve import service as service_mod  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

RUN_FAULTS = os.environ.get("REPRO_FAULTS") == "1"
needs_faults = pytest.mark.skipif(
    not RUN_FAULTS, reason="chaos cells run under REPRO_FAULTS=1"
)

SPECS = {"g1": (80, 60, 400, 1), "g2": (70, 90, 350, 2)}
G1 = powerlaw_bipartite(*SPECS["g1"][:3], seed=SPECS["g1"][3])
G2 = powerlaw_bipartite(*SPECS["g2"][:3], seed=SPECS["g2"][3])
PORT_G = {"g1": G1, "g2": G2}
REF_G = {k: ref_graphs.powerlaw_bipartite(*s[:3], seed=s[3])
         for k, s in SPECS.items()}
# port engine name -> reference engine name; the port's default count
# engine fused_cuda stands where the reference's fused_pallas does
TO_REF = {v: k for k, v in ENGINE_MAP.items()}
COUNT_FIELDS = ("total", "per_u", "per_v", "per_edge")
PEEL_FIELDS = ("numbers", "side", "rounds", "sub_rounds", "round_sizes")
APPROX_FIELDS = ("estimate", "stddev", "ci95", "p", "n_samples", "eps",
                 "seed", "method")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TickClock(FakeClock):
    """Advances ``tick`` seconds at every read: a deadline shorter than
    one tick has run out by the time the ladder first looks at it."""

    def __init__(self, tick=1e-3):
        super().__init__()
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _mapped(rungs):
    """``name[outcome]`` strings with reference engine names mapped to
    the port's."""
    out = []
    for s in rungs:
        name, _, rest = s.partition("[")
        out.append(f"{ENGINE_MAP.get(name, name)}[{rest}")
    return out


def assert_same_result(got, want):
    """A port result against the reference's, bit for bit. Counts are
    int64 in the port's service (the reference's count int32 here)."""
    if isinstance(want, ref_core.ApproxCount):
        assert isinstance(got, ApproxCount)
        for f in APPROX_FIELDS:
            assert getattr(got, f) == getattr(want, f), f
        return
    fields = COUNT_FIELDS if hasattr(want, "per_edge") else PEEL_FIELDS
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), f
    if hasattr(got, "per_edge"):
        for f in COUNT_FIELDS:
            if getattr(got, f) is not None:
                assert np.asarray(getattr(got, f)).dtype == np.int64, f


class Pair:
    """The reference's service and the port's, each with its own clock,
    both holding ``g1`` and ``g2``. ``query`` runs one query through both
    and checks that they agree."""

    def __init__(self, clock=FakeClock, **kw):
        self.ref_clock, self.clock = clock(), clock()
        self.ref = ref_serve.ButterflyService(clock=self.ref_clock, **kw)
        self.port = ButterflyService(clock=self.clock, device="cpu", **kw)
        for key in SPECS:
            assert (self.ref.register(key, REF_G[key])
                    == self.port.register(key, PORT_G[key]))

    def close(self):
        self.ref.close()
        self.port.close()

    def versions(self, key):
        return self.ref.registered()[key], self.port.registered()[key]

    def query(self, **q):
        """``q`` in the port's terms; a count query with no engine runs
        the reference's fused_pallas beside the port's fused_cuda.
        Returns ``(port response, reference response)``, or the pair of
        typed errors both raised."""
        ref_q = dict(q)
        if q.get("kind", "count") == "count":
            ref_q["engine"] = TO_REF[q.get("engine") or "fused_cuda"]
        try:
            want = self.ref.query(ref_serve.Query(**ref_q))
        except Exception as e:  # the port must raise the same type
            with pytest.raises(Exception) as ei:
                self.port.query(Query(**q))
            assert type(ei.value).__name__ == type(e).__name__, (
                ei.value, e)
            return ei.value, e
        got = self.port.query(Query(**q))
        assert_same_result(got.result, want.result)
        for f in ("cache", "approximate", "degraded", "refining",
                  "stale_version", "estimator"):
            assert getattr(got.service, f) == getattr(want.service, f), f
        assert got.service.final_rung == ENGINE_MAP.get(
            want.service.final_rung, want.service.final_rung)
        assert got.service.rungs_tried == _mapped(want.service.rungs_tried)
        return got, want


@pytest.fixture(scope="module")
def pair():
    p = Pair(workers=2, queue_cap=4, clock=TickClock)
    yield p
    p.close()


# ---------------------------------------------------------------------------
# Serve primitives
# ---------------------------------------------------------------------------


def test_admission_controller_sheds_typed():
    adm = AdmissionController(2)
    adm.try_admit()
    adm.try_admit()
    with pytest.raises(AdmissionRejected) as ei:
        adm.try_admit()
    assert ei.value.queue_depth == 2 and ei.value.capacity == 2
    assert isinstance(ei.value, res.ResilienceError)
    adm.release()
    adm.try_admit()
    s = adm.stats()
    assert s["rejected"] == 1 and s["admitted"] == 3
    assert s["peak_occupancy"] == 2
    with pytest.raises(ValueError):
        AdmissionController(0)


def test_circuit_breaker_state_machine():
    clk = FakeClock()
    br = CircuitBreaker(threshold=2, cooldown_s=5.0, clock=clk)
    assert br.state == "closed" and br.allow() is None
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and br.trips == 1
    assert "breaker open" in br.allow()
    clk.advance(5.0)
    assert br.state == "half-open"
    assert br.allow() is None
    assert "probe already in flight" in br.allow()
    br.record_failure()
    assert br.state == "open" and br.trips == 2
    clk.advance(5.0)
    assert br.allow() is None
    br.record_success()
    assert br.state == "closed" and br.allow() is None
    assert br.snapshot()["consecutive_failures"] == 0


def test_circuit_breaker_neutral_frees_probe():
    clk = FakeClock()
    br = CircuitBreaker(threshold=1, cooldown_s=1.0, clock=clk)
    br.record_failure()
    clk.advance(1.0)
    assert br.allow() is None
    br.record_neutral()
    assert br.allow() is None


def test_result_cache_versioned_and_stale():
    c = ResultCache()
    assert c.get("v1", "q") is None
    c.put("v1", "g", "q", "r1")
    assert c.get("v1", "q") == "r1"
    assert c.get("v2", "q") is None
    assert c.invalidate_version("v1") == 1
    assert c.get("v1", "q") is None
    assert c.stale_get("g", "q") == ("v1", "r1")
    assert c.stale_get("g", "other") is None
    s = c.stats()
    assert s["hits"] == 1 and s["stale_hits"] == 1


def _tensors(obj, seen=None):
    """Every ``torch.Tensor`` reachable from ``obj`` through tuples,
    lists, dicts and dataclasses."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (tuple, list, set)):
        items = list(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        return []
    return [t for x in items for t in _tensors(x, seen)]


def test_cache_holds_no_tensor():
    """Every value the service caches (count results of every mode,
    peel results of every kind and engine, estimates) is host data: a
    long-lived service pins no device memory through its cache."""
    service = ButterflyService(workers=2, device="cpu", clock=TickClock())
    service.register("g1", G1)
    service.register("g2", G2)
    try:
        for mode in ("global", "vertex", "edge", "all"):
            service.query(Query(graph="g1", mode=mode))
        for kind in ("peel_tips", "peel_tips_stored", "peel_wings"):
            for engine in ("host", "device"):
                service.query(Query(graph="g2", kind=kind, engine=engine))
        r = service.query(Query(graph="g2", accuracy="approx",
                                deadline_s=1e-6, allow_stale=False))
        assert r.service.approximate
        service.close()  # waits for the refine-behind recount
        stores = (service.cache._exact, service.cache._stale)
        assert sum(len(s) for s in stores) >= 2 * 12
        assert _tensors(stores) == []
    finally:
        service.close()


# ---------------------------------------------------------------------------
# ButterflyService against the reference's
# ---------------------------------------------------------------------------


def test_register_idempotent_and_versioned(pair):
    v_ref, v1 = pair.versions("g1")
    assert v1 == v_ref == G1.content_hash()
    assert pair.port.register("g1", G1) == v1
    assert pair.port.registered()["g2"] != v1
    with pytest.raises(KeyError, match="not registered"):
        pair.port.query(Query(graph="nope"))


def test_count_query_parity_all_modes(pair):
    for mode in ("global", "vertex", "edge", "all"):
        for engine in (None, "fused", "torch"):
            got, want = pair.query(graph="g1", kind="count", mode=mode,
                                   engine=engine)
            assert got.service.cache == "miss"
            assert got.execution.final_rung == (engine or "fused_cuda")
            one_shot = ref_core.count_butterflies(
                REF_G["g1"], mode=mode, engine="fused")
            assert_same_result(got.result, one_shot)


def test_peel_query_parity_all_kinds(pair):
    refs = {
        "peel_tips": ref_peel.peel_tips(REF_G["g2"]),
        "peel_tips_stored": ref_peel.peel_tips_stored(REF_G["g2"]),
        "peel_wings": ref_peel.peel_wings(REF_G["g2"]),
    }
    for kind, ref in refs.items():
        for engine in (None, "device"):
            got, _want = pair.query(graph="g2", kind=kind, engine=engine)
            assert_same_result(got.result, ref)
            assert got.service.final_rung == f"{engine or 'host'}/exact"
    got, _want = pair.query(graph="g2", kind="peel_tips",
                            peel_mode="range")
    assert got.service.final_rung == "host/range"


def test_cache_hit_is_exact_and_reported(pair):
    q = dict(graph="g1", kind="count", mode="global")
    first, _ = pair.query(**q)
    hit, _ = pair.query(**q)
    assert hit.service.cache == "hit"
    assert hit.execution is None
    assert int(hit.result.total) == int(first.result.total)
    assert pair.port.cache.stats()["hits"] >= 1


def test_reregistration_invalidates_exact_cache():
    p = Pair(workers=1, queue_cap=2)
    try:
        q = dict(graph="g1", kind="count", mode="global")
        r1, _ = p.query(**q)
        assert p.query(**q)[0].service.cache == "hit"
        p.ref.register("g1", REF_G["g2"])
        p.port.register("g1", G2)
        r2, _ = p.query(**q)
        assert r2.service.cache == "miss"
        assert int(r2.result.total) != int(r1.result.total)
    finally:
        p.close()


def test_bad_queries_are_typed(pair):
    for q in (dict(kind="frobnicate"), dict(mode="nope"),
              dict(deadline_s=-1.0), dict(kind="peel_tips", engine="gpu"),
              dict(kind="peel_tips", peel_mode="fast")):
        got, want = pair.query(graph="g1", **q)
        assert isinstance(got, ValueError) and isinstance(want, ValueError)
    # the port's engine names, not the reference's
    with pytest.raises(ValueError, match="engine"):
        pair.port.query(Query(graph="g1", kind="count", engine="xla"))
    with pytest.raises(ValueError, match="engine"):
        pair.port.query(Query(graph="g1", kind="count", engine="fused_pallas"))


def test_deadline_degradation_is_bitwise_identical():
    """A learned cost above the budget skips the top rung on both
    services; the degraded answer is bitwise-identical."""
    p = Pair(workers=1)
    try:
        warm, _ = p.query(graph="g1", kind="count", mode="vertex")
        for svc, rung in ((p.ref, "fused_pallas"), (p.port, "fused_cuda")):
            version = svc.registered()["g1"]
            svc._observe_cost(version, rung, 10.0)
            svc.cache.invalidate_version(version)
        got, _ = p.query(graph="g1", kind="count", mode="vertex",
                         deadline_s=1.0)
        assert got.service.degraded and got.service.final_rung == "fused"
        assert got.service.rungs_tried == ["fused_cuda[skipped]",
                                           "fused[ok]"]
        assert np.array_equal(got.result.per_u, warm.result.per_u)
        assert np.array_equal(got.result.per_v, warm.result.per_v)
    finally:
        p.close()


def test_stale_fallback_marked_and_typed_without_it(pair):
    q = dict(graph="g1", kind="count", mode="edge")
    good, _ = pair.query(**q)
    for svc in (pair.ref, pair.port):
        svc.cache.invalidate_version(svc.registered()["g1"])
    got, _ = pair.query(deadline_s=1e-6, **q)
    assert got.service.cache == "stale"
    assert got.service.stale_version == pair.versions("g1")[1]
    assert np.array_equal(got.result.per_edge, good.result.per_edge)
    for svc in (pair.ref, pair.port):
        svc.cache.invalidate_version(svc.registered()["g1"])
    err, _ = pair.query(deadline_s=1e-6, allow_stale=False, **q)
    assert isinstance(err, res.DeadlineExceeded)


def test_breaker_opens_on_repeated_oom_and_recovers():
    p = Pair(workers=1, queue_cap=2, breaker_threshold=2,
             breaker_cooldown_s=5.0)
    q = dict(graph="g1", kind="count", mode="global", engine="torch",
             allow_stale=False)
    try:
        with faults.inject("oom", site="count.torch"), \
                ref_faults.inject("oom", site="count.xla"):
            for _ in range(2):
                err, _ = p.query(**q)
                assert isinstance(err, res.ResourceExhausted)
        snaps = [svc.breaker_snapshot(svc.registered()["g1"])
                 for svc in (p.port, p.ref)]
        assert snaps[0]["torch"] == snaps[1]["xla"]
        assert snaps[0]["torch"]["state"] == "open"
        assert snaps[0]["torch"]["trips"] == 1
        err, _ = p.query(**q)  # the only rung is gated
        assert isinstance(err, res.RungUnavailable)
        p.clock.advance(5.0)
        p.ref_clock.advance(5.0)
        got, _ = p.query(**q)  # the half-open probe runs clean
        assert got.service.final_rung == "torch"
        state = p.port.breaker_snapshot(p.versions("g1")[1])["torch"]
        assert state["state"] == "closed"
    finally:
        p.close()


def test_card_out_of_memory_trips_the_breaker(monkeypatch):
    """``torch.cuda.OutOfMemoryError`` from a rung is a breaker-class
    failure, as RESOURCE_EXHAUSTED is in the reference: after its
    shrink-retries the rung counts as ``resource-exhausted``, the query
    descends to the next rung, and ``threshold`` such queries open the
    rung's breaker."""
    from repro_torch.core import count as count_mod

    orig = count_mod.count_from_ranked

    def oom_on_fused_cuda(rg, **kw):
        if kw["engine"] == "fused_cuda":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return orig(rg, **kw)

    monkeypatch.setattr(count_mod, "count_from_ranked", oom_on_fused_cuda)
    clk = FakeClock()
    service = ButterflyService(
        workers=1, device="cpu", clock=clk, breaker_threshold=2,
        policy=res.ResiliencePolicy(clock=clk, backoff_base_s=0.0))
    version = service.register("g", G1)
    try:
        for _ in range(2):
            r = service.query(Query(graph="g"))
            assert r.service.rungs_tried == ["fused_cuda[resource-exhausted]",
                                             "fused[ok]"]
            assert r.execution.attempts[0].retries == 2
            service.cache.invalidate_version(version)
        snap = service.breaker_snapshot(version)["fused_cuda"]
        assert snap["state"] == "open" and snap["trips"] == 1
        r = service.query(Query(graph="g"))
        assert r.service.rungs_tried == ["fused_cuda[skipped]", "fused[ok]"]
    finally:
        service.close()


def test_admission_shed_is_synchronous_and_typed():
    service = ButterflyService(workers=1, queue_cap=0, device="cpu")
    service.register("g", G1)
    gate = threading.Event()
    release = threading.Event()
    orig = service._run

    def slow_run(*a, **kw):
        gate.set()
        release.wait(60.0)
        return orig(*a, **kw)

    service._run = slow_run
    try:
        fut = service.submit(Query(graph="g", kind="count"))
        assert gate.wait(60.0)
        with pytest.raises(AdmissionRejected) as ei:
            service.submit(Query(graph="g", kind="count"))
        assert ei.value.capacity == 1
        release.set()
        fut.result(timeout=120)
        assert service.stats()["shed"] == 1
    finally:
        release.set()
        service.close()


def test_overload_fault_fires_on_the_worker():
    """The ``overload`` fault kind: armed, it fires once per query at
    the service's worker site; unknown kinds are refused."""
    assert "overload" in faults.KINDS
    service = ButterflyService(workers=1, device="cpu", clock=FakeClock())
    service.register("g", G1)
    try:
        with faults.inject("overload", site="serve.worker",
                           delay=0.0) as f:
            service.query(Query(graph="g"))
            service.query(Query(graph="g"))  # a cache hit runs it too
        assert f.fired == 2 and f.hits == ["serve.worker"] * 2
    finally:
        service.close()
    with pytest.raises(ValueError, match="fault kind"):
        with faults.inject("meteor_strike"):
            pass


# ---------------------------------------------------------------------------
# Concurrency
# ---------------------------------------------------------------------------

MIX = [
    Query(graph="g1", kind="count", mode="global"),
    Query(graph="g1", kind="count", mode="vertex"),
    Query(graph="g2", kind="count", mode="edge"),
    Query(graph="g1", kind="peel_tips"),
    Query(graph="g2", kind="peel_tips_stored"),
    Query(graph="g2", kind="peel_wings"),
]


@pytest.fixture(scope="module")
def oracle():
    """The reference's one-shot engines on the same graphs."""
    return {
        ("g1", "count", "global"): ref_core.count_butterflies(
            REF_G["g1"], mode="global", engine="fused"),
        ("g1", "count", "vertex"): ref_core.count_butterflies(
            REF_G["g1"], mode="vertex", engine="fused"),
        ("g2", "count", "edge"): ref_core.count_butterflies(
            REF_G["g2"], mode="edge", engine="fused"),
        ("g1", "peel_tips", None): ref_peel.peel_tips(REF_G["g1"]),
        ("g2", "peel_tips_stored", None): ref_peel.peel_tips_stored(
            REF_G["g2"]),
        ("g2", "peel_wings", None): ref_peel.peel_wings(REF_G["g2"]),
    }


def _check_against_oracle(q, result, oracle):
    key = (q.graph, q.kind, q.mode if q.kind == "count" else None)
    assert_same_result(result, oracle[key])


def test_concurrent_mixed_queries_bitwise_identical_to_serial(oracle):
    """Eight client threads, twelve workers and a short thread switch
    interval, so the workers interleave often: every answer still
    equals the reference's one-shot engines, and repeat shapes come
    from the cache unpoisoned."""
    service = ButterflyService(workers=12, queue_cap=64, device="cpu")
    service.register("g1", G1)
    service.register("g2", G2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        queries = MIX * 5
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            responses = list(pool.map(service.query, queries))
        for q, r in zip(queries, responses):
            _check_against_oracle(q, r.result, oracle)
        assert service.stats()["shed"] == 0
        for q in MIX:
            r = service.query(q)
            assert r.service.cache == "hit"
            _check_against_oracle(q, r.result, oracle)
        assert service.cache.stats()["hits"] >= len(MIX)
    finally:
        sys.setswitchinterval(interval)
        service.close()


@needs_faults
def test_overload_sheds_typed_and_accepted_queries_stay_correct(oracle):
    service = ButterflyService(workers=2, queue_cap=2, device="cpu")
    service.register("g1", G1)
    service.register("g2", G2)
    try:
        service.query(MIX[0])
        offered = MIX * 4
        sheds, futs = 0, []
        with faults.inject("overload", site="serve.worker",
                           delay=0.05) as f:
            for q in offered:
                try:
                    futs.append((q, service.submit(q)))
                except AdmissionRejected as e:
                    assert e.capacity == 4
                    sheds += 1
            for q, fut in futs:
                r = fut.result(timeout=120)
                _check_against_oracle(q, r.result, oracle)
        assert f.fired > 0
        assert sheds > 0, "2x offered load must shed something"
        assert sheds + len(futs) == len(offered)
        assert service.stats()["shed"] == sheds
    finally:
        service.close()


@needs_faults
def test_slow_rung_under_deadline_degrades_never_corrupts(oracle):
    service = ButterflyService(workers=2, queue_cap=8, device="cpu")
    service.register("g1", G1)
    try:
        q = Query(graph="g1", kind="count", mode="vertex", deadline_s=0.3)
        service.query(Query(graph="g1", kind="count", mode="vertex"))
        outcomes = {"ok": 0, "stale": 0, "typed": 0}
        with faults.inject("slow_rung", site="count.fused_cuda",
                           delay=0.35) as f:
            for _ in range(4):
                service.cache.invalidate_version(
                    service.registered()["g1"])
                try:
                    r = service.query(q)
                except res.ResilienceError:
                    outcomes["typed"] += 1
                    continue
                if r.service.cache == "stale":
                    outcomes["stale"] += 1
                else:
                    outcomes["ok"] += 1
                    _check_against_oracle(q, r.result, oracle)
        assert f.fired > 0
        assert sum(outcomes.values()) == 4
    finally:
        service.close()


# ---------------------------------------------------------------------------
# the approximate tier (accuracy="approx")
# ---------------------------------------------------------------------------


def test_approx_query_validation_is_typed():
    with pytest.raises(ValueError, match="accuracy"):
        Query(graph="g", accuracy="nope").validate()
    with pytest.raises(ValueError, match="approx"):
        Query(graph="g", kind="peel_tips", accuracy="approx").validate()
    with pytest.raises(ValueError, match="approx"):
        Query(graph="g", mode="vertex", accuracy="approx").validate()
    with pytest.raises(ValueError, match="eps"):
        Query(graph="g", accuracy="approx", eps=0.0).validate()
    qa = Query(graph="g", accuracy="approx")
    assert qa.cache_key() != Query(graph="g").cache_key()
    assert qa.exact_equivalent().cache_key() == Query(graph="g").cache_key()
    assert service_mod.DEFAULT_COUNT_ENGINE == "fused_cuda"
    assert service_mod.DEFAULT_PEEL_ENGINE == "host"


def test_approx_tight_deadline_answers_from_sample():
    p = Pair(workers=1, refine_approx=False, clock=TickClock)
    try:
        q = dict(graph="g1", accuracy="approx", eps=0.1, deadline_s=1e-6,
                 allow_stale=False)
        r, _ = p.query(**q)
        assert isinstance(r.result, ApproxCount)
        assert r.service.approximate and r.service.final_rung == "sample"
        assert r.service.estimator.startswith("approx(method=sample")
        assert not r.service.refining
        assert all("deadline-skipped" in t for t in r.service.rungs_tried[:-1])
        assert r.result.ci95 > 0 and "approximate" in r.service.summary()
        r2, _ = p.query(**q)
        assert r2.service.cache == "hit" and r2.service.approximate
        r3, _ = p.query(graph="g1")
        assert r3.service.cache == "miss"
        r4, _ = p.query(**q)
        assert r4.service.cache == "hit" and not r4.service.approximate
        assert int(r4.result.total) == int(r3.result.total)
        assert p.port.stats()["approx_served"] == 1
    finally:
        p.close()


def test_approx_without_pressure_stays_exact():
    p = Pair(workers=1, refine_approx=False)
    try:
        r, _ = p.query(graph="g1", accuracy="approx")
        assert not r.service.approximate
        assert r.service.final_rung == "fused_cuda"
    finally:
        p.close()


def test_approx_refine_behind_upgrades_to_exact():
    """With one worker the refine-behind recount is queued ahead of the
    next query, so that query finds the exact answer cached."""
    p = Pair(workers=1, refine_approx=True, clock=TickClock)
    try:
        q = dict(graph="g2", accuracy="approx", eps=0.1, deadline_s=1e-6,
                 allow_stale=False)
        r, _ = p.query(**q)
        assert r.service.approximate and r.service.refining
        r2, _ = p.query(**q)
        assert r2.service.cache == "hit" and not r2.service.approximate
        exact, _ = p.query(graph="g2")
        assert exact.service.cache == "hit"
        assert int(r2.result.total) == int(exact.result.total)
        assert p.port.stats()["served"] >= 3
    finally:
        p.close()
