"""Helpers shared by the port's parity tests: seeded edge lists, and
running one graph through a reference engine and its port counterpart.
Data crosses between the packages as numpy arrays."""
import functools

import numpy as np

import repro.core as ref_core
from repro_torch.core import BipartiteGraph, count_butterflies
from repro_torch.core.count import ENGINE_MAP

FIELDS = ("total", "per_u", "per_v", "per_edge")
MODE_FIELDS = {
    "global": ("total",),
    "vertex": ("per_u", "per_v"),
    "edge": ("per_edge",),
    "all": FIELDS,
}


def rand_edges(nu, nv, m, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, nu, m), rng.integers(0, nv, m)], 1)


def assert_same(got, want, ctx, fields=FIELDS):
    """The count fields equal in presence, dtype, shape and value."""
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), (ctx, f)
        if b is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
            assert np.array_equal(a, b), (ctx, f)


def both(e, nu, nv, ref_engine, **kw):
    """Run the reference engine and its port counterpart (on the CPU)
    on one graph; returns ``(port result, reference result)``."""
    want = ref_core.count_butterflies(
        ref_core.BipartiteGraph(nu, nv, e), engine=ref_engine, **kw)
    got = count_butterflies(BipartiteGraph(nu, nv, e), device="cpu",
                            engine=ENGINE_MAP[ref_engine], **kw)
    return got, want


@functools.lru_cache(maxsize=None)
def reference_all(graph, ref_engine, aggregation, cache_opt, max_chunk):
    """The reference's ``mode="all"`` result on the seeded graph
    ``graph = (nu, nv, m, seed)``, computed once per test process."""
    nu, nv = graph[:2]
    return ref_core.count_butterflies(
        ref_core.BipartiteGraph(nu, nv, rand_edges(*graph)), mode="all",
        engine=ref_engine, aggregation=aggregation, cache_opt=cache_opt,
        max_chunk=max_chunk)


def check_mode(graph, ref_engine, mode, aggregation, cache_opt, max_chunk):
    """One mode of the port engine against the reference engine's
    ``mode="all"`` arrays. The reference's single modes return exactly
    those arrays (its own tests pin single modes to ``mode="all"`` bit
    for bit), so each reference configuration runs once, not per mode.
    Fields outside ``mode`` must be None; under ``mode="all"`` the plan
    summaries must match too, engine name mapped."""
    want = reference_all(graph, ref_engine, aggregation, cache_opt,
                         max_chunk)
    nu, nv = graph[:2]
    engine = ENGINE_MAP[ref_engine]
    got = count_butterflies(
        BipartiteGraph(nu, nv, rand_edges(*graph)), mode=mode,
        engine=engine, aggregation=aggregation, cache_opt=cache_opt,
        max_chunk=max_chunk, device="cpu")
    ctx = (ref_engine, mode, aggregation, cache_opt)
    assert_same(got, want, ctx, MODE_FIELDS[mode])
    for f in set(FIELDS) - set(MODE_FIELDS[mode]):
        assert getattr(got, f) is None, (ctx, f)
    assert got.report.final_rung == engine
    if mode == "all":
        assert got.report.plan == want.report.plan.replace(
            f"engine={ref_engine}", f"engine={engine}")
