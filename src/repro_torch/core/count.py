"""Butterfly counting: global, per-vertex, per-edge (paper Algs. 3-4).

Given the group multiplicity ``d`` of each endpoint pair (x1, x2):
  - each endpoint gets C(d, 2) butterflies,
  - each wedge's center gets d - 1,
  - each wedge's two edges get d - 1  (Lemma 4.2).

Counts are accumulated over *rank-space* vertex ids and undirected edge
ids, then mapped back to original (U, V) ids by the public API.

This module is the counting *frontend* of the plan -> execute -> report
pipeline (``core/pipeline.py``): it validates knobs, builds a
:class:`~repro_torch.core.pipeline.WedgePlan` for the tiled engines,
hands it to the shared executors, and interprets the rank-space results
back into a :class:`CountResult`.

Engines, one-to-one with the reference package's (:data:`ENGINE_MAP`):

  - ``"torch"``: the materializing wedge path in plain PyTorch ops.
  - ``"cuda"``: the same path with the hash/dense histogram and the
    d -> (d - 1, C(d, 2)) combine through the hand-written CUDA kernels
    (``kernels/ops.py``).
  - ``"fused"``: the vertex-aligned tile loop in plain PyTorch ops; the
    global wedge array is never materialized, peak memory is O(tile).
  - ``"fused_cuda"``: the fused CUDA kernel reconstructs, aggregates,
    combines and accumulates every tile on the card.

Every engine gives bitwise-identical counts. The degradation ladders
are ``fused_cuda -> fused -> torch`` and ``cuda -> torch``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on a CPU tensor the kernel wrappers take their plain
PyTorch versions. ``count_dtype=None`` counts in int32, as the
reference does by default; ``count_dtype=torch.int64`` is always
honoured.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..testing import faults as _faults
from . import pipeline as _pipeline
from . import resilience as _res
from .aggregate import table_bits_for
from .device import resolve_device
from .graph import BipartiteGraph, RankedGraph, preprocess
from .ranking import make_order
from .wedges import (
    auto_chunk_budget,
    device_graph,
    gather_wedges,
    host_wedge_counts,
    shrink_budget,
    slot_wedge_counts,
)

__all__ = [
    "CountResult",
    "count_butterflies",
    "count_from_ranked",
    "count_validator",
    "interpret_counts",
    "default_count_dtype",
    "ENGINES",
    "ENGINE_MAP",
    "COUNT_LADDERS",
    "AGGREGATIONS",
    "MODES",
]

ENGINES = ("torch", "cuda", "fused", "fused_cuda")
MODES = _pipeline.MODES
AGGREGATIONS = ("sort", "hash", "histogram", "auto")

# reference engine name -> port engine name
ENGINE_MAP = {
    "xla": "torch",
    "pallas": "cuda",
    "fused": "fused",
    "fused_pallas": "fused_cuda",
}

# Degradation ladder per requested engine (ResiliencePolicy descends
# left to right; every rung is bitwise-identical where it applies, so
# descent changes strategy, never results).
COUNT_LADDERS = {
    "fused_cuda": ("fused_cuda", "fused", "torch"),
    "fused": ("fused", "torch"),
    "cuda": ("cuda", "torch"),
    "torch": ("torch",),
}


def default_count_dtype() -> torch.dtype:
    """Widest count dtype the engines honour: always int64."""
    return torch.int64


class CountResult(NamedTuple):
    """``mode="all"`` populates total, per_u, per_v, and per_edge from a
    single-pass run; single modes populate only their own field. All
    fields are host numpy arrays."""

    mode: str
    total: Optional[np.ndarray]  # scalar (global / all modes)
    per_u: Optional[np.ndarray]  # (n_u,)
    per_v: Optional[np.ndarray]  # (n_v,)
    per_edge: Optional[np.ndarray]  # (m,) aligned with g.edges rows
    aggregation: str
    order: str
    report: Optional["_res.ExecutionReport"] = None  # resilience audit


def _resolve_chunk_budget(max_chunk, device) -> Optional[int]:
    """``max_chunk`` knob: None (no streaming for the materializing
    engines; auto for the fused engines), "auto" (device-memory-derived
    budget, see ``wedges.auto_chunk_budget``), or an explicit int."""
    if max_chunk is None:
        return None
    if max_chunk == "auto":
        return auto_chunk_budget(device)
    return int(max_chunk)


def _plan_from_knobs(
    rg: RankedGraph,
    *,
    aggregation: str,
    mode: str,
    direction: str,
    dtype,
    engine: str,
    max_chunk,
    hash_bits: Optional[int],
    device,
    wv_slots: Optional[np.ndarray] = None,
) -> Optional["_pipeline.WedgePlan"]:
    """Resolve the knob surface into a counting plan: the one place the
    budget rules live. Returns None for the materializing torch/cuda
    path under budget. Unlike the reference's ``fused_pallas``, the
    ``fused_cuda`` budget is not clamped to a small kernel tile: the
    kernel's hash table is sized from the plan (``MAX_TILE_CAP``)."""
    budget = _resolve_chunk_budget(max_chunk, device)
    if wv_slots is None:
        wv_slots = host_wedge_counts(rg, direction)
    if engine in ("fused", "fused_cuda"):
        if budget is None:
            budget = auto_chunk_budget(device)
    elif budget is None or int(wv_slots.sum()) <= budget:
        return None
    return _pipeline.plan_count(
        rg,
        mode=mode,
        direction=direction,
        aggregation=aggregation,
        budget=budget,
        dtype=dtype,
        hash_bits=hash_bits,
        engine=engine,
        wv_slots=wv_slots,
    )


def count_from_ranked(
    rg: RankedGraph,
    *,
    aggregation: str = "sort",
    mode: str = "global",
    cache_opt: bool = False,
    count_dtype=None,
    engine: str = "torch",
    max_chunk=None,
    hash_bits: Optional[int] = None,
    device=None,
):
    """Count butterflies on a preprocessed graph. Returns rank-space
    tensors on ``device`` (a scalar for global mode; a (total,
    per-vertex, per-edge) triple for ``mode="all"``).

    ``max_chunk`` bounds the tile/stream budget: an int, ``"auto"``
    (derived from device memory), or None (materialize for torch/cuda;
    auto for the fused engines). ``hash_bits`` overrides the hash-table
    size. ``device=None`` means CUDA."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be {'|'.join(ENGINES)}, got {engine}")
    if mode not in MODES:
        raise ValueError(f"mode must be {'|'.join(MODES)}, got {mode}")
    if aggregation not in AGGREGATIONS:
        raise ValueError(
            f"aggregation must be {'|'.join(AGGREGATIONS)}, got "
            f"{aggregation}"
        )
    device = resolve_device(device)
    _faults.maybe_oom(f"count.{engine}")
    _faults.maybe_slow_rung(f"count.{engine}")
    hash_bits = _faults.hash_bits_override(f"count.{engine}", hash_bits)
    dtype = torch.int32 if count_dtype is None else count_dtype
    direction = "high" if cache_opt else "low"
    if aggregation == "auto" and engine not in ("fused", "fused_cuda"):
        # per-tile strategy choice needs a tile plan; the materializing
        # rungs resolve to sort (both strategies are exact)
        aggregation = "sort"
    dg = device_graph(rg, device)
    wv_slots = host_wedge_counts(rg, direction)
    plan = _plan_from_knobs(
        rg,
        aggregation=aggregation,
        mode=mode,
        direction=direction,
        dtype=dtype,
        engine=engine,
        max_chunk=max_chunk,
        hash_bits=hash_bits,
        device=device,
        wv_slots=wv_slots,
    )
    if plan is not None:
        return _pipeline.execute_count_plan(dg, plan, rg.offsets, wv_slots)
    # materializing torch/cuda path: the whole wedge array in one batch
    w_total = int(wv_slots.sum())
    w_cap = max(128, ((w_total + 127) // 128) * 128)
    cnt = slot_wedge_counts(dg, direction)
    w = gather_wedges(dg, cnt, w_cap, direction)
    bits = table_bits_for(w_cap) if hash_bits is None else hash_bits
    out, _ok = _pipeline.aggregate_and_accumulate(
        dg, w, aggregation, mode, dtype, engine, bits
    )
    return out


def count_validator(g: BipartiteGraph, mode: str):
    """Result-invariant check for the counting ladder: Σ C(d, 2) over
    endpoint-pair groups with Σ d = W is maximized by one group holding
    all W wedges (convexity), so every count (total, per-vertex,
    per-edge) is bounded by ``ub = C(min(w_u, w_v), 2)`` and
    non-negative. A violating rung result demotes to the next rung
    instead of being returned. When ``ub`` does not fit the result
    dtype the engines' documented wraparound regime is in effect and
    the check stands down."""
    w_u, w_v = g.wedge_totals()
    w = min(w_u, w_v)
    ub = w * (w - 1) // 2

    def _bad(name, arr):
        arr = np.asarray(arr)
        if arr.size == 0:
            return None
        if ub > int(np.iinfo(arr.dtype).max):
            return None
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0:
            return f"negative {name} count {lo}"
        if hi > ub:
            return f"{name} count {hi} exceeds the C(W, 2) bound {ub}"
        return None

    def check(host_out):
        if mode == "all":
            total, bv, be = host_out
            for name, arr in (("total", total), ("per-vertex", bv),
                              ("per-edge", be)):
                problem = _bad(name, arr)
                if problem is not None:
                    return problem
            return None
        name = {"global": "total", "vertex": "per-vertex",
                "edge": "per-edge"}[mode]
        return _bad(name, host_out)

    return check


def interpret_counts(
    rg: RankedGraph,
    g: BipartiteGraph,
    mode: str,
    out,
    aggregation: str,
    order: str,
) -> CountResult:
    """Interpret a rank-space engine output (the host-side value a
    counting rung returns) into a :class:`CountResult` in the caller's
    vertex numbering."""

    def _scatter_vertex(bv: np.ndarray):
        per_u = np.zeros(g.n_u, bv.dtype)
        per_v = np.zeros(g.n_v, bv.dtype)
        per_u[:] = bv[rg.rank_of_u]
        per_v[:] = bv[rg.rank_of_v]
        return per_u, per_v

    if mode == "all":
        total, bv, be = out
        per_u, per_v = _scatter_vertex(np.asarray(bv))
        return CountResult(
            mode, np.asarray(total), per_u, per_v, np.asarray(be),
            aggregation, order,
        )
    if mode == "global":
        return CountResult(
            mode, np.asarray(out), None, None, None, aggregation, order
        )
    if mode == "vertex":
        per_u, per_v = _scatter_vertex(np.asarray(out))
        return CountResult(
            mode, None, per_u, per_v, None, aggregation, order
        )
    return CountResult(
        mode, None, None, None, np.asarray(out), aggregation, order
    )


def _to_host(out):
    if isinstance(out, tuple):
        return tuple(t.cpu().numpy() for t in out)
    return out.cpu().numpy()


def count_butterflies(
    g: BipartiteGraph,
    *,
    order: str = "degree",
    aggregation: str = "sort",
    mode: str = "global",
    cache_opt: bool = False,
    count_dtype=None,
    engine: str = "torch",
    max_chunk=None,
    resilience=None,
    device=None,
) -> CountResult:
    """Public entry point: rank -> plan -> execute -> report.

    Execution runs under the degradation ladder (``COUNT_LADDERS``) via
    :func:`~repro_torch.core.pipeline.execute_ladder`: the requested
    engine is tried first and a capacity overflow (the fused kernel's
    scratch bound), a RESOURCE_EXHAUSTED (retried with a halved
    ``max_chunk`` budget first), or a result-invariant violation
    descends to the next bitwise-identical rung. ``resilience`` accepts
    None/True (default policy), False (no validation, retries or
    report; rung descent still applies), or a
    :class:`~repro_torch.core.resilience.ResiliencePolicy`. The
    worst-case accumulator preflight
    (:meth:`BipartiteGraph.accumulator_preflight`) raises
    :class:`~repro_torch.core.resilience.AccumulatorOverflowRisk` up
    front when even int64 accumulation could silently wrap.
    ``device=None`` means CUDA; pass ``device="cpu"`` for the host.
    """
    device = resolve_device(device)
    policy = _res.resolve_policy(resilience)
    ordering = make_order(g, order, device=device)
    rg = preprocess(g, ordering, order_name=order)
    if policy.validate_results:
        g.accumulator_preflight()
    ladder = COUNT_LADDERS.get(engine, (engine,))

    def _make_rung(eng):
        def run(shrinks):
            mc = max_chunk
            if shrinks:
                base = _resolve_chunk_budget(mc, device)
                if base is None:
                    base = auto_chunk_budget(device)
                mc = shrink_budget(base, shrinks)
            out = count_from_ranked(
                rg,
                aggregation=aggregation,
                mode=mode,
                cache_opt=cache_opt,
                count_dtype=count_dtype,
                engine=eng,
                max_chunk=mc,
                device=device,
            )
            return _to_host(out)

        return _res.Rung(eng, run)

    # report-only planning pass for the requested engine: what the first
    # rung will execute, recorded before any rung runs
    try:
        plan = _plan_from_knobs(
            rg,
            aggregation=aggregation,
            mode=mode,
            direction="high" if cache_opt else "low",
            dtype=torch.int32 if count_dtype is None else count_dtype,
            engine=engine,
            max_chunk=max_chunk,
            hash_bits=None,
            device=device,
        )
    except _res.ResilienceError:
        plan = None

    out, report = _pipeline.execute_ladder(
        "count",
        policy,
        [_make_rung(e) for e in ladder],
        count_validator(g, mode),
        plan=plan,
    )
    res = interpret_counts(rg, g, mode, out, aggregation, order)
    return policy.attach(res, report)
