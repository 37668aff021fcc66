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

:func:`count_butterflies` builds the count's CSR on its own device
(``wedges.preprocess_device``, span ``count.csr``): the host
``RankedGraph`` that the planners and ``interpret_counts`` read comes
from one copy of the build's buffer, and the ``DeviceGraph`` is that
buffer, never uploaded. :func:`count_from_ranked` uploads its
``RankedGraph`` instead, and the query service uploads its resident one
once per count miss, on the first rung attempt that counts. Each
prepares the graph once (``wedges.prepare``, span
``count.wedge_counts``): one ``slot_wedge_counts`` pass on the device
graph and one copy to the host. Every count on that
:class:`~repro_torch.core.wedges.PreparedGraph` runs through one
executor, and every ladder through one rung builder, so the report-only
planning pass and every rung attempt (shrink retries, lower rungs, the
batch aggregations) plan and run from the same graph and wedge counts.

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

``aggregation="batch"|"batch_wa"`` are the paper's simple and
wedge-aware batching (§3.1.2), on the ``torch`` engine only, as in the
reference: blocks of at most ``batch_rows`` consecutive iterating
vertices (wedge-aware: also at most ``batch_target`` wedges, a heavier
vertex alone) each group their wedges in a dense ``rows x n_pad``
table, with the scatter-min of lane ids picking each group's
representative. Blocks are cut on the host and issued from a host loop
that reads nothing back; each block holds exactly its own wedges (the
reference pads every block to the largest).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on a CPU tensor the kernel wrappers take their plain
PyTorch versions. ``count_dtype=None`` returns int32 counts, as the
reference does by default, but accumulates in int64 and refuses with
:class:`~repro_torch.core.resilience.AccumulatorOverflowRisk` when a
value leaves the int32 range (the reference wraps);
``count_dtype=torch.int64`` is always honoured.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..testing import faults as _faults
from . import pipeline as _pipeline
from . import resilience as _res
from . import spans as _spans
from .aggregate import table_bits_for
from .device import resolve_device
from .graph import BipartiteGraph, RankedGraph
from .ranking import make_order
from .wedges import (
    PreparedGraph,
    auto_chunk_budget,
    device_graph,
    gather_wedges,
    greedy_vertex_blocks,
    prepare,
    preprocess_device,
    shrink_budget,
    wedge_offsets,
    wedge_prefix,
)

__all__ = [
    "CountResult",
    "count_butterflies",
    "count_from_ranked",
    "count_validator",
    "interpret_counts",
    "default_count_dtype",
    "narrow_counts",
    "ENGINES",
    "ENGINE_MAP",
    "COUNT_LADDERS",
    "AGGREGATIONS",
    "MODES",
]

ENGINES = ("torch", "cuda", "fused", "fused_cuda")
MODES = _pipeline.MODES
AGGREGATIONS = ("sort", "hash", "histogram", "auto", "batch", "batch_wa")
BATCH_AGGREGATIONS = ("batch", "batch_wa")
BATCH_TARGET = 1 << 14  # count_from_ranked's default batch_target

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
#
# The "sample" entry is the approximate tier's zero-cost rung
# (core/approx.py): NOT part of any exact ladder (an estimate is not
# bitwise-identical to an exact count) but appended below the exact
# rungs when a caller opts into accuracy="approx" (serve/service.py),
# so a deadline too tight for any exact engine still gets a seeded
# sampled answer with error bars instead of a stale result or a typed
# failure. Estimates are explicitly marked (ApproxCount and the
# response's approximate flag); degradation still never silently
# changes what an *exact* answer means.
COUNT_LADDERS = {
    "fused_cuda": ("fused_cuda", "fused", "torch"),
    "fused": ("fused", "torch"),
    "cuda": ("cuda", "torch"),
    "torch": ("torch",),
    "sample": ("sample",),
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
    pg: PreparedGraph,
    *,
    aggregation: str,
    mode: str,
    dtype,
    engine: str,
    max_chunk,
    hash_bits: Optional[int],
) -> Optional["_pipeline.WedgePlan"]:
    """Resolve the knob surface into a counting plan on ``pg``: the one
    place the budget rules live. Returns None for the materializing
    torch/cuda path under budget. Unlike the reference's
    ``fused_pallas``, the ``fused_cuda`` budget is not clamped to a
    small kernel tile: the kernel's hash table is sized from the plan
    (``MAX_TILE_CAP``). The batch aggregations cut their own blocks: no
    plan."""
    if aggregation in BATCH_AGGREGATIONS:
        return None
    device = pg.dg.device
    budget = _resolve_chunk_budget(max_chunk, device)
    if engine in ("fused", "fused_cuda"):
        if budget is None:
            budget = auto_chunk_budget(device)
    elif budget is None or int(pg.host.sum()) <= budget:
        return None
    return _pipeline.plan_count(
        pg.rg,
        mode=mode,
        direction=pg.direction,
        aggregation=aggregation,
        budget=budget,
        dtype=dtype,
        hash_bits=hash_bits,
        engine=engine,
        wv_slots=pg.host,
    )


def _batch_bounds(wv: np.ndarray, n: int, wedge_aware: bool, rows: int,
                  target: int) -> tuple:
    """Vertex-block boundaries for batching: simple, ``rows`` vertices
    per block; wedge-aware, greedy blocks of at most ``rows`` vertices
    and about ``target`` wedges (paper §3.1.2). Returns (boundaries
    (n_blocks + 1,), most wedges in one block)."""
    return greedy_vertex_blocks(
        wv, n, rows=rows, target=target if wedge_aware else None
    )


def _count_batch(pg: PreparedGraph, *, wedge_aware: bool, rows: int,
                 target: int, mode: str, dtype: torch.dtype):
    """Batch aggregation (the paper's simple and wedge-aware batching).

    Each block owns the wedges of a contiguous range of iterating
    vertices (wedge ids follow CSR order, so the range is contiguous in
    wedge space, and the host knows it from ``wv_slots``). A dense
    ``(rows, n_pad)`` int32 table, allocated once and cleared where each
    block wrote, plays the per-worker array of the paper: row = the
    iterating endpoint's offset in the block, column = the other
    endpoint. The scatter-min of lane ids over the same keys picks each
    group's representative, which adds the group's C(d, 2) (the
    reference's replacement for the serial "first time I see this
    endpoint" test). No block reads the device back."""
    rg, dg, direction, cnt, host = pg
    first = wedge_prefix(rg.offsets, host)[1]  # each vertex's first wedge
    bounds, _ = _batch_bounds(np.diff(first), rg.n_pad, wedge_aware, rows,
                              target)
    n_pad, m, dev = dg.n_pad, dg.m, dg.device
    off, nbr = dg.offsets.long(), dg.neighbors.long()
    src, uid = dg.edge_src.long(), dg.undirected_id.long()
    w_off = wedge_offsets(cnt)
    table = torch.zeros(rows * n_pad, dtype=torch.int32, device=dev)
    rep_t = torch.full((rows * n_pad,), _pipeline.I32_MAX, dtype=torch.int32,
                       device=dev)
    tot = torch.zeros((), dtype=dtype, device=dev)
    buf = torch.zeros(
        {"global": 0, "vertex": n_pad, "edge": m, "all": n_pad + m}[mode],
        dtype=dtype, device=dev)
    for v0, v1 in zip(bounds[:-1], bounds[1:]):
        ws, we = int(first[v0]), int(first[v1])
        if we == ws:
            continue  # a block of wedge-less vertices adds nothing
        # recover the block's wedges (every lane is one)
        wid = torch.arange(ws, we, device=dev)
        e = torch.searchsorted(w_off, wid, right=True) - 1
        j = wid - w_off[e]
        y = nbr[e]
        if direction == "low":
            pos = off[y + 1] - cnt[e] + j
            x1, x2 = src[e], nbr[pos]
            row, col = x1 - v0, x2
        else:
            pos = off[y] + j
            x1, x2 = nbr[pos], src[e]
            row, col = x2 - v0, x1
        # group in the dense table; the lowest lane is the representative
        tkey = row * n_pad + col
        lid = torch.arange(we - ws, dtype=torch.int32, device=dev)
        table.index_add_(0, tkey, torch.ones_like(lid))
        rep_t.scatter_reduce_(0, tkey, lid, "amin")
        d = table[tkey]
        rep = rep_t[tkey] == lid
        table[tkey] = 0
        rep_t[tkey] = _pipeline.I32_MAX
        g_add = torch.where(rep, _pipeline.choose2(d, dtype), 0)
        dm1 = (d - 1).to(dtype)
        if mode in ("global", "all"):
            tot = (tot + g_add.sum()).to(dtype)
        if mode == "vertex":
            idx = torch.cat([x1, x2, y])
            upd = torch.cat([g_add, g_add, dm1])
        elif mode == "edge":
            idx = torch.cat([uid[e], uid[pos]])
            upd = torch.cat([dm1, dm1])
        elif mode == "all":
            # one combined [vertex | edge] scatter per block
            idx = torch.cat([x1, x2, y, n_pad + uid[e], n_pad + uid[pos]])
            upd = torch.cat([g_add, g_add, dm1, dm1, dm1])
        if mode != "global":
            buf.index_add_(0, idx, upd)
    if mode == "global":
        return tot
    if mode == "all":
        return tot, buf[:n_pad], buf[n_pad:]
    return buf


def count_from_ranked(
    rg: RankedGraph,
    *,
    aggregation: str = "sort",
    mode: str = "global",
    cache_opt: bool = False,
    count_dtype=None,
    batch_rows: int = 8,
    batch_target: int = BATCH_TARGET,
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
    size. ``batch_rows``/``batch_target`` size the blocks of
    ``aggregation="batch"|"batch_wa"``, which run on ``engine="torch"``
    only (ValueError otherwise). ``device=None`` means CUDA. The graph
    is uploaded to ``device`` and prepared there (span
    ``count.wedge_counts``) once the knobs are found valid."""
    _check_knobs(engine, mode, aggregation)
    pg = _prepare_ranked(rg, "high" if cache_opt else "low", device)
    return _count_prepared(
        pg, aggregation=aggregation, mode=mode,
        dtype=torch.int32 if count_dtype is None else count_dtype,
        engine=engine, max_chunk=max_chunk, hash_bits=hash_bits,
        batch_rows=batch_rows, batch_target=batch_target,
    )


def _prepare_ranked(rg: RankedGraph, direction: str,
                    device) -> PreparedGraph:
    """Upload ``rg`` to ``device`` and prepare it: the span
    ``count.wedge_counts`` holds the upload and the pass."""
    with _spans.span("count.wedge_counts"):
        return prepare(rg, device_graph(rg, resolve_device(device)),
                       direction)


def _check_knobs(engine: str, mode: str, aggregation: str) -> None:
    """ValueError for an engine, mode or aggregation the engines do not
    know, and for a batch aggregation off the torch engine."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be {'|'.join(ENGINES)}, got {engine}")
    if mode not in MODES:
        raise ValueError(f"mode must be {'|'.join(MODES)}, got {mode}")
    if aggregation not in AGGREGATIONS:
        raise ValueError(
            f"aggregation must be {'|'.join(AGGREGATIONS)}, got "
            f"{aggregation}"
        )
    if aggregation in BATCH_AGGREGATIONS and engine != "torch":
        raise ValueError(
            "batch aggregations fuse their own accumulation and do "
            "not route through the cuda or fused engines; use "
            "engine='torch'"
        )


def _count_prepared(pg: PreparedGraph, *, aggregation, mode, dtype, engine,
                    max_chunk, hash_bits, batch_rows, batch_target):
    """Count on a prepared graph: the one executor of every count path.
    Returns rank-space tensors on ``pg``'s device in ``dtype``; int32
    counts are accumulated in int64 and narrowed after one host check
    (:func:`narrow_counts`). The fault sites ``count.<engine>`` fire
    here, once per call."""
    _check_knobs(engine, mode, aggregation)
    _faults.maybe_oom(f"count.{engine}")
    _faults.maybe_slow_rung(f"count.{engine}")
    hash_bits = _faults.hash_bits_override(f"count.{engine}", hash_bits)
    acc = torch.int64 if dtype == torch.int32 else dtype
    if aggregation == "auto" and engine not in ("fused", "fused_cuda"):
        # per-tile strategy choice needs a tile plan; the materializing
        # rungs resolve to sort (both strategies are exact)
        aggregation = "sort"
    if aggregation in BATCH_AGGREGATIONS:
        out = _count_batch(
            pg, wedge_aware=aggregation == "batch_wa", rows=int(batch_rows),
            target=int(batch_target), mode=mode, dtype=acc,
        )
    else:
        with _spans.span("count.plan"):
            plan = _plan_from_knobs(
                pg, aggregation=aggregation, mode=mode, dtype=acc,
                engine=engine, max_chunk=max_chunk, hash_bits=hash_bits,
            )
        if plan is not None:
            out = _pipeline.execute_count_plan(pg, plan)
        else:
            # materializing torch/cuda path: the whole wedge array in
            # one batch
            w_total = int(pg.host.sum())
            w_cap = max(128, ((w_total + 127) // 128) * 128)
            w = gather_wedges(pg.dg, pg.cnt, w_cap, pg.direction)
            bits = table_bits_for(w_cap) if hash_bits is None else hash_bits
            out, _ok = _pipeline.aggregate_and_accumulate(
                pg.dg, w, aggregation, mode, acc, engine, bits
            )
    return narrow_counts(out, dtype) if dtype == torch.int32 else out


def narrow_counts(out, dtype: torch.dtype):
    """Narrow int64 counts (a tensor or a tuple of them) to ``dtype``
    when every value fits, in one host sync; otherwise raise
    :class:`~repro_torch.core.resilience.AccumulatorOverflowRisk` naming
    the largest value (the reference wraps silently)."""
    outs = out if isinstance(out, tuple) else (out,)
    ext = [x for t in outs if t.numel() for x in (t.max(), t.min())]
    if ext:
        vals = torch.stack(ext).tolist()
        hi, lo = max(vals), min(vals)
        info = torch.iinfo(dtype)
        if hi > info.max or lo < info.min:
            raise _res.AccumulatorOverflowRisk(
                f"butterfly count {hi if hi > info.max else lo} does not "
                f"fit the requested {dtype} counts (count_dtype=None "
                f"means int32); pass count_dtype=torch.int64"
            )
    narrowed = tuple(t.to(dtype) for t in outs)
    return narrowed if isinstance(out, tuple) else narrowed[0]


def _count_rungs(prepared, engines, *, aggregation, mode, dtype, max_chunk,
                 batch_rows):
    """One ladder rung per engine of ``engines``, each a
    :func:`_count_prepared` call whose counts come back to the host
    (span ``count.rung``). ``prepared()`` gives the
    :class:`~repro_torch.core.wedges.PreparedGraph`: it is called inside
    the first attempt that counts and its graph kept for every later
    retry and rung, so a failure while preparing is that attempt's
    outcome, and a rung that never runs prepares nothing. A
    RESOURCE_EXHAUSTED re-entry halves the budget: ``max_chunk``'s, or
    the device's auto budget where it gives none."""
    held = []

    def make(engine):
        def run(shrinks):
            if not held:
                held.append(prepared())
            pg = held[0]
            mc = max_chunk
            if shrinks:
                base = _resolve_chunk_budget(mc, pg.dg.device)
                if base is None:
                    base = auto_chunk_budget(pg.dg.device)
                mc = shrink_budget(base, shrinks)
            return _to_host(_count_prepared(
                pg, aggregation=aggregation, mode=mode, dtype=dtype,
                engine=engine, max_chunk=mc, hash_bits=None,
                batch_rows=batch_rows, batch_target=BATCH_TARGET,
            ))

        return _res.Rung(engine, _spans.spanned("count.rung", run))

    return [make(e) for e in engines]


def count_validator(g: BipartiteGraph, mode: str):
    """Result-invariant check for the counting ladder: Σ C(d, 2) over
    endpoint-pair groups with Σ d = W is maximized by one group holding
    all W wedges (convexity), so every count (total, per-vertex,
    per-edge) is bounded by ``ub = C(min(w_u, w_v), 2)`` and
    non-negative. A violating rung result demotes to the next rung
    instead of being returned. When ``ub`` does not fit the result
    dtype the check stands down: int32 results were narrowed from int64
    only after every value was found in range."""
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
    """The rung's counts on the host: the blocking device-to-host copy."""
    with _spans.span("count.to_host"):
        if isinstance(out, tuple):
            return tuple(t.cpu().numpy() for t in out)
        return out.cpu().numpy()


@_spans.entry("count")
def count_butterflies(
    g: BipartiteGraph,
    *,
    order: str = "degree",
    aggregation: str = "sort",
    mode: str = "global",
    cache_opt: bool = False,
    count_dtype=None,
    batch_rows: int = 8,
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
    front when even int64 accumulation could silently wrap. The batch
    aggregations (``batch_rows`` vertices per block) run one rung,
    ``torch``. ``device=None`` means CUDA; pass ``device="cpu"`` for the
    host. ``result.report.phases``, ``.counters`` and ``.timeline`` hold
    what the call's spans recorded (``core/spans.py``).
    """
    device = resolve_device(device)
    policy = _res.resolve_policy(resilience)
    with _spans.span("count.rank"):
        ordering = make_order(g, order, device=device)
    with _spans.span("count.csr"):
        rg, dg = preprocess_device(g, ordering, order, device)
    if policy.validate_results:
        with _spans.span("count.preflight"):
            g.accumulator_preflight()
    ladder = COUNT_LADDERS.get(engine, (engine,))
    if aggregation in BATCH_AGGREGATIONS:
        ladder = (engine,)  # batch fuses its own accumulation: one rung
    # the one wedge-count pass, on the CSR build's device graph: the
    # report-only pass and every rung attempt plan and run from it
    with _spans.span("count.wedge_counts"):
        pg = prepare(rg, dg, "high" if cache_opt else "low")
    dtype = torch.int32 if count_dtype is None else count_dtype

    # report-only planning pass for the requested engine: what the first
    # rung will execute, recorded before any rung runs
    with _spans.span("count.plan_report"):
        try:
            plan = _plan_from_knobs(
                pg, aggregation=aggregation, mode=mode, dtype=dtype,
                engine=engine, max_chunk=max_chunk, hash_bits=None,
            )
        except _res.ResilienceError:
            plan = None
    with _spans.span("count.validate"):
        validate = count_validator(g, mode)

    out, report = _pipeline.execute_ladder(
        "count",
        policy,
        _count_rungs(lambda: pg, ladder, aggregation=aggregation,
                     mode=mode, dtype=dtype, max_chunk=max_chunk,
                     batch_rows=batch_rows),
        _spans.spanned("count.validate", validate),
        plan=plan,
    )
    with _spans.span("count.interpret"):
        res = interpret_counts(rg, g, mode, out, aggregation, order)
    return policy.attach(res, report)
