"""The plan -> execute -> report wedge pipeline, counting half.

  **plan**: a :class:`WedgePlan` is a plain, serializable description of
  a wedge workload: vertex-aligned tile boundaries from
  ``wedges.plan_wedge_chunks``, a per-tile aggregation strategy (the
  sort-vs-hash decision, made at plan time from tile density), capacity
  segments, an expansion id from :data:`EXPANSIONS`, and an
  :class:`AccumulatorSpec`. Planning is pure host numpy, identical to
  the reference package's, so a plan's ``to_dict()`` equals the
  reference plan's with the engine name mapped, and
  ``WedgePlan.from_dict`` accepts the reference's dict.

  **execute**: :func:`run_count_tiles` streams the vertex-aligned tiles
  through PyTorch ops (generate, aggregate, accumulate, discard);
  :func:`run_fused_cuda_tiles` hands the whole plan to the fused CUDA
  kernel. Kernels are reached ONLY through ``kernels/ops.py``.

  **report**: :func:`execute_ladder` runs a degradation ladder under one
  :class:`~repro_torch.core.resilience.ResiliencePolicy` and records the
  plan summary on the resulting report.

Tile-alignment invariant (everything rests on it): flat wedge ids
follow CSR slot order, so every endpoint-pair group lives inside one
iterating endpoint's contiguous range; cutting tiles only at vertex
boundaries means no group ever spans a tile, per-tile C(d, 2)
contributions add exactly, and, because integer adds commute, ANY
vertex-aligned tiling produces bitwise-identical counts.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..kernels import ops as _kops
from ..testing import faults as _faults
from . import resilience as _res
from .aggregate import (
    Groups,
    aggregate_dense,
    aggregate_hash,
    aggregate_sort,
    table_bits_for,
)
from .graph import RankedGraph
from .wedges import (
    DeviceGraph,
    Wedges,
    host_wedge_counts,
    plan_wedge_chunks,
    slot_wedge_counts,
    wedge_offsets,
    wedges_at,
)

__all__ = [
    # plan
    "AccumulatorSpec",
    "WedgePlan",
    "EXPANSIONS",
    "DENSITY_HASH_THRESHOLD",
    "dtype_name",
    "plan_count",
    "plan_partition",
    # execute: counting
    "choose2",
    "group_choose2",
    "wedge_dm1",
    "accumulate_counts",
    "tile_apply",
    "aggregate_and_accumulate",
    "zero_counts",
    "count_tile_step",
    "run_count_tiles",
    "fused_tile_inputs",
    "run_fused_cuda_tiles",
    "execute_count_plan",
    # report
    "execute_ladder",
]

MODES = ("global", "vertex", "edge", "all")

# Plan-time density threshold for ``aggregation="auto"`` (the
# reference's value): a tile whose estimated wedges-per-endpoint-pair
# reaches this takes the hash strategy; below it, sort.
DENSITY_HASH_THRESHOLD = 4.0

# Expansion-callable registry: a WedgePlan names its wedge recovery by
# id instead of carrying a callable (plans must serialize).
EXPANSIONS = {
    "count_wedges": "flat wedge ids -> (x1, x2, y) via wedges_at",
}


def dtype_name(dtype) -> str:
    """Name of a count dtype given as a string, numpy dtype or
    ``torch.dtype`` (``torch.int64`` -> ``"int64"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


# ---------------------------------------------------------------------------
# Plan layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AccumulatorSpec:
    """What a plan's executor accumulates into: the count mode, the
    result dtype (by name: specs serialize), and the output extents
    (``n_pad`` for vertex counts, ``m`` for edge counts)."""

    mode: str  # global | vertex | edge | all
    dtype: str  # dtype name, e.g. "int32"
    n_pad: int = 0
    m: int = 0
    n_out: int = 0

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class WedgePlan:
    """A serializable description of one counting workload.

    ``bounds`` are the vertex-aligned tile boundaries in rank space,
    ``tile_wedges[i]`` the exact wedge total of tile ``i``,
    ``tile_aggregation[i]`` its resolved strategy, ``chunk_cap`` the
    largest tile's wedge count rounded up to 128, and ``w_start`` the
    flat wedge id of ``bounds[0]`` (nonzero only for partition
    sub-plans). ``capacity`` is a tuple of ``(name, value)`` segments:
    every statically planned buffer size.
    """

    kind: str  # count
    expansion: str  # EXPANSIONS id
    direction: str  # low | high
    engine: str  # torch | cuda | fused | fused_cuda
    aggregation: str  # requested: sort | hash | histogram | auto
    tile_aggregation: tuple  # per-tile resolved strategy
    bounds: tuple  # (n_tiles + 1,) vertex boundaries
    tile_wedges: tuple  # (n_tiles,) wedges per tile
    chunk_cap: int  # largest tile, rounded up
    w_start: int  # flat wedge id of bounds[0] (partition sub-plans)
    capacity: tuple  # ((name, value), ...) planned buffer segments
    budget: int  # requested wedge budget the planner honored
    hash_bits: Optional[int]
    accumulator: AccumulatorSpec

    def __post_init__(self):
        if self.expansion not in EXPANSIONS:
            raise ValueError(
                f"unknown expansion id {self.expansion!r}; known: "
                f"{sorted(EXPANSIONS)}"
            )
        if len(self.tile_wedges) != max(len(self.bounds) - 1, 0):
            raise ValueError(
                "tile_wedges must have one entry per bounds interval"
            )
        if self.tile_aggregation and (
            len(self.tile_aggregation) != len(self.tile_wedges)
        ):
            raise ValueError(
                "tile_aggregation must be empty or one entry per tile"
            )

    @property
    def n_tiles(self) -> int:
        return len(self.tile_wedges)

    @property
    def total_wedges(self) -> int:
        return int(sum(self.tile_wedges))

    def tile_flat_bounds(self) -> np.ndarray:
        """Per-tile ``[start, end)`` in flat wedge-id space,
        ``(n_tiles, 2)`` int64."""
        pref = np.concatenate(
            [[0], np.cumsum(np.asarray(self.tile_wedges, np.int64))]
        )
        pref += int(self.w_start)
        return np.stack([pref[:-1], pref[1:]], axis=1)

    def strategy_counts(self) -> dict:
        """{strategy: tile count} over the resolved per-tile choices."""
        out: dict = {}
        for s in self.tile_aggregation:
            out[s] = out.get(s, 0) + 1
        return out

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # asdict leaves tuples as tuples; normalize to lists so the
        # dict is exactly what json round-trips through
        return json.loads(json.dumps(d))

    @classmethod
    def from_dict(cls, d: dict) -> "WedgePlan":
        """Inverse of :meth:`to_dict`; also takes the reference
        package's plan dict (same fields)."""
        d = dict(d)
        acc = d.pop("accumulator")
        return cls(
            accumulator=AccumulatorSpec(**acc),
            tile_aggregation=tuple(d.pop("tile_aggregation")),
            bounds=tuple(d.pop("bounds")),
            tile_wedges=tuple(d.pop("tile_wedges")),
            capacity=tuple(
                (str(k), int(v)) for k, v in d.pop("capacity")
            ),
            **d,
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "WedgePlan":
        return cls.from_dict(json.loads(s))

    def summary(self) -> str:
        """One line for the ExecutionReport audit trail."""
        parts = [
            f"{self.kind}/{self.expansion}",
            f"engine={self.engine}",
            f"mode={self.accumulator.mode}",
            f"agg={self.aggregation}",
        ]
        if self.n_tiles:
            sc = self.strategy_counts()
            mix = ",".join(f"{k}:{v}" for k, v in sorted(sc.items()))
            parts.append(
                f"tiles={self.n_tiles}({mix}) cap={self.chunk_cap} "
                f"wedges={self.total_wedges}"
            )
        if self.capacity:
            parts.append(
                "caps=" + ",".join(f"{k}={v}" for k, v in self.capacity)
            )
        return " ".join(parts)


def _tile_pair_floor(rg: RankedGraph, wv_slots: np.ndarray) -> np.ndarray:
    """Per-vertex lower bound on distinct (x1, x2) endpoint pairs: the
    wedges of one directed slot (x1 -> y) all have distinct x2, so
    vertex x1 contributes at least ``max_e cnt[e]`` distinct pairs."""
    n_real = 2 * rg.m
    mx = np.zeros(rg.n_pad, dtype=np.int64)
    if n_real:
        np.maximum.at(
            mx, rg.edge_src[:n_real].astype(np.int64), wv_slots[:n_real]
        )
    return mx


def plan_count(
    rg: RankedGraph,
    *,
    mode: str = "global",
    direction: str = "low",
    aggregation: str = "sort",
    budget: int,
    dtype="int32",
    hash_bits: Optional[int] = None,
    engine: str = "fused",
    density_threshold: float = DENSITY_HASH_THRESHOLD,
    wv_slots: Optional[np.ndarray] = None,
) -> WedgePlan:
    """Plan a tiled counting workload: vertex-aligned tile boundaries
    (``wedges.plan_wedge_chunks`` under ``budget``), exact per-tile
    wedge totals, and the per-tile aggregation strategy.

    ``aggregation="auto"`` resolves sort-vs-hash per tile from the
    density estimate (wedges over a lower bound on distinct endpoint
    pairs); any other value is applied uniformly. Deterministic pure
    numpy on (graph, knobs).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be {'|'.join(MODES)}, got {mode}")
    if aggregation not in ("sort", "hash", "histogram", "auto"):
        raise ValueError(
            "plan_count aggregation must be sort|hash|histogram|auto, "
            f"got {aggregation}"
        )
    if wv_slots is None:
        wv_slots = host_wedge_counts(rg, direction)
    bounds, chunk_cap = plan_wedge_chunks(
        rg, direction, int(budget), wv_slots=wv_slots
    )
    n_real = 2 * rg.m
    wv = np.zeros(rg.n_pad, dtype=np.int64)
    if n_real:
        np.add.at(
            wv, rg.edge_src[:n_real].astype(np.int64), wv_slots[:n_real]
        )
    voff = np.concatenate([[0], np.cumsum(wv)])
    tile_wedges = (voff[bounds[1:]] - voff[bounds[:-1]]).astype(np.int64)
    if aggregation == "auto":
        mx = _tile_pair_floor(rg, wv_slots)
        moff = np.concatenate([[0], np.cumsum(mx)])
        pair_floor = np.maximum(moff[bounds[1:]] - moff[bounds[:-1]], 1)
        density = tile_wedges / pair_floor
        tile_aggregation = tuple(
            "hash" if d >= density_threshold else "sort" for d in density
        )
    else:
        tile_aggregation = (aggregation,) * int(tile_wedges.shape[0])
    return WedgePlan(
        kind="count",
        expansion="count_wedges",
        direction=direction,
        engine=engine,
        aggregation=aggregation,
        tile_aggregation=tile_aggregation,
        bounds=tuple(int(b) for b in bounds),
        tile_wedges=tuple(int(w) for w in tile_wedges),
        chunk_cap=int(chunk_cap),
        w_start=0,
        capacity=(("chunk_cap", int(chunk_cap)),),
        budget=int(budget),
        hash_bits=hash_bits,
        accumulator=AccumulatorSpec(
            mode=mode, dtype=dtype_name(dtype), n_pad=rg.n_pad, m=rg.m,
        ),
    )


def plan_partition(plan: WedgePlan, n: int) -> list:
    """Split a tiled plan across ``n`` devices: contiguous tile runs,
    boundaries placed greedily so each device's wedge load approaches
    the ideal share. Tiles are never split (they are vertex-aligned), so
    the per-device partial counts add exactly. Returns ``n`` sub-plans
    whose ``tile_flat_bounds()`` concatenate to the parent's; devices
    beyond the tile count get empty plans."""
    n = max(int(n), 1)
    if plan.n_tiles == 0:
        return [dataclasses.replace(plan) for _ in range(n)]
    tw = np.asarray(plan.tile_wedges, np.int64)
    pref = np.concatenate([[0], np.cumsum(tw)])
    total = int(pref[-1])
    ideal = total / n
    cuts = [0]
    for d in range(1, n):
        c = int(np.searchsorted(pref, d * ideal, side="left"))
        cuts.append(min(max(c, cuts[-1]), plan.n_tiles))
    cuts.append(plan.n_tiles)
    parts = []
    for d in range(n):
        t0, t1 = cuts[d], cuts[d + 1]
        if t1 > t0:
            bounds = plan.bounds[t0 : t1 + 1]
        else:
            bounds = (plan.bounds[min(t0, len(plan.bounds) - 1)],)
        parts.append(dataclasses.replace(
            plan,
            bounds=bounds,
            tile_wedges=plan.tile_wedges[t0:t1],
            tile_aggregation=(
                plan.tile_aggregation[t0:t1]
                if plan.tile_aggregation else ()
            ),
            w_start=int(plan.w_start + pref[t0]),
        ))
    return parts


# ---------------------------------------------------------------------------
# Execute layer: counting primitives (Lemma 4.2 accumulation)
# ---------------------------------------------------------------------------


def choose2(d: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    dd = d.to(dtype)
    return dd * (dd - 1) // 2


def group_choose2(groups: Groups, dtype: torch.dtype,
                  engine: str) -> torch.Tensor:
    """Per-group C(d, 2) endpoint contributions, in ``dtype``. Under
    "cuda" the combine kernel computes C(d, 2) exactly in int64; a
    32-bit ``dtype`` keeps the low word, like every engine."""
    if engine == "cuda":
        _, c2 = _kops.butterfly_combine(
            groups.d, torch.ones_like(groups.valid), groups.valid
        )
        return c2.to(dtype)
    return torch.where(groups.valid, choose2(groups.d, dtype), 0)


def wedge_dm1(w: Wedges, groups: Groups, dtype: torch.dtype,
              engine: str) -> torch.Tensor:
    """Per-wedge d - 1 center/edge contributions, in ``dtype``."""
    d = groups.d_per_wedge
    if engine == "cuda":
        dm1, _ = _kops.butterfly_combine(d, torch.zeros_like(w.valid), w.valid)
        return dm1.to(dtype)
    return torch.where(w.valid & (d > 0), (d - 1).to(dtype), 0)


def accumulate_counts(
    dg: DeviceGraph,
    w: Wedges,
    groups: Groups,
    mode: str,
    dtype: torch.dtype,
    engine: str = "torch",
):
    """Turn group multiplicities into butterfly counts (Lemma 4.2).

    ``mode="all"`` returns the (total, per-vertex, per-edge) triple from
    the same shared (dm1, C(d, 2)) intermediates. Empty group-table
    entries and padding lanes are masked out before the adds, so no add
    lands on a sentinel."""
    if mode not in MODES:
        raise ValueError(f"mode must be {'|'.join(MODES)}, got {mode}")
    want_v = mode in ("vertex", "all")
    want_e = mode in ("edge", "all")
    want_g = mode in ("global", "all")
    out = {}
    if want_v or want_g:
        g_add = group_choose2(groups, dtype, engine)
        gsel = torch.nonzero(groups.valid).squeeze(1)
        g_add = g_add[gsel]
        if want_g:
            out["global"] = g_add.sum().to(dtype)
    if want_v or want_e:
        dm1 = wedge_dm1(w, groups, dtype, engine)
        wsel = torch.nonzero(w.valid).squeeze(1)
        dm1 = dm1[wsel]
    if want_v:
        bv = torch.zeros(dg.n_pad, dtype=dtype, device=dg.device)
        bv.index_add_(0, groups.x1[gsel], g_add)
        bv.index_add_(0, groups.x2[gsel], g_add)
        bv.index_add_(0, w.y[wsel], dm1)
        out["vertex"] = bv
    if want_e:
        be = torch.zeros(dg.m, dtype=dtype, device=dg.device)
        uid = dg.undirected_id
        be.index_add_(0, uid[w.center_slot[wsel]].long(), dm1)
        be.index_add_(0, uid[w.second_slot[wsel]].long(), dm1)
        out["edge"] = be
    if mode == "all":
        return out["global"], out["vertex"], out["edge"]
    return out[mode]


def tile_apply(
    w: Wedges,
    aggregation: str,
    consume,
    engine: str = "torch",
    hash_bits: Optional[int] = None,
    dense_n: Optional[int] = None,
):
    """Aggregate ONE wedge batch and hand it to ``consume(wedges,
    groups)``. For ``aggregation="hash"`` the overflow fallback
    re-aggregates the *same* batch with the sort strategy when the
    bounded-probe table failed. ``dense_n`` sizes the ``histogram``
    strategy's key space. Returns ``(consume(...), ok)``."""
    if aggregation == "sort":
        groups, ws = aggregate_sort(w)
        return consume(ws, groups), True
    if aggregation == "histogram":
        groups = aggregate_dense(w, dense_n, engine=engine)
        return consume(w, groups), True
    if aggregation == "hash":
        groups = aggregate_hash(w, table_bits=hash_bits, engine=engine)
        if groups.ok:
            return consume(w, groups), True
        g2, ws = aggregate_sort(w)
        return consume(ws, g2), False
    raise ValueError(f"bad aggregation {aggregation}")


def aggregate_and_accumulate(
    dg: DeviceGraph,
    w: Wedges,
    aggregation: str,
    mode: str,
    dtype: torch.dtype,
    engine: str,
    hash_bits: Optional[int] = None,
):
    """Aggregate one batch of the wedge stream and accumulate counts."""
    return tile_apply(
        w,
        aggregation,
        lambda wv, gv: accumulate_counts(dg, wv, gv, mode, dtype, engine),
        engine,
        hash_bits,
        dense_n=dg.n_pad,
    )


def zero_counts(dg: DeviceGraph, mode: str, dtype: torch.dtype):
    def z(shape):
        return torch.zeros(shape, dtype=dtype, device=dg.device)

    by_mode = {"global": (), "vertex": (dg.n_pad,), "edge": (dg.m,)}
    if mode == "all":
        return tuple(z(by_mode[k]) for k in ("global", "vertex", "edge"))
    return z(by_mode[mode])


def count_tile_step(
    dg: DeviceGraph,
    cnt: torch.Tensor,
    w_off: torch.Tensor,
    ws: int,
    we: int,
    *,
    chunk_cap: int,
    aggregation: str,
    mode: str,
    direction: str,
    dtype: torch.dtype,
    engine: str = "torch",
    hash_bits: Optional[int] = None,
):
    """Generate -> aggregate -> accumulate ONE vertex-aligned wedge
    tile ``[ws, we)`` and discard it. The tile's lanes are exactly its
    wedges; the hash table is sized for ``chunk_cap`` lanes, as the
    reference sizes it, unless ``hash_bits`` overrides. Returns
    ``(counts, ok)``; the tile must not be empty."""
    wid = torch.arange(ws, we, dtype=torch.int64, device=dg.device)
    valid = torch.ones_like(wid, dtype=torch.bool)
    w = wedges_at(dg, cnt, w_off, wid, valid, direction)
    bits = table_bits_for(chunk_cap) if hash_bits is None else hash_bits
    return aggregate_and_accumulate(
        dg, w, aggregation, mode, dtype, engine, bits
    )


def run_count_tiles(
    dg: DeviceGraph,
    plan: WedgePlan,
    *,
    engine: str = "torch",
):
    """THE counting tile loop: every vertex-aligned tile of the plan is
    re-materialized via ``wedges_at``, aggregated with its planned
    strategy, accumulated, and discarded. Peak wedge memory is
    O(chunk_cap) instead of O(W); per-tile counts add exactly because
    groups never span an iterating-vertex boundary."""
    acc = plan.accumulator
    dtype = acc.torch_dtype()
    cnt = slot_wedge_counts(dg, plan.direction)
    w_off = wedge_offsets(cnt)
    starts = w_off[dg.offsets.long()].cpu().numpy()
    out = zero_counts(dg, acc.mode, dtype)
    for i in range(plan.n_tiles):
        ws, we = int(starts[plan.bounds[i]]), int(starts[plan.bounds[i + 1]])
        if we <= ws:
            continue  # a tile of wedge-less vertices adds nothing
        strategy = plan.tile_aggregation[i] if plan.tile_aggregation else "sort"
        part, _ok = count_tile_step(
            dg, cnt, w_off, ws, we,
            chunk_cap=plan.chunk_cap, aggregation=strategy,
            mode=acc.mode, direction=plan.direction, dtype=dtype,
            engine=engine, hash_bits=plan.hash_bits,
        )
        if acc.mode == "all":
            out = tuple(a + p for a, p in zip(out, part))
        else:
            out = out + part
    return out


def fused_tile_inputs(plan: WedgePlan, rg_offsets: np.ndarray,
                      wv_slots: np.ndarray, device):
    """The fused kernel's plan-derived inputs: the tiles' flat wedge
    ranges ``[ws, we)`` as an (n_tiles, 2) int64 host array, and the
    int64 wedge prefix ``w_off`` (e_pad + 1,) on ``device``."""
    bounds = np.asarray(plan.bounds, np.int64)
    w_off = np.concatenate([[0], np.cumsum(wv_slots)]).astype(np.int64)
    off = rg_offsets.astype(np.int64)
    tb = np.stack([w_off[off[bounds[:-1]]], w_off[off[bounds[1:]]]], axis=1)
    return tb.reshape(-1, 2), torch.as_tensor(w_off, device=device)


def run_fused_cuda_tiles(
    dg: DeviceGraph,
    plan: WedgePlan,
    rg_offsets: np.ndarray,
    wv_slots: np.ndarray,
):
    """Dispatch the fused counting kernel over a plan's tiles:
    host-planned vertex-aligned tile bounds in flat wedge-id space, one
    call of ``kernels/ops.fused_count_tiles``. The kernel accumulates
    exact int64 counts; a 32-bit plan dtype keeps the low word, like
    every engine.

    The kernel's hash-table scratch is sized for ``plan.chunk_cap``
    wedges; a plan whose largest tile exceeds the kernel's
    ``MAX_TILE_CAP`` raises :class:`CapacityOverflow`, so the ladder
    descends to ``fused``."""
    dtype = plan.accumulator.torch_dtype()
    mode = plan.accumulator.mode
    max_tile = _faults.capacity_override(
        "count.fused_cuda", _kops.MAX_TILE_CAP
    )
    if plan.chunk_cap > max_tile:
        raise _res.CapacityOverflow(
            f"engine='fused_cuda' tile_cap {plan.chunk_cap} exceeds the "
            f"kernel's scratch bound {max_tile} (a single vertex owns "
            "more wedges than the kernel's hash table can hold); use "
            "engine='fused'"
        )
    tb, w_off = fused_tile_inputs(plan, rg_offsets, wv_slots, dg.device)
    tot, vert, edge = _kops.fused_count_tiles(
        tb,
        dg.offsets,
        dg.neighbors,
        dg.edge_src,
        dg.undirected_id,
        w_off,
        tile_cap=plan.chunk_cap,
        n_pad=dg.n_pad,
        m=dg.m,
        direction=plan.direction,
        mode=mode,
    )
    total, vert, edge = tot.to(dtype), vert.to(dtype), edge.to(dtype)
    if mode == "global":
        return total
    if mode == "vertex":
        return vert
    if mode == "edge":
        return edge
    return total, vert, edge


def execute_count_plan(
    dg: DeviceGraph,
    plan: WedgePlan,
    rg_offsets: Optional[np.ndarray] = None,
    wv_slots: Optional[np.ndarray] = None,
):
    """Execute a counting plan on its device graph and return the
    rank-space counts (a scalar / array / triple per the accumulator
    mode). ``engine="fused_cuda"`` dispatches the fused kernel
    (``rg_offsets``/``wv_slots`` are its host-side planning inputs);
    everything else streams through :func:`run_count_tiles`, with the
    kernels of the ``cuda`` engine inside each tile."""
    if plan.kind != "count":
        raise ValueError(f"not a counting plan: kind={plan.kind!r}")
    if plan.engine == "fused_cuda":
        if rg_offsets is None or wv_slots is None:
            raise ValueError(
                "engine='fused_cuda' execution needs rg_offsets and "
                "wv_slots (host planning inputs)"
            )
        return run_fused_cuda_tiles(dg, plan, rg_offsets, wv_slots)
    engine = "cuda" if plan.engine == "cuda" else "torch"
    return run_count_tiles(dg, plan, engine=engine)


# ---------------------------------------------------------------------------
# Report layer
# ---------------------------------------------------------------------------


def execute_ladder(
    workload: str,
    policy: "_res.ResiliencePolicy",
    rungs,
    validate=None,
    plan: Optional[WedgePlan] = None,
):
    """The single resilience wrapper of the pipeline: run a degradation
    ladder under ``policy`` and stamp the plan summary onto the
    resulting :class:`~repro_torch.core.resilience.ExecutionReport`
    (``report.plan``). Returns ``(result, report)``."""
    out, report = policy.execute(workload, rungs, validate)
    if plan is not None:
        report.plan = (
            plan.summary() if isinstance(plan, WedgePlan) else str(plan)
        )
    return out, report
