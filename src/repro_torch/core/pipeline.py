"""The plan -> execute -> report wedge pipeline: counting and peeling.

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
  kernel. The peeling round loop (:func:`device_round_loop`,
  :func:`stream_tiles`, :func:`drive_segments`) is driven from the host:
  one host sync per round fetches the scalars that steer it (see
  :func:`device_round_loop`). Kernels are reached ONLY through
  ``kernels/ops.py``.

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
    aligned_tile_end,
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
    "partition_tile_array",
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
    "fused_host_inputs",
    "fused_tile_inputs",
    "run_fused_cuda_tiles",
    "execute_count_plan",
    # plan + execute: peeling
    "I32_MAX",
    "peel_tile_bounds",
    "plan_peel",
    "LoopState",
    "fetch",
    "compact",
    "prefix_offsets",
    "empty_hist",
    "masked_state",
    "apply_decrements",
    "init_loop_state",
    "tile_bounds",
    "stream_tiles",
    "shrink_due",
    "device_round_loop",
    "drive_segments",
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
    "peel_tips_2hop": "peeled vertices -> 2-hop wedge pairs (PEEL-V)",
    "peel_tips_stored": "peeled vertices -> stored-wedge CSR rows "
                        "(WPEEL-V)",
    "peel_wings_triples": "peeled edges -> butterfly edge triples via "
                          "the degree-sorted CSR (PEEL-E)",
}

I32_MAX = int(np.iinfo(np.int32).max)


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


def peel_tile_bounds(entity_work, n_tiles: int = 64) -> tuple:
    """Entity-aligned coarse tiles over a peeling decomposition's static
    per-entity expansion totals (per-vertex 2-hop totals for tips,
    per-edge triple totals for wings): ``n_tiles`` equal-work quantiles
    of the work prefix sum, deduplicated (a single heavy entity gets a
    solo tile). These are the partition granularity of a peeling plan,
    not per-round buffers. Returns ``(bounds, tile_wedges)`` tuples
    ready for :class:`WedgePlan`."""
    work = np.asarray(entity_work, dtype=np.int64)
    n = int(work.shape[0])
    if n == 0:
        return (), ()
    coff = np.concatenate([[0], np.cumsum(work)])
    total = int(coff[-1])
    k = max(1, min(int(n_tiles), n))
    if total == 0:
        # no expansion work anywhere: uniform entity-count tiles
        cuts = np.unique(np.linspace(0, n, k + 1).astype(np.int64))
    else:
        targets = (np.arange(1, k) * total) / k
        cuts = np.searchsorted(coff, targets, side="left")
        cuts = np.unique(np.concatenate([[0], cuts, [n]]))
    bounds = tuple(int(b) for b in cuts)
    tile_wedges = tuple(
        int(coff[bounds[i + 1]] - coff[bounds[i]])
        for i in range(len(bounds) - 1)
    )
    return bounds, tile_wedges


def plan_peel(
    kind: str,
    *,
    expansion: str,
    engine: str,
    aggregation: str,
    n_out: int,
    dtype="int32",
    capacity=(),
    budget: int = I32_MAX,
    hash_bits: Optional[int] = None,
    entity_work=None,
    coarse_tiles: int = 64,
) -> WedgePlan:
    """Plan of a peeling decomposition: the expansion id, accumulator
    spec, planned capacity segments and, given the static per-entity
    expansion totals as ``entity_work``, the coarse entity-aligned tiles
    (:func:`peel_tile_bounds`). Per-round tiles depend on the frontier
    and are cut by the round loop. Field for field the reference's
    plan."""
    if entity_work is not None:
        bounds, tile_wedges = peel_tile_bounds(entity_work, coarse_tiles)
    else:
        bounds, tile_wedges = (), ()
    return WedgePlan(
        kind=kind,
        expansion=expansion,
        direction="low",
        engine=engine,
        aggregation=aggregation,
        tile_aggregation=(),
        bounds=bounds,
        tile_wedges=tile_wedges,
        chunk_cap=0,
        w_start=0,
        capacity=tuple((str(k), int(v)) for k, v in capacity),
        budget=int(budget),
        hash_bits=hash_bits,
        accumulator=AccumulatorSpec(
            mode="numbers", dtype=dtype_name(dtype), n_out=int(n_out),
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


def partition_tile_array(parts) -> tuple:
    """Pack partitioned sub-plans into the per-worker tile format:
    ``(tiles (n_dev, max_tiles, 2) int64, tile_cap)``, flat wedge-id
    ``[start, end)`` per tile, rows padded with empty ``(0, 0)`` tiles
    (the ``distributed.distributed_count_fn`` contract). The values are
    the reference's; the reference stores them as int32, the port's flat
    ids are int64."""
    per_dev = [p.tile_flat_bounds() for p in parts]
    max_tiles = max(1, max(t.shape[0] for t in per_dev))
    tiles = np.zeros((len(parts), max_tiles, 2), np.int64)
    for d, t in enumerate(per_dev):
        tiles[d, : t.shape[0]] = t
    tile_cap = max(p.chunk_cap for p in parts)
    return tiles, int(tile_cap)


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


def fused_host_inputs(plan: WedgePlan, rg_offsets: np.ndarray,
                      wv_slots: np.ndarray):
    """The fused kernel's plan-derived host inputs: the tiles' flat
    wedge ranges ``[ws, we)`` as an (n_tiles, 2) int64 array, and the
    int64 wedge prefix ``w_off`` (e_pad + 1,)."""
    bounds = np.asarray(plan.bounds, np.int64)
    w_off = np.concatenate([[0], np.cumsum(wv_slots)]).astype(np.int64)
    off = rg_offsets.astype(np.int64)
    tb = np.stack([w_off[off[bounds[:-1]]], w_off[off[bounds[1:]]]], axis=1)
    return tb.reshape(-1, 2), w_off


def fused_tile_inputs(plan: WedgePlan, rg_offsets: np.ndarray,
                      wv_slots: np.ndarray, device):
    """:func:`fused_host_inputs` with ``w_off`` on ``device``."""
    tb, w_off = fused_host_inputs(plan, rg_offsets, wv_slots)
    return tb, torch.as_tensor(w_off, device=device)


def run_fused_cuda_tiles(
    dg: DeviceGraph,
    plan: WedgePlan,
    rg_offsets: np.ndarray,
    wv_slots: np.ndarray,
):
    """Dispatch the fused counting kernel over a plan's tiles:
    host-planned vertex-aligned tile bounds in flat wedge-id space and
    the kernel's host work list (``kernels/ops.fused_work``), one call
    of ``kernels/ops.fused_count_tiles``. The kernel accumulates exact
    int64 counts; a 32-bit plan dtype keeps the low word, like every
    engine.

    A plan whose largest tile exceeds the kernel's ``MAX_TILE_CAP``
    raises :class:`CapacityOverflow`, so the ladder descends to
    ``fused``."""
    dtype = plan.accumulator.torch_dtype()
    mode = plan.accumulator.mode
    max_tile = _faults.capacity_override(
        "count.fused_cuda", _kops.MAX_TILE_CAP
    )
    if plan.chunk_cap > max_tile:
        raise _res.CapacityOverflow(
            f"engine='fused_cuda' tile_cap {plan.chunk_cap} exceeds the "
            f"kernel's bound {max_tile} (a single vertex owns more "
            "wedges than the kernel takes in one tile); use "
            "engine='fused'"
        )
    tb, w_off_h = fused_host_inputs(plan, rg_offsets, wv_slots)
    work = _kops.fused_work(tb, rg_offsets, w_off_h, dg.device)
    tot, vert, edge = _kops.fused_count_tiles(
        tb,
        dg.offsets,
        dg.neighbors,
        dg.edge_src,
        dg.undirected_id,
        torch.as_tensor(w_off_h, device=dg.device),
        tile_cap=plan.chunk_cap,
        n_pad=dg.n_pad,
        m=dg.m,
        direction=plan.direction,
        mode=mode,
        work=work,
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
# Execute layer: the peeling round-loop substrate
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoopState:
    """State of the host-driven peeling round loop (both
    decompositions). Tensors stay on the device; the host keeps the
    round accounting and learns what it needs from one fetch per
    round."""

    b: torch.Tensor  # counts (peeled side / per edge)
    alive: torch.Tensor  # bool mask
    out: torch.Tensor  # tip / wing numbers, counts dtype
    kappa: torch.Tensor  # () int32 peel threshold
    mn: Optional[torch.Tensor]  # () int32 carried min (decrease_key="bucket")
    hist: Optional[torch.Tensor]  # (NUM_BUCKETS,) carried occupancy or (0,)
    n_alive: int
    # remaining level-1 / level-2 work: the totals over the alive
    # entities of the two rows of the round loop's ``work`` (the adaptive
    # capacity schedule's exit test reads them)
    rem: list = dataclasses.field(default_factory=lambda: [0, 0])
    rounds: int = 0  # bucket rounds under range mode
    subr: int = 0  # re-settle iterations (== rounds under exact mode)
    sizes: list = dataclasses.field(default_factory=list)  # peeled per round
    hi: int = 0  # active bucket's exclusive upper bound (range mode)
    overflow: bool = False  # a planned capacity was exceeded
    syncs: int = 0  # blocking device -> host fetches
    segments: int = 0  # capacity segments run (drive_segments)
    lanes: int = 0  # largest round's level-2 frontier, in lanes


def fetch(st: LoopState, values) -> list:
    """The loop's only way to read the device: one blocking copy of a
    list of integer tensors (each () or 1-D), concatenated, counted in
    ``st.syncs``."""
    st.syncs += 1
    return torch.cat([v.reshape(-1).to(torch.int64) for v in values]).tolist()


def compact(mask: torch.Tensor, count: int) -> torch.Tensor:
    """Ascending indices of the ``count`` True entries of ``mask``
    without a host sync (``nonzero`` would block to size its output):
    each True entry scatters its index to its rank; the others land on
    a spare slot that is cut off."""
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask, rank, count)
    out = torch.empty(count + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return out[:count]


def prefix_offsets(lens: torch.Tensor) -> torch.Tensor:
    """Exclusive-prefix flat id space over per-segment lengths, int64
    ``(len + 1,)``."""
    out = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                      device=lens.device)
    torch.cumsum(lens.to(torch.int64), 0, out=out[1:])
    return out


def empty_hist(want_hist: bool, device) -> torch.Tensor:
    """Carried-occupancy placeholder: a (NUM_BUCKETS,) slot when range
    mode consumes it, zero-length otherwise."""
    n = _kops.NUM_BUCKETS if want_hist else 0
    return torch.zeros(n, dtype=torch.int32, device=device)


def masked_state(b: torch.Tensor, alive: torch.Tensor, want_hist: bool):
    """Masked extract-min (plus occupancy when consumed) in the
    ``bucket_min``/``bucket_update`` contracts: seeds the carried state
    before round 0 and re-derives it on rounds with no frontier."""
    if want_hist:
        return _kops.bucket_state(b, alive)
    return _kops.bucket_min(b, alive), empty_hist(False, b.device)


def apply_decrements(b, alive, tgt, dec, decrease_key: str,
                     want_hist: bool = False):
    """Apply one aggregated update batch (``tgt`` outside ``[0, n)`` is
    dropped, ``dec`` in the counts dtype).

    ``"scatter"``: ``b`` is decremented in place (the loop owns it) and
    the round loop runs its own ``bucket_min``. ``"bucket"``: the
    batched decrease-key kernel ``ops.bucket_update``, which returns the
    updated counts with their masked min and occupancy from the same
    pass. Returns ``(b, min, hist)``; min and hist are None under
    ``"scatter"``, and hist is zero-length unless ``want_hist``."""
    if decrease_key == "bucket":
        nb, mn, hist = _kops.bucket_update(b, alive, tgt, dec)
        if not want_hist:
            hist = empty_hist(False, b.device)
        return nb, mn, hist
    n = b.shape[0]
    ok = (tgt >= 0) & (tgt < n)
    b.index_add_(0, torch.where(ok, tgt, 0), torch.where(ok, -dec, 0))
    return b, None, None


def init_loop_state(b0: torch.Tensor, n_out: int, *, decrease_key: str,
                    peel_mode: str, lvl1: int = 0,
                    lvl2: int = 0) -> LoopState:
    """Round-0 state of :func:`device_round_loop`; ``b0`` becomes the
    loop's own count tensor. ``lvl1``/``lvl2`` are the whole level-1 and
    level-2 work (the sums of ``work``'s two rows), capped below
    INT32_MAX as the reference's int32 carry caps them."""
    dev = b0.device
    alive = torch.ones(n_out, dtype=torch.bool, device=dev)
    want_hist = peel_mode == "range" and decrease_key == "bucket"
    mn = hist = None
    if decrease_key == "bucket":
        mn, hist = masked_state(b0, alive, want_hist)
    return LoopState(
        b=b0, alive=alive, out=torch.zeros_like(b0),
        kappa=torch.zeros((), dtype=torch.int32, device=dev), mn=mn,
        hist=hist, n_alive=int(n_out),
        rem=[min(int(lvl1), I32_MAX - 1), min(int(lvl2), I32_MAX - 1)],
    )


def tile_bounds(total: int, tile_cap: int, roff=None) -> list:
    """A round's tiles ``[(ts, te), ...]`` over the flat id space
    ``[0, total)``. With the host segment offsets ``roff`` the tiles cut
    only at segment boundaries (:func:`~.wedges.aligned_tile_end`, for
    the C(d, 2) tip subtract); without, they advance by ``tile_cap``
    (linear subtracts split exactly). No tile is padded."""
    out = []
    ts = 0
    while ts < total:
        if roff is None:
            te = min(ts + tile_cap, total)
        else:
            te = aligned_tile_end(roff, ts, tile_cap)
        out.append((ts, te))
        ts = te
    return out


def stream_tiles(b, alive, bounds, tile_fn, *, decrease_key: str,
                 want_hist: bool):
    """Run ``tile_fn(b, ts, te) -> (b, mn, hist)`` over one round's
    tiles. Under ``decrease_key="bucket"`` the last tile's pass already
    carries the post-round min and occupancy; a round with no tiles
    re-derives them with :func:`masked_state`."""
    mn = hist = None
    for ts, te in bounds:
        b, mn, hist = tile_fn(b, ts, te)
    if decrease_key == "bucket" and not bounds:
        mn, hist = masked_state(b, alive, want_hist)
    return b, mn, hist


def shrink_due(st: LoopState, shrink_caps) -> bool:
    """The adaptive schedule's exit test, the reference's: some planned
    capacity above the 128-lane floor is at least four times the
    remaining work it bounds. ``shrink_caps`` holds ``(cap, slot)``
    pairs, ``slot`` indexing ``st.rem``."""
    return any(cap > 128 and st.rem[slot] * 4 <= cap
               for cap, slot in shrink_caps)


def device_round_loop(st: LoopState, expand, work, *, decrease_key: str,
                      peel_mode: str, shrink_caps=()) -> LoopState:
    """The round loop shared by the tips and wings device engines:
    extract-min (carried, or the ``bucket_min`` kernel), κ update,
    exact-vs-range round accounting, peel-set selection and assignment.

    Each round computes on the device the masked min, κ, the peel set,
    its size, the range-mode bucket selection and the frontier totals
    (both rows of the static per-entity sizes ``work``, a ``(2, n_out)``
    int64 tensor of level-1 and level-2 sizes, summed over the peel
    set), and fetches them to the host in ONE blocking copy
    (:func:`fetch`): the host then knows whether to stop, how to count
    the round and how large the frontier is, so the expansion sizes its
    tensors without further syncs. This is where the port departs from
    the reference, whose whole loop is one device ``while_loop`` with a
    single sync per capacity segment.

    ``expand(st, peel, alive_prev, n_peel, totals) -> (b, overflow, mn,
    hist)`` turns the round's peel set into count decrements (``totals``
    are the host values of the two frontier totals). Range
    mode (``peel_mode="range"``): a new bucket round starts when the
    min has left the active range ``[.., hi)``; the next range is the
    lowest non-empty geometric bucket, from the carried occupancy under
    ``decrease_key="bucket"`` and from the min's bit length otherwise
    (identical by construction). Iterations inside a bucket replay the
    exact κ trajectory, so the numbers equal exact mode's.

    The frontier totals also keep ``st.rem``, the remaining work. With
    ``shrink_caps`` (the adaptive capacity schedule) the loop leaves
    before a round where :func:`shrink_due` holds, at the reference's
    exit point, so :func:`drive_segments` can re-enter it with smaller
    capacities; the state carries over as it is."""
    want_hist = peel_mode == "range" and decrease_key == "bucket"
    dtype = st.b.dtype
    while (st.n_alive > 0 and not st.overflow
           and not shrink_due(st, shrink_caps)):
        if decrease_key == "bucket":
            mn = st.mn
        else:
            mn = _kops.bucket_min(st.b, st.alive)
        kappa = torch.maximum(st.kappa, mn)
        peel = st.alive & (st.b <= kappa)
        values = [mn, peel.sum()]
        if want_hist:
            values.append(_kops.lowest_nonempty_bucket(st.hist))
        host = fetch(st, values + [(work * peel).sum(1)])
        mn_h, n_peel = host[0], host[1]
        tot = host[3:] if want_hist else host[2:]
        st.subr += 1
        if peel_mode == "range":
            if mn_h >= st.hi:
                k_sel = host[2] if want_hist else int(mn_h).bit_length()
                st.hi = _kops.bucket_upper_bound(k_sel)
                st.rounds += 1
                st.sizes.append(0)
        else:
            st.rounds += 1
            st.sizes.append(0)
        st.sizes[-1] += n_peel
        st.rem = [r - t for r, t in zip(st.rem, tot)]
        st.kappa = kappa
        st.out = torch.where(peel, kappa.to(dtype), st.out)
        alive_prev = st.alive
        st.alive = st.alive & ~peel
        st.n_alive -= n_peel
        if st.n_alive == 0:
            break  # nothing left to subtract from
        st.lanes = max(st.lanes, tot[-1])
        b, ovf, st.mn, st.hist = expand(st, peel, alive_prev, n_peel, tot)
        if ovf:
            st.overflow = True
        else:
            st.b = b
    return st


def drive_segments(run, state: LoopState, adaptive: bool = False,
                   update_caps=None) -> Optional[LoopState]:
    """Run the round loop by capacity segments and fetch the numbers to
    the host, one more counted sync. Under the fixed schedule there is
    one segment. Under the adaptive one (``adaptive=True``) a segment
    ends where the loop's shrink test fires; ``update_caps(st)`` then
    shrinks the planned capacities and ``run`` re-enters with them, as
    the reference's segment loop does. Returns the final state with
    ``out`` as a numpy array, or None when a planned capacity overflowed
    (callers descend to the host engine)."""
    st = state
    while True:
        st = run(st)
        st.segments += 1
        if st.overflow:
            return None
        if not adaptive or st.n_alive == 0:
            break
        update_caps(st)
    st.syncs += 1
    st.out = st.out.cpu().numpy()
    return st


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
