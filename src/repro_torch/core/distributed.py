"""Distributed butterfly counting and the supervised peeling round loop,
in PyTorch, on a mesh of workers (``device.DeviceMesh``).

Mapping of the paper onto the workers, the reference's:

  - The flat wedge index space is partitioned into per-worker slices
    whose boundaries are *vertex-aligned* and *wedge-balanced*. Vertex
    alignment keeps every endpoint-pair group inside one worker, so
    local aggregation is exact and the only communication is the final
    count combine.
  - Each worker consumes its slice through vertex-aligned tiles
    (``engine="fused"``: the fused counting kernel, one
    ``ops.fused_count_tiles`` launch per worker per call, its plain
    version on the CPU) or materializes and sort-aggregates the whole
    slice at once (``engine="slice"``).
  - The partial counts are summed on the first worker's device in
    ascending worker order (the reference's ``psum``);
    ``combine="scatter"`` hands each worker its contiguous shard of the
    padded sum (``psum_scatter(tiled=True)``).

Where the reference runs one SPMD program under ``shard_map``, the port
runs one worker after another from the host: each launch is
asynchronous, so workers on different cards overlap, and workers that
share a card queue on it. The numbers are the reference's bit for bit:
both cuts respect the tile-alignment invariant and integer adds commute.

The peeling half (:class:`PeelSupervisor`) is the reference's
supervised, checkpointable bucket-range round loop; see its docstring
for what runs where.
"""
from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops as _kops
from ..testing import faults as _faults
from . import checkpoint as _ckpt
from . import pipeline as _pipeline
from .aggregate import aggregate_sort
from .count import narrow_counts
from .device import DeviceMesh, resolve_device, worker_device
from .graph import BipartiteGraph, RankedGraph
from .ranking import make_order
from .resilience import (
    CapacityOverflow,
    Deadline,
    DeviceLost,
    ExecutionReport,
    RungAttempt,
    RungUnavailable,
    StragglerTimeout,
)
from .wedges import (
    auto_chunk_budget,
    device_graph,
    prepare,
    preprocess_device,
    slot_wedge_counts,
    wedge_offsets,
    wedge_prefix,
    wedges_at,
)

__all__ = [
    "plan_partition",
    "plan_fused_partition",
    "distributed_count",
    "distributed_count_fn",
    "launch_device_worker",
    "SupervisedPeel",
    "PeelSupervisor",
]

DIST_ENGINES = ("fused", "slice")
I32_MAX = _pipeline.I32_MAX

# Prepended to every worker payload: lets the chaos tests kill, hang, or
# delay a specific launch attempt from the parent via the environment,
# before the worker imports anything (a "lost device" looks exactly like
# a dead or wedged worker process, a "slow" one like a straggler).
_WORKER_FAULT_PREAMBLE = """\
import os as _os
_slow = _os.environ.pop("REPRO_FAULT_DEVICE_SLOW", None)
if _slow:
    import time as _time
    _time.sleep(float(_slow))
_mode = _os.environ.pop("REPRO_FAULT_DEVICE_LOSS", None)
if _mode == "hang":
    import time as _time
    _time.sleep(3600)
elif _mode:
    _os._exit(13)
"""


def launch_device_worker(
    code: str,
    *,
    devices: int = 1,
    device_index: int = 0,
    timeout_s: float = 540.0,
    retries: int = 1,
    backoff_s: float = 0.5,
    env: Optional[dict] = None,
    deadline_s: Optional[float] = None,
) -> str:
    """Run a Python worker payload in a subprocess, with bounded retry
    and exponential backoff and a per-attempt timeout: the per-device
    dispatch path of the resilience layer.

    The child gets the package's ``src`` directory as ``PYTHONPATH``,
    no ``XLA_FLAGS``, and ``REPRO_WORKER_DEVICES=<devices>``, the mesh
    width a payload may build with ``launch.mesh.make_test_mesh``: it
    takes the place of the reference's
    ``--xla_force_host_platform_device_count``, since a PyTorch worker
    needs no forced device count. ``env`` entries overlay that. Each
    attempt asks the fault harness
    (:func:`repro_torch.testing.faults.worker_env`) whether an armed
    ``device_loss`` or ``slow`` fault marks this launch; a ``times=1``
    fault consumes itself on the first attempt, so the retry runs
    clean. A nonzero exit or a timeout burns one attempt; after
    ``retries`` extra attempts the failure surfaces as
    :class:`DeviceLost` carrying ``device_index``, the attempt count and
    the last stderr tail. Returns the worker's stdout.

    ``deadline_s`` bounds the whole dispatch (all attempts and
    backoffs): each attempt's timeout is clamped to the remaining
    budget, backoff sleeps never overrun it, and an exhausted budget
    raises :class:`~repro_torch.core.resilience.DeadlineExceeded` rather
    than :class:`DeviceLost`."""
    src_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    base_env = dict(os.environ)
    base_env.pop("XLA_FLAGS", None)
    base_env["PYTHONPATH"] = src_root
    base_env["REPRO_WORKER_DEVICES"] = str(int(devices))
    if env:
        base_env.update(env)
    base_env.pop("REPRO_FAULT_DEVICE_LOSS", None)
    base_env.pop("REPRO_FAULT_DEVICE_SLOW", None)
    payload = _WORKER_FAULT_PREAMBLE + code
    attempts = int(retries) + 1
    last_detail = ""
    deadline = None if deadline_s is None else Deadline(float(deadline_s))
    for attempt in range(attempts):
        attempt_timeout = timeout_s
        if deadline is not None:
            remaining = deadline.remaining_s()
            if remaining <= 0:
                raise deadline.exceeded(
                    f"device worker {device_index}: dispatch budget "
                    f"{deadline.budget_s:.3f}s exhausted after "
                    f"{attempt} attempt(s); last: {last_detail or 'none'}"
                )
            attempt_timeout = min(timeout_s, remaining)
        attempt_env = _faults.worker_env(dict(base_env), device=device_index)
        try:
            out = subprocess.run(
                [sys.executable, "-c", payload],
                env=attempt_env,
                capture_output=True,
                text=True,
                timeout=attempt_timeout,
            )
        except subprocess.TimeoutExpired:
            last_detail = f"timed out after {attempt_timeout}s"
        else:
            if out.returncode == 0:
                return out.stdout
            last_detail = (
                f"exit code {out.returncode}; stderr tail: "
                f"{out.stderr[-2000:]}"
            )
        if attempt + 1 < attempts and backoff_s > 0:
            pause = backoff_s * (2 ** attempt)
            if deadline is not None:
                pause = min(pause, max(0.0, deadline.remaining_s()))
            time.sleep(pause)
    raise DeviceLost(
        f"device worker {device_index} failed after {attempts} "
        f"attempt(s): {last_detail}",
        device=device_index,
        attempts=attempts,
    )


# ---------------------------------------------------------------------------
# Partition planning (host numpy, the reference's arrays)
# ---------------------------------------------------------------------------


def _device_vertex_starts(voff: np.ndarray, n_pad: int, n_dev: int):
    """Greedy wedge-balanced vertex boundaries, one range per worker."""
    total = int(voff[-1])
    ideal = total / max(n_dev, 1)
    starts = [0]
    for d in range(1, n_dev):
        # first vertex boundary with cumulative wedges >= d * ideal
        b = int(np.searchsorted(voff, d * ideal, side="left"))
        starts.append(min(b, n_pad))
    starts.append(n_pad)
    return np.asarray(starts, dtype=np.int64)


def plan_partition(rg: RankedGraph, n_dev: int, direction: str = "low", *,
                   wv_slots: np.ndarray):
    """Wedge-balanced, vertex-aligned worker partition (host planning)
    from the per-slot wedge counts ``wv_slots`` of ``direction`` (a
    prepared graph's ``host``).

    Returns ``(w_start (n_dev + 1,), w_cap)``: worker d owns the flat
    wedge ids ``[w_start[d], w_start[d+1])``; ``w_cap`` is the largest
    share rounded up to 128. The values are the reference's (which
    stores ``w_start`` as int32; the port's flat ids are int64)."""
    voff = wedge_prefix(rg.offsets, wv_slots)[1]
    starts = _device_vertex_starts(voff, rg.n_pad, n_dev)
    w_start = voff[starts]
    per_dev = np.diff(w_start)
    cap = int(per_dev.max(initial=1))
    cap = max(128, ((cap + 127) // 128) * 128)
    return w_start.astype(np.int64), cap


def plan_fused_partition(rg: RankedGraph, n_dev: int, direction: str = "low",
                         max_chunk="auto", device=None, *,
                         wv_slots: np.ndarray):
    """Per-worker vertex-aligned tile plan for the fused engine, from the
    per-slot wedge counts ``wv_slots`` of ``direction``: the flat wedge
    space tiled once by ``pipeline.plan_count`` (at most
    ``max_chunk`` wedges per tile; ``"auto"`` derives the budget from
    ``device``'s free memory, ``wedges.auto_chunk_budget``), then split
    across workers greedily by wedge load (``pipeline.plan_partition``).

    Returns ``(tiles (n_dev, max_tiles, 2) int64, tile_cap)``: flat
    wedge-id ``[start, end)`` per tile, rows padded with empty (0, 0)
    tiles."""
    if max_chunk in (None, "auto"):
        budget = auto_chunk_budget(resolve_device(device))
    else:
        budget = int(max_chunk)
    plan = _pipeline.plan_count(
        rg, mode="global", direction=direction, aggregation="sort",
        budget=budget, engine="fused", wv_slots=wv_slots,
    )
    parts = _pipeline.plan_partition(plan, n_dev)
    return _pipeline.partition_tile_array(parts)


# ---------------------------------------------------------------------------
# Distributed counting: per-worker execution and the combine
# ---------------------------------------------------------------------------


def _pick(out: tuple, mode: str):
    """One mode of a ``(total, per_vertex, per_edge)`` triple."""
    if mode == "all":
        return out
    return out[("global", "vertex", "edge").index(mode)]


def _add(acc, part, dev):
    if isinstance(acc, tuple):
        return tuple(a + p.to(dev) for a, p in zip(acc, part))
    return acc + part.to(dev)


def _cast(out, dtype):
    if isinstance(out, tuple):
        return tuple(t.to(dtype) for t in out)
    return out.to(dtype)


def _scatter(out: torch.Tensor, workers: list) -> list:
    """``psum_scatter(tiled=True)``: the sum padded to a multiple of the
    worker count, worker ``d``'s contiguous shard on its device."""
    out = torch.cat([out, out.new_zeros((-out.shape[0]) % len(workers))])
    return [s.to(dev) for s, dev in zip(out.chunk(len(workers)), workers)]


def distributed_count_fn(
    mesh: DeviceMesh,
    axis_names: Sequence[str],
    *,
    w_cap: int,
    mode: str,
    direction: str = "low",
    dtype=torch.int32,
    precomputed_offsets: bool = False,
    combine: str = "all",
    engine: str = "slice",
):
    """Build the per-worker counting step for a mesh: ``fn(rg, bounds[,
    w_off])`` on a :class:`~repro_torch.core.graph.RankedGraph` (the
    reference takes its device graph; the port also plans the fused
    kernel's work list from the host CSR).

    ``engine="fused"``: ``bounds`` is the ``(n_dev, max_tiles, 2)`` tile
    array of :func:`plan_fused_partition`; each worker runs its row
    through ``ops.fused_count_tiles``, one launch per worker that holds
    tiles (``w_cap`` is the per-tile bound). ``engine="slice"``:
    ``bounds`` is ``(n_dev, 2)`` and each worker materializes its whole
    slice with ``wedges_at``, sort-aggregates it and accumulates
    (Lemma 4.2). Partials accumulate in int64 and come back in
    ``dtype`` (a 32-bit dtype keeps the low word).

    ``precomputed_offsets``: ``fn`` takes the int64 global wedge prefix
    as a host array instead of each worker recomputing it on its device.
    ``combine``: ``"all"`` returns the sum on the first worker's device;
    ``"scatter"`` (vertex and edge modes) returns the list of per-worker
    shards of the sum padded to a multiple of the worker count, shard
    ``d`` on worker ``d``'s device."""
    if engine not in DIST_ENGINES:
        raise ValueError(
            f"engine must be {'|'.join(DIST_ENGINES)}, got {engine}"
        )
    if combine not in ("all", "scatter"):
        raise ValueError(f"combine must be all|scatter, got {combine}")
    workers = mesh.workers(axis_names)
    n_dev = len(workers)

    def local(rg, dg, row, w_off):
        dev = dg.device
        if w_off is None:
            cnt = slot_wedge_counts(dg, direction)
            w_off_d = wedge_offsets(cnt)
        else:
            cnt = None
            w_off_d = torch.as_tensor(w_off, device=dev)
        if engine == "fused":
            tiles = row[row[:, 1] > row[:, 0]]
            if tiles.size == 0:
                return _pipeline.zero_counts(dg, mode, torch.int64)
            if dev.type == "cuda" and w_cap > _kops.MAX_TILE_CAP:
                raise CapacityOverflow(
                    f"tile_cap {w_cap} exceeds the fused kernel's bound "
                    f"{_kops.MAX_TILE_CAP}"
                )
            work = (None if w_off is None
                    else _kops.fused_work(tiles, rg.offsets, w_off, dev))
            out = _kops.fused_count_tiles(
                tiles, dg.offsets, dg.neighbors, dg.edge_src,
                dg.undirected_id, w_off_d, tile_cap=w_cap, n_pad=dg.n_pad,
                m=dg.m, direction=direction, mode=mode, work=work,
            )
            return _pick(out, mode)
        start, end = int(row[0]), int(row[1])
        if end <= start:
            return _pipeline.zero_counts(dg, mode, torch.int64)
        wid = torch.arange(start, end, dtype=torch.int64, device=dev)
        valid = torch.ones_like(wid, dtype=torch.bool)
        w = wedges_at(dg, cnt, w_off_d, wid, valid, direction)
        groups, w = aggregate_sort(w)
        return _pipeline.accumulate_counts(dg, w, groups, mode, torch.int64)

    def fn(rg: RankedGraph, bounds, w_off=None):
        if precomputed_offsets and w_off is None:
            raise ValueError("precomputed_offsets needs the w_off prefix")
        bounds = np.asarray(bounds, np.int64)
        if bounds.shape[0] != n_dev:
            raise ValueError(
                f"bounds hold {bounds.shape[0]} rows for {n_dev} workers"
            )
        graphs: dict = {}
        acc = None
        dev0 = workers[0]
        for d, dev in enumerate(workers):
            if dev not in graphs:
                graphs[dev] = device_graph(rg, dev)
            part = local(rg, graphs[dev], bounds[d], w_off)
            # ascending worker order on the first worker's device: psum
            acc = part if acc is None else _add(acc, part, dev0)
        out = _cast(acc, dtype)
        if combine == "scatter" and mode in ("vertex", "edge"):
            return _scatter(out, workers)
        return out

    return fn


def distributed_count(
    g: BipartiteGraph,
    mesh: DeviceMesh,
    axis_names: Optional[Sequence[str]] = None,
    *,
    order: str = "degree",
    mode: str = "global",
    cache_opt: bool = False,
    count_dtype=None,
    precomputed_offsets: bool = True,
    combine: str = "all",
    engine: str = "fused",
    max_chunk="auto",
):
    """End-to-end distributed counting on a mesh of workers. Returns
    ``(counts, rg)``: rank-space counts on the first worker's device (a
    list of per-worker shards under ``combine="scatter"``) and the
    :class:`~repro_torch.core.graph.RankedGraph` that maps them back.

    ``engine="fused"`` (default) streams each worker's share through
    vertex-aligned tiles of at most ``max_chunk`` wedges (``"auto"``
    derives the budget from the first worker's free memory);
    ``engine="slice"`` materializes each worker's whole slice. Both give
    the same counts. ``count_dtype=None`` counts in int64 and narrows to
    int32 after one host check, raising
    :class:`~repro_torch.core.resilience.AccumulatorOverflowRisk` when a
    count does not fit (the reference wraps)."""
    axis_names = tuple(axis_names or mesh.axis_names)
    workers = mesh.workers(axis_names)
    n_dev = len(workers)
    dev0 = workers[0]
    direction = "high" if cache_opt else "low"
    if engine == "fused" and max_chunk in (None, "auto"):
        # read the free memory before this call puts anything on dev0
        max_chunk = auto_chunk_budget(dev0)
    # prepared once, on the first worker: the plan and w_off read its
    # host wedge counts, and only those are kept, so that dev0 holds no
    # graph but its worker's own upload
    rg, dg = preprocess_device(g, make_order(g, order, device=dev0), order,
                               dev0)
    wv_slots = prepare(rg, dg, direction).host
    del dg
    if engine == "fused":
        bounds, cap = plan_fused_partition(
            rg, n_dev, direction, max_chunk=max_chunk, device=dev0,
            wv_slots=wv_slots,
        )
    else:
        w_start, cap = plan_partition(rg, n_dev, direction,
                                      wv_slots=wv_slots)
        bounds = np.stack([w_start[:-1], w_start[1:]], axis=1)
    want = torch.int32 if count_dtype is None else count_dtype
    fn = distributed_count_fn(
        mesh, axis_names, w_cap=cap, mode=mode, direction=direction,
        dtype=torch.int64 if want == torch.int32 else want,
        precomputed_offsets=precomputed_offsets, combine="all",
        engine=engine,
    )
    w_off = None
    if precomputed_offsets:
        w_off = wedge_prefix(rg.offsets, wv_slots)[0]
    out = fn(rg, bounds, w_off)
    if want == torch.int32:
        out = narrow_counts(out, want)
    if combine == "scatter" and mode in ("vertex", "edge"):
        out = _scatter(out, workers)
    return out, rg


# ---------------------------------------------------------------------------
# Distributed peeling: the supervised, checkpointable round loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SupervisedPeel:
    """Result of one supervised distributed peeling run: the peel
    numbers plus the recovery audit the frontend folds into its
    :class:`~repro_torch.core.resilience.ExecutionReport`."""

    numbers: np.ndarray
    rounds: int  # bucket rounds (range-mode ρ)
    round_sizes: np.ndarray
    sub_rounds: int  # re-settle iterations (== exact-mode ρ)
    checkpoint_restores: int
    device_reports: List[ExecutionReport]
    devices_initial: int
    devices_final: int
    resumed_from_round: int  # 0 = fresh start


@dataclasses.dataclass
class _RoundState:
    """Supervisor state between checkpoints. ``b`` and ``alive_d`` live
    on the first worker's device; ``alive`` and ``out`` are their host
    mirrors (the expansion and the checkpoints read them)."""

    b: torch.Tensor  # remaining support (counts)
    alive_d: torch.Tensor  # bool per entity, on the device
    alive: np.ndarray  # bool per entity
    out: np.ndarray  # peel numbers assigned so far
    kappa: int
    hi: int  # exclusive bound of the active geometric bucket
    rounds: int
    subr: int
    sizes: list
    # (masked min, host peel mask at max(κ, min), device peel mask) of the
    # current support, read with the last sub-round; None after a restore
    scan: Optional[tuple] = None


class PeelSupervisor:
    """The distributed peeling round loop: coarse bucket selection,
    per-range fine passes fanned out across the workers, one checkpoint
    per committed round, and elastic recovery.

    Round structure (the reference's, line for line): the **coarse
    phase** opens the lowest non-empty geometric bucket of the masked
    min, ``hi = 1 << mn.bit_length()``; the **fine phase** re-settles
    that bucket: peel every alive entity with support ≤ κ, fan the
    frontier's subtract out across the workers, reduce their decrement
    batches, advance κ, until the masked min leaves the bucket. This
    replays the κ trajectory of the single-device engines, so the
    numbers are theirs bit for bit.

    What runs where: ``expand(a_ids, alive, peel) -> (owner, payload)``
    enumerates a sub-round's frontier in host numpy (``owner`` the
    ascending iterating-entity ids, ``payload`` equal-length arrays), as
    the reference does. Worker ``d`` runs on ``device.worker_device``
    (the visible devices of the type, round-robin; on one card every
    worker shares it, each on its own CUDA stream): ``subtract(payload,
    device) -> (idx, dec)`` moves its slice to its device and returns a
    decrement batch (``idx`` outside ``[0, n)`` is dropped). A worker
    never writes shared state, so a straggler's twin returning the same
    batch is harmless: only the first is applied. The supervisor keeps
    the support and the alive mask on the first worker's device and
    applies one sub-round's batches, concatenated in ascending worker
    order, with ONE ``ops.bucket_update`` launch, which also returns the
    masked min the fine loop tests; a sub-round with no frontier, and a
    restore, take the min from ``ops.bucket_min``. Integer adds commute,
    so the sums are the reference's. One host read per sub-round
    fetches that min with the next peel set; one more per committed
    round fetches the support for the checkpoint.

    Both kernels clamp the min to INT32_MAX. Where the clamped min is
    INT32_MAX, int64 counts and something alive, the supervisor takes
    the exact int64 min of the alive support (a plain reduction, one more
    read), so κ and ``hi`` stay exact at and above 2^31 − 1.

    Fan-out goes through ``pipeline.plan_partition`` over the peeling
    plan's coarse entity tiles: worker *i* owns a contiguous entity
    range and every frontier item is routed by its iterating entity.

    Recovery, every path bitwise-identical or typed:

      - **DeviceLost**: drop the worker, re-partition over the
        survivors, restore the last committed
        :class:`~repro_torch.core.checkpoint.RoundCheckpoint`, replay.
        Counted in ``checkpoint_restores``.
      - **Straggler** (a worker misses the per-round deadline):
        re-dispatch its slice once and keep the first completion.
      - **Repeated failure**: a second miss raises
        :class:`~repro_torch.core.resilience.StragglerTimeout`; losing
        every worker raises
        :class:`~repro_torch.core.resilience.RungUnavailable`. Both
        descend the caller's ladder.
    """

    def __init__(
        self,
        workload: str,
        plan,
        counts: np.ndarray,
        *,
        expand: Callable,
        subtract: Callable,
        devices: int,
        checkpoint=None,
        round_deadline_s: Optional[float] = None,
        deadline_s: Optional[float] = None,
        device=None,
    ):
        self.workload = workload
        self.plan = plan
        self.counts = np.asarray(counts)
        self.expand = expand
        self.subtract = subtract
        self.devices = int(devices)
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if isinstance(checkpoint, _ckpt.CheckpointStore):
            self.store = checkpoint
        elif checkpoint is None:
            self.store = _ckpt.CheckpointStore()
        else:
            self.store = _ckpt.CheckpointStore(directory=str(checkpoint))
        # per-round deadline from the plan's static expansion totals:
        # generous, but bounded, so a wedged worker cannot stall the run
        if round_deadline_s is None:
            round_deadline_s = max(5.0, 1e-6 * float(plan.total_wedges))
        self.round_deadline_s = float(round_deadline_s)
        # overall run budget: the countdown starts at run(), clamps every
        # per-round deadline, and raises DeadlineExceeded when it runs out
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self._deadline: Optional[Deadline] = None
        self.plan_hash = _ckpt.plan_hash(plan)
        self._stats = {
            d: {"rounds": 0, "redispatch": 0, "lost": 0}
            for d in range(self.devices)
        }
        kind = resolve_device(device).type
        self._workers = [worker_device(kind, d) for d in range(self.devices)]
        self._dev = self._workers[0]
        self._streams = [
            torch.cuda.Stream(dev) if kind == "cuda" else None
            for dev in self._workers
        ]
        self._wide = self.counts.dtype == np.int64
        self.syncs = 0  # blocking device -> host reads (host_syncs)
        self.lanes = 0  # largest sub-round frontier, in items

    # -- partition ----------------------------------------------------

    def _entity_ranges(self, live: list) -> list:
        """Contiguous entity range per live worker via plan_partition
        over the surviving worker count (the elastic re-partition)."""
        parts = _pipeline.plan_partition(self.plan, len(live))
        ranges = []
        for p in parts:
            if p.n_tiles:
                ranges.append((int(p.bounds[0]), int(p.bounds[-1])))
            else:
                ranges.append((0, 0))
        return ranges

    # -- worker task --------------------------------------------------

    def _device_task(self, round_ix: int, d: int, payload):
        site = f"distributed.peel.round{round_ix}.dev{d}"
        _faults.maybe_device_loss(site, device=d)
        _faults.maybe_slow(site, device=d)
        dev, stream = self._workers[d], self._streams[d]
        if stream is None:
            return (*self.subtract(payload, dev), None)
        with torch.cuda.stream(stream):
            idx, dec = self.subtract(payload, dev)
            done = torch.cuda.Event()
            done.record(stream)
        return idx, dec, done

    # -- fine-pass fan-out with straggler re-dispatch -----------------

    def _round_budget_s(self) -> float:
        """Per-round straggler deadline, clamped to the remaining overall
        ``deadline_s`` budget; an exhausted budget raises
        :class:`~repro_torch.core.resilience.DeadlineExceeded`."""
        if self._deadline is None:
            return self.round_deadline_s
        remaining = self._deadline.remaining_s()
        if remaining <= 0:
            raise self._deadline.exceeded(
                f"{self.workload}: run budget "
                f"{self._deadline.budget_s:.3f}s exhausted mid-round"
            )
        return min(self.round_deadline_s, remaining)

    def _fanout(self, pool, round_ix: int, live: list, ranges: list,
                owner: np.ndarray, payload: tuple) -> list:
        slices = {}
        for i, d in enumerate(live):
            lo, hi = ranges[i]
            s = int(np.searchsorted(owner, lo, side="left"))
            e = int(np.searchsorted(owner, hi, side="left"))
            slices[d] = tuple(a[s:e] for a in payload)
        primary = {
            d: pool.submit(self._device_task, round_ix, d, slices[d])
            for d in live
        }
        fut_dev = {f: d for d, f in primary.items()}
        pending = dict(primary)
        dups: dict = {}
        results: dict = {}
        deadline = time.monotonic() + self._round_budget_s()
        while pending:
            waitset = [
                f
                for d in pending
                for f in (pending[d], dups.get(d))
                if f is not None
            ]
            timeout = max(0.0, deadline - time.monotonic())
            done, _ = _cf.wait(
                waitset, timeout=timeout, return_when=_cf.FIRST_COMPLETED,
            )
            progressed = False
            for f in done:
                d = fut_dev[f]
                if d in results:
                    continue  # the twin already answered
                # first completion wins; a raising future (DeviceLost)
                # surfaces here and the run loop handles recovery
                results[d] = f.result()
                self._stats[d]["rounds"] += 1
                pending.pop(d, None)
                dups.pop(d, None)
                progressed = True
            if progressed:
                deadline = time.monotonic() + self._round_budget_s()
                continue
            if time.monotonic() < deadline:
                continue
            # deadline passed, nothing finished: every still-pending
            # worker is a straggler; re-dispatch once, a second miss is
            # a typed failure
            for d in sorted(pending):
                if d in dups:
                    raise StragglerTimeout(
                        f"{self.workload}: device {d} missed the "
                        f"{self.round_deadline_s:.3f}s round deadline "
                        f"twice (round {round_ix})",
                        device=d,
                        deadline_s=self.round_deadline_s,
                    )
                nf = pool.submit(self._device_task, round_ix, d, slices[d])
                dups[d] = nf
                fut_dev[nf] = d
                self._stats[d]["redispatch"] += 1
            deadline = time.monotonic() + self._round_budget_s()
        # fixed ascending-worker order
        return [results[d] for d in sorted(results)]

    # -- device state -------------------------------------------------

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """The supervisor's only way to read the device: one blocking
        copy, counted in ``host_syncs``."""
        self.syncs += 1
        return t.cpu().numpy()

    def _reduce(self, st: _RoundState, batches: list):
        """Apply one sub-round's decrement batches, in ascending worker
        order, with one ``bucket_update``; returns the masked min."""
        idx, dec = [], []
        stream = (torch.cuda.current_stream(self._dev)
                  if self._dev.type == "cuda" else None)
        for i, d, done in batches:
            if done is not None:
                stream.wait_event(done)
                # the batch was allocated on the worker's stream: keep
                # the allocator from reusing it before this stream reads
                i.record_stream(stream)
                d.record_stream(stream)
            idx.append(i.to(self._dev))
            dec.append(d.to(self._dev))
        st.b, mn, _hist = _kops.bucket_update(
            st.b, st.alive_d, torch.cat(idx), torch.cat(dec)
        )
        return mn

    def _scan(self, st: _RoundState, mn: torch.Tensor) -> tuple:
        """Read the masked min and the peel set at ``max(κ, min)`` in one
        fetch. The kernels clamp the min to INT32_MAX, so where it reads
        INT32_MAX with int64 counts and something alive, the exact min
        comes from one more read."""
        kap = torch.clamp(mn.to(st.b.dtype), min=st.kappa)
        peel = st.alive_d & (st.b <= kap)
        raw = self._fetch(torch.cat([
            mn.reshape(1).to(torch.int32).view(torch.uint8),
            peel.view(torch.uint8),
        ]))
        mn_h = int(raw[:4].view(np.int32)[0])
        if mn_h == I32_MAX and self._wide and st.alive.any():
            imax = torch.iinfo(st.b.dtype).max
            exact = torch.where(st.alive_d, st.b, imax).amin()
            mn_h = int(self._fetch(exact.reshape(1))[0])
            peel = st.alive_d & (st.b <= max(st.kappa, mn_h))
            return mn_h, self._fetch(peel), peel
        return mn_h, raw[4:].view(bool), peel

    # -- the round loop -----------------------------------------------

    def _capture(self, st: _RoundState, support=None) -> None:
        if support is None:
            support = self._fetch(st.b)
        self.store.save(_ckpt.RoundCheckpoint.capture(
            plan_hash=self.plan_hash,
            round_index=st.rounds,
            sub_rounds=st.subr,
            kappa=st.kappa,
            bucket_hi=st.hi,
            support=support,
            alive=st.alive,
            numbers=st.out,
            round_sizes=st.sizes,
        ))

    def _state(self, b, alive, out, **kw) -> _RoundState:
        return _RoundState(
            b=torch.as_tensor(b, device=self._dev).clone(),
            alive_d=torch.as_tensor(alive, device=self._dev).clone(),
            alive=alive.copy(), out=out, **kw,
        )

    def _restore(self) -> _RoundState:
        cp = self.store.restore(self.plan_hash)
        b, alive, out = cp.arrays()
        return self._state(
            b, alive, out, kappa=cp.kappa, hi=cp.bucket_hi,
            rounds=cp.round_index, subr=cp.sub_rounds,
            sizes=list(cp.round_sizes),
        )

    def _bucket_round(self, pool, st: _RoundState, live: list,
                      ranges: list) -> None:
        """One coarse bucket and its fine re-settle passes, mutating
        ``st``. Raises DeviceLost/StragglerTimeout without committing;
        the caller restores the last checkpoint."""
        round_ix = st.rounds
        if st.scan is None:
            st.scan = self._scan(st, _kops.bucket_min(st.b, st.alive_d))
        mn = st.scan[0]
        st.kappa = max(st.kappa, mn)
        # coarse phase: the masked min's bit length names the lowest
        # non-empty geometric bucket [2^(k-1), 2^k)
        st.hi = 1 << int(mn).bit_length()
        st.rounds += 1
        st.sizes.append(0)
        while True:
            st.subr += 1
            _mn, peel, peel_d = st.scan
            a_ids = np.flatnonzero(peel)
            st.out[a_ids] = st.kappa
            st.alive[a_ids] = False
            st.alive_d &= ~peel_d
            st.sizes[-1] += int(a_ids.size)
            st.scan = None
            if not st.alive.any():
                return
            owner, payload = self.expand(a_ids, st.alive, peel)
            if owner.size:
                self.lanes = max(self.lanes, int(owner.size))
                batches = self._fanout(
                    pool, round_ix, live, ranges, owner, payload
                )
                mn_d = self._reduce(st, batches)
            else:
                mn_d = _kops.bucket_min(st.b, st.alive_d)
            st.scan = self._scan(st, mn_d)
            mn = st.scan[0]
            if mn >= st.hi:
                return  # min left the bucket: round committed
            st.kappa = max(st.kappa, mn)

    def run(self) -> SupervisedPeel:
        n_out = int(self.counts.shape[0])
        resumed_from = 0
        if self.store.latest() is not None:
            # cross-process resume: continue from the stored snapshot
            st = self._restore()
            self.store.restores -= 1  # construction-time, not recovery
            resumed_from = st.rounds
        else:
            st = self._state(
                self.counts, np.ones(n_out, dtype=bool),
                np.zeros(n_out, dtype=self.counts.dtype),
                kappa=0, hi=0, rounds=0, subr=0, sizes=[],
            )
            # round-0 snapshot anchors the first rollback
            self._capture(st, support=self.counts)
        live = list(range(self.devices))
        ranges = self._entity_ranges(live)
        restores = 0
        self._deadline = (
            None if self.deadline_s is None else Deadline(self.deadline_s)
        )
        pool = _cf.ThreadPoolExecutor(
            max_workers=self.devices + 1, thread_name_prefix="peel-dev",
        )
        try:
            while st.alive.any():
                if (self._deadline is not None
                        and self._deadline.expired()):
                    # the committed rounds live in the checkpoint store;
                    # a re-run with more budget resumes, not restarts
                    raise self._deadline.exceeded(
                        f"{self.workload}: run budget "
                        f"{self._deadline.budget_s:.3f}s exhausted after "
                        f"{st.rounds} committed round(s)"
                    )
                try:
                    self._bucket_round(pool, st, live, ranges)
                except DeviceLost as e:
                    d = e.device if e.device in live else live[0]
                    live.remove(d)
                    self._stats[d]["lost"] += 1
                    if not live:
                        raise RungUnavailable(
                            f"{self.workload}: all {self.devices} mesh "
                            f"devices lost (last: device {d}; "
                            f"{restores} checkpoint restores)"
                        ) from e
                    st = self._restore()
                    restores += 1
                    ranges = self._entity_ranges(live)
                    continue
                self._capture(st)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        return SupervisedPeel(
            numbers=st.out,
            rounds=st.rounds,
            round_sizes=np.asarray(st.sizes, dtype=np.int64),
            sub_rounds=st.subr,
            checkpoint_restores=restores,
            device_reports=self._device_reports(live),
            devices_initial=self.devices,
            devices_final=len(live),
            resumed_from_round=resumed_from,
        )

    def _device_reports(self, live: list) -> List[ExecutionReport]:
        reports = []
        for d in range(self.devices):
            s = self._stats[d]
            outcome = "device-lost" if s["lost"] else "ok"
            rep = ExecutionReport(
                workload=f"{self.workload}@dev{d}", requested="worker",
            )
            rep.attempts.append(RungAttempt(
                rung=f"dev{d}",
                outcome=outcome,
                detail=(
                    f"rounds={s['rounds']} "
                    f"redispatches={s['redispatch']} losses={s['lost']}"
                ),
                retries=s["redispatch"],
            ))
            rep.final_rung = f"dev{d}" if d in live else None
            reports.append(rep)
        return reports
