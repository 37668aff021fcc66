"""Butterfly peeling: tip (vertex) and wing (edge) decomposition
(paper §4.3, Algs. 5-7), in PyTorch.

Round structure (all engines):
  κ <- max(κ, min butterfly count among alive)   [bucketing extract-min]
  A <- all alive with count <= κ                 [peel the whole bucket]
  enumerate wedges/butterflies incident to A     [prefix-sum expansion
                                                  of the CSR]
  aggregate + subtract contributions             [sort or hash grouping]

Decompositions: tips (PEEL-V, Alg. 5, ``peel_tips``), stored-wedge tips
(WPEEL-V, Alg. 7, ``peel_tips_stored``: every side-oriented wedge is
stored up front in a CSR keyed by its first endpoint, and a round looks
its frontier up instead of re-enumerating two hops) and wings (PEEL-E,
Alg. 6, ``peel_wings``).

Engines (``engine=``):

  - **host**: the ladder's bottom rung. Each round fetches the counts
    (tips) or the ``bucket_min`` kernel's min with the counts (wings) to
    the host, enumerates the frontier with numpy, and subtracts on the
    device.
  - **device**: the round loop of ``pipeline.device_round_loop``. The
    frontier is expanded and subtracted on the device; one host sync
    per round fetches the scalars that steer the loop (min, peel-set
    size, bucket selection, frontier totals), plus one per round whose
    tip frontier spans more than one tile. The reference keeps this
    loop in one ``lax.while_loop`` with one sync per capacity segment;
    the port's per-round sync is its known divergence, counted in
    ``report.host_syncs``.

Knobs of the device engine:

  - ``subtract="fused"`` (default): a round's frontier streams through
    tiles of at most ``tile_budget`` lanes, recovered from flat ids
    (``wedges.ragged_slots_at``); WPEEL-V recovers them straight from
    the stored-wedge CSR, with no frontier buffer at all.
    ``"materialize"``: the whole round frontier is one tile of exactly
    its lanes, bounded by ``max_frontier`` (the reference pads it to a
    power of two; the port pads nothing). The numbers are the same.
  - ``decrease_key="bucket"`` (default): each tile's aggregated update
    batch goes through the ``bucket_update`` kernel, which returns the
    next round's masked min (and, in range mode, the bit-length
    occupancy) from the same pass. ``"scatter"``: an in-place scatter
    per tile and the ``bucket_min`` kernel at the top of each round.
  - ``capacity_schedule="fixed"|"adaptive"``: the planned frontier
    capacities (level 1 of PEEL-V, the materialized buffers) stay as
    planned, or shrink geometrically as the graph empties: the loop
    tracks the remaining work, leaves a segment when it falls to a
    quarter of a capacity and re-enters with power-of-two-shrunk
    capacities, at the reference's exit points, so ``report.segments``
    equals the reference's segment count. The port pads no buffer, so
    the capacities only bound the overflow test; the numbers are the
    same.
  - ``peel_mode="exact"|"range"``: one round per distinct κ, or one
    round per geometric bucket ``[2^(k-1), 2^k)`` whose in-bucket
    re-settle iterations replay the exact κ trajectory (``sub_rounds``
    equals exact mode's ``rounds``). The numbers are the same.
  - ``aggregation="sort"|"hash"``: the grouping of a tile's wedge pairs
    (tips) or butterfly edge ids (wings); hash falls back to sort on a
    table overflow. The numbers are the same.
  - ``tile_budget``: lanes per fused subtract tile. Tiles are cut as
    the reference cuts them (tips at peeled-vertex boundaries,
    ``wedges.aligned_tile_end``, wings every ``tile_cap`` lanes) but
    never padded, so a small round pays only its own lanes and the
    budget only bounds peak memory: the port's default is 2^20 where the
    reference, which pads every tile, takes 1024.
  - ``max_frontier`` bounds the planned frontier capacities: PEEL-V's
    level-1 frontier, and under ``"materialize"`` the whole frontier of
    every decomposition. A round beyond it descends to the host engine,
    never a silent truncation. Counts at or beyond INT32_MAX also take
    the host engine.

Not ported yet (each raises ``NotImplementedError``, ROADMAP.md queue 1
step 7): the distributed rung (``devices=``, ``checkpoint=``,
``round_deadline_s=``, ``deadline_s=``).

Double-count avoidance (paper §4.3.1/§4.3.2): peel-set members are
processed against a virtual rank order (their id); an element of the
current peel set is "present" for a lower-id member's enumeration and
"absent" for a higher-id member's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops as _kops
from ..testing import faults as _faults
from . import resilience as _res
from .count import count_butterflies, default_count_dtype
from .device import resolve_device
from .graph import BipartiteGraph
from .pipeline import (
    I32_MAX as _I32_MAX,
    apply_decrements as _apply_decrements,
    compact as _compact,
    device_round_loop as _device_round_loop,
    drive_segments as _drive_segments,
    execute_ladder as _execute_ladder,
    fetch as _fetch,
    init_loop_state as _init_state,
    plan_peel as _plan_peel,
    prefix_offsets as _prefix,
    stream_tiles as _stream_tiles,
    tile_apply as _tile_apply,
    tile_bounds as _tile_bounds,
)
from .wedges import (
    Wedges,
    degree_sorted_csr,
    expand_ragged,
    greedy_vertex_blocks,
    ragged_slots_at,
)

__all__ = [
    "PeelResult",
    "peel_tips",
    "peel_tips_stored",
    "peel_wings",
    "peel_validator",
    "PEEL_ENGINES",
    "PEEL_SUBTRACTS",
    "PEEL_DECREASE_KEYS",
    "PEEL_SCHEDULES",
    "PEEL_MODES",
]

PEEL_ENGINES = ("host", "device")
PEEL_SUBTRACTS = ("fused", "materialize")
PEEL_DECREASE_KEYS = ("bucket", "scatter")
PEEL_SCHEDULES = ("fixed", "adaptive")
PEEL_MODES = ("exact", "range")

# Default lanes per subtract tile (see the module docstring): the port
# pads no tile, so the target only bounds a round's peak temporaries
# (a few hundred bytes per lane).
_DEFAULT_TILE_TARGET = 1 << 20

_NOT_PORTED = "not ported to PyTorch yet (ROADMAP.md, queue 1 step 7)"


class PeelResult(NamedTuple):
    numbers: np.ndarray  # tip number per side-vertex, or wing per edge
    side: Optional[int]  # 0 = U peeled, 1 = V peeled (tips only)
    rounds: int  # ρ: distinct-value rounds (exact) / bucket rounds (range)
    round_sizes: np.ndarray  # peeled per round
    sub_rounds: Optional[int] = None  # re-settle iterations (== exact ρ)
    report: Optional["_res.ExecutionReport"] = None  # resilience audit


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [s, s+len) ranges: vectorized segment arange."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(lens)
    idx = np.arange(total, dtype=np.int64)
    seg = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
    base = np.concatenate([[0], ends[:-1]])
    return starts[seg] + idx - base[seg]


def _pow2_pad(x: int, floor: int = 128) -> int:
    c = floor
    while c < x:
        c <<= 1
    return c


def _csr(g: BipartiteGraph):
    """Global-id CSR (U ids then V ids), neighbors ascending."""
    n = g.n
    src = np.concatenate([g.edges[:, 0], g.n_u + g.edges[:, 1]])
    dst = np.concatenate([g.n_u + g.edges[:, 1], g.edges[:, 0]])
    uid = np.concatenate([np.arange(g.m), np.arange(g.m)]).astype(np.int64)
    perm = np.lexsort((dst, src))
    src, dst, uid = src[perm], dst[perm], uid[perm]
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=off[1:])
    return off, dst, uid


def _side_and_counts(g, counts, side, count_kwargs, device):
    """Resolve the peeled side and its per-vertex butterfly counts."""
    w_u, w_v = g.wedge_totals()
    if side is None:
        side = 0 if w_u <= w_v else 1
    if counts is None:
        r = count_butterflies(
            g, mode="vertex", count_dtype=default_count_dtype(),
            device=device, **(count_kwargs or {})
        )
        counts = r.per_u if side == 0 else r.per_v
    return side, np.asarray(counts).copy()


def _level2_totals(off: np.ndarray, nbr: np.ndarray, base: int,
                   n_side: int) -> np.ndarray:
    """Per-vertex 2-hop expansion totals: w2[u] = Σ_{v in N(u)} deg(v),
    the exact size of a peeled vertex's frontier wedge space."""
    deg = np.diff(off)
    ids = np.arange(n_side) + base
    d1 = deg[ids]
    w2 = np.zeros(n_side, dtype=np.int64)
    if d1.sum():
        v_rep = nbr[_ranges(off[ids], d1)]
        np.add.at(w2, np.repeat(np.arange(n_side), d1), deg[v_rep])
    return w2


def _stored_wedge_csr(g: BipartiteGraph, side: int, block: int = 1 << 24):
    """All side-oriented wedges keyed by first endpoint (Alg. 7's W_e):
    CSR ``(woff, w_u2)`` with ``w_u2[woff[u]:woff[u+1]]`` the second
    endpoints of u's wedges (u2 != u1), in the reference's order and
    with its values. O(Σ deg²_side) space.

    ``w_u2`` is int32 (side ids fit it; the reference keeps int64), and
    the first endpoints are enumerated in blocks of about ``block``
    candidate wedges, so the host holds the int32 result and one block's
    int64 temporaries rather than several int64 arrays of the full
    size."""
    off, nbr, _ = _csr(g)
    n_side = g.n_u if side == 0 else g.n_v
    base = 0 if side == 0 else g.n_u
    # candidates per first endpoint, u2 == u1 included: an upper bound
    # on its row, so the output is allocated once
    cand = _level2_totals(off, nbr, base, n_side)
    out = np.empty(int(cand.sum()), dtype=np.int32)
    rows = np.zeros(n_side, dtype=np.int64)
    vb, _ = greedy_vertex_blocks(cand, n_side, target=block)
    w = 0
    for lo, hi in zip(vb[:-1], vb[1:]):
        ids = np.arange(lo, hi) + base
        deg1 = off[ids + 1] - off[ids]
        u1_rep = np.repeat(np.arange(lo, hi), deg1)
        v_rep = nbr[_ranges(off[ids], deg1)]
        deg2 = off[v_rep + 1] - off[v_rep]
        w_u1 = np.repeat(u1_rep, deg2)
        w_u2 = nbr[_ranges(off[v_rep], deg2)] - base
        keep = w_u2 != w_u1
        kept = w_u2[keep]
        out[w: w + kept.size] = kept
        w += kept.size
        rows[lo:hi] = np.bincount(w_u1[keep] - lo, minlength=hi - lo)
    woff = np.zeros(n_side + 1, dtype=np.int64)
    np.cumsum(rows, out=woff[1:])
    return woff, out[:w]


def _group_ends(keys: torch.Tensor, sent: int):
    """Sort-based grouping without a host sync: sort ``keys`` and mark
    the last lane of each run of equal keys. Returns ``(sorted keys,
    run length at each last lane (0 elsewhere), last-lane mask)``;
    runs of the sentinel ``sent`` are never marked."""
    s = torch.sort(keys).values
    n = s.shape[0]
    lane = torch.arange(1, n + 1, device=s.device)
    last = torch.ones(n, dtype=torch.bool, device=s.device)
    last[:-1] = s[1:] != s[:-1]
    last &= s != sent
    # a run's first lane is where its key's lower bound lands
    return s, torch.where(last, lane - torch.searchsorted(s, s), 0), last


def _subtract_tile(u1, u2, valid, b, alive, *, aggregation: str,
                   n_side: int, hash_bits: Optional[int] = None,
                   decrease_key: str = "scatter", want_hist: bool = False):
    """Group one tile of (u1, u2) frontier wedge pairs and subtract
    C(d, 2) from B[u2]. ``sort`` groups without a host sync; ``hash``
    runs the counting engine's shared hash aggregation
    (``pipeline.tile_apply``, with its sort fallback on a table
    overflow). Returns ``(b, min, hist)`` (see
    ``pipeline.apply_decrements``)."""
    dtype = b.dtype
    if aggregation == "sort":
        sent = n_side * n_side
        s, d, last = _group_ends(torch.where(valid, u1 * n_side + u2, sent),
                                 sent)
        d = d.to(dtype)
        tgt = torch.where(last, s % n_side, n_side)
        return _apply_decrements(b, alive, tgt, d * (d - 1) // 2,
                                 decrease_key, want_hist)
    x1 = torch.where(valid, u1, n_side)
    x2 = torch.where(valid, u2, n_side)
    w = Wedges(x1=x1, x2=x2, y=x1, center_slot=x1, second_slot=x1,
               valid=valid)

    def consume(_wv, groups):
        d = groups.d.to(dtype)
        dec = torch.where(groups.valid, d * (d - 1) // 2, 0)
        tgt = torch.where(groups.valid, groups.x2.to(torch.int64), n_side)
        return _apply_decrements(b, alive, tgt, dec, decrease_key,
                                 want_hist)

    out, _ok = _tile_apply(w, aggregation, consume, "torch", hash_bits)
    return out


def _subtract_edge_groups(tgt3, valid3, b, alive, *, aggregation: str,
                          m: int, hash_bits: Optional[int] = None,
                          decrease_key: str = "scatter",
                          want_hist: bool = False):
    """Group one tile of butterfly edge ids and subtract each group's
    size: every located butterfly takes 1 from each of its three
    still-present edges, one subtract per distinct edge. Returns
    ``(b, min, hist)``."""
    key = torch.where(valid3, tgt3, m)
    if aggregation == "sort":
        s, d, last = _group_ends(key, m)
        return _apply_decrements(b, alive, torch.where(last, s, m),
                                 d.to(b.dtype), decrease_key, want_hist)
    w = Wedges(x1=key, x2=key, y=key, center_slot=key, second_slot=key,
               valid=valid3)

    def consume(_wv, groups):
        dec = torch.where(groups.valid, groups.d.to(b.dtype), 0)
        tgt = torch.where(groups.valid, groups.x1.to(torch.int64), m)
        return _apply_decrements(b, alive, tgt, dec, decrease_key,
                                 want_hist)

    out, _ok = _tile_apply(w, aggregation, consume, "torch", hash_bits)
    return out


def _host_subtract_frontier(b_dev, u1_w, u2_w, n_side, aggregation,
                            hash_bits, tile_cap):
    """Host-engine frontier subtract: stream the round's (ascending-u1)
    wedge pairs to the device in u1-aligned tiles of at most
    ``tile_cap`` pairs (a vertex above it gets a tile of its own), or,
    with ``tile_cap=None`` (``subtract="materialize"``), as one block."""
    if tile_cap is None:
        bounds = np.array([0, u1_w.size], dtype=np.int64)
    else:
        run_ends = np.flatnonzero(np.diff(u1_w)) + 1
        row_off = np.concatenate([[0], run_ends, [u1_w.size]])
        vb, _ = greedy_vertex_blocks(np.diff(row_off), row_off.size - 1,
                                     target=tile_cap)
        bounds = row_off[vb]
    dev = b_dev.device
    for ws, we in zip(bounds[:-1], bounds[1:]):
        if we == ws:
            continue
        u1 = torch.as_tensor(u1_w[ws:we], device=dev)
        u2 = torch.as_tensor(u2_w[ws:we], device=dev).long()
        valid = torch.ones(int(we - ws), dtype=torch.bool, device=dev)
        b_dev, _, _ = _subtract_tile(
            u1, u2, valid, b_dev, None, aggregation=aggregation,
            n_side=n_side, hash_bits=hash_bits, decrease_key="scatter",
        )
    return b_dev


def _budgets(max_frontier, tile_budget, budget_shrinks):
    budget = _I32_MAX if max_frontier is None else int(max_frontier)
    tb = _DEFAULT_TILE_TARGET if tile_budget is None else int(tile_budget)
    if budget_shrinks:
        budget = max(128, budget >> budget_shrinks)
        tb = max(1, tb >> budget_shrinks)
    return budget, tb


def _result(st, side) -> PeelResult:
    return PeelResult(st.out, side, st.rounds,
                      np.asarray(st.sizes, dtype=np.int64),
                      sub_rounds=st.subr)


def _tip_tile_cap(tb: int, total: int, max_row: int, floor: int) -> int:
    """Fused tip tile: the target, but at least ``floor`` times the
    largest single-vertex expansion (the alignment floor)."""
    return _pow2_pad(max(min(tb, max(total, 1)), floor * max_row))


# ---------------------------------------------------------------------------
# Device tip engine (PEEL-V / WPEEL-V): frontier expansion on the device
# ---------------------------------------------------------------------------


def _peel_tips_device_run(g, counts, side, aggregation, stored, max_frontier,
                          hash_bits, csr, *, subtract="fused",
                          decrease_key="bucket", capacity_schedule="fixed",
                          tile_budget=None, w2=None, peel_mode="exact",
                          budget_shrinks=0, note=None, audit=None,
                          device=None) -> Optional[PeelResult]:
    """Plan and run the device tip loop: PEEL-V's 2-hop expansion from
    the graph CSR ``csr = (off, nbr)``, or with ``stored`` WPEEL-V's
    lookup in the stored-wedge CSR ``csr = (woff, w_u2)``.

    Returns None when the device engine does not apply (empty side,
    counts or totals beyond int32) or a round's frontier exceeded a
    ``max_frontier``-derived capacity (PEEL-V's level 1; under
    ``subtract="materialize"`` the whole frontier): the ladder then
    descends to the host engine, reusing ``csr`` and ``w2``.
    ``budget_shrinks`` halves the budgets that many times (the ladder's
    RESOURCE_EXHAUSTED re-entry). The loop's ``(host syncs, segments,
    largest frontier)`` are appended to ``audit``."""
    note = [] if note is None else note
    n_side = g.n_u if side == 0 else g.n_v
    base = 0 if side == 0 else g.n_u
    if n_side == 0 or int(counts.max(initial=0)) >= _I32_MAX:
        note.append("device engine unavailable: empty side or counts "
                    "beyond int32")
        return None
    budget, tb = _budgets(max_frontier, tile_budget, budget_shrinks)
    if stored:
        woff, w_u2 = csr
        lvl1, lvl2 = 0, int(woff[-1])
        if lvl2 >= _I32_MAX:
            note.append("device engine unavailable: stored wedge total "
                        "beyond int32 indexing")
            return None
        work1, work2 = np.zeros(n_side, np.int64), np.diff(woff)
        off_d = torch.as_tensor(woff, device=device)
        # the stored wedges go up as they are, 4 bytes each
        nbr_d = torch.as_tensor(w_u2, device=device)
    else:
        off, nbr = csr
        deg = np.diff(off)
        if w2 is None:
            w2 = _level2_totals(off, nbr, base, n_side)
        lvl1 = int(deg[base: base + n_side].sum())
        lvl2 = int(w2.sum())
        if lvl2 >= _I32_MAX or 2 * g.m >= _I32_MAX:
            note.append("device engine unavailable: expansion totals "
                        "beyond int32 indexing")
            return None
        work1, work2 = deg[base: base + n_side], w2
        off_d = torch.as_tensor(off, device=device)
        nbr_d = torch.as_tensor(nbr, device=device)
        deg_d = torch.as_tensor(deg, device=device)
    # level-1 and level-2 (or stored) frontier sizes per vertex
    work = torch.stack([torch.as_tensor(work1, device=device),
                        torch.as_tensor(work2, device=device)])
    materialize = subtract == "materialize"
    adaptive = capacity_schedule == "adaptive"
    caps = {"cap1": 128 if stored else _pow2_pad(min(lvl1, budget)),
            "cap2": _pow2_pad(min(lvl2, budget))}
    # a fused tile holds the largest single-vertex expansion; the 2x
    # headroom keeps greedy tiles half full
    tile_cap = _tip_tile_cap(tb, lvl2, int(work2.max(initial=0)), 2)
    want_hist = peel_mode == "range" and decrease_key == "bucket"

    def expand(st, peel, alive_prev, n_peel, tot):
        total1, total2 = tot
        if ((not stored and total1 > caps["cap1"])
                or (materialize and total2 > caps["cap2"])):
            return st.b, True, None, None
        alive = st.alive
        ids = _compact(peel, n_peel)
        if stored:
            # one stored-wedge row per peeled vertex
            u1_of, starts2 = ids, off_d[ids]
            roff2 = _prefix(off_d[ids + 1] - starts2)
        else:
            # level 1: peeled u1 -> centers v (materialized, at most m)
            ga = ids + base
            seg1, pos1, _, _ = expand_ragged(off_d[ga], deg_d[ga], total1)
            u1_of, v = ids[seg1], nbr_d[pos1]
            # level 2: centers v -> endpoints u2
            roff2, starts2 = _prefix(deg_d[v]), off_d[v]
        if materialize:
            bounds = [(0, total2)] if total2 else []
        else:
            roff_u = None
            if total2 > tile_cap:
                # tiles cut at peeled-vertex boundaries, planned on the
                # host from the per-u1 frontier prefix
                roff_u = np.asarray(_fetch(
                    st, [roff2 if stored else _prefix(work[1][ids])]))
            bounds = _tile_bounds(total2, tile_cap, roff_u)

        def tile_fn(bt, ts, te):
            wid = torch.arange(ts, te, device=bt.device)
            seg2, pos2 = ragged_slots_at(roff2, starts2, wid)
            u2 = nbr_d[pos2].long() - (0 if stored else base)
            return _subtract_tile(
                u1_of[seg2], u2, alive[u2], bt, alive,
                aggregation=aggregation, n_side=n_side, hash_bits=hash_bits,
                decrease_key=decrease_key, want_hist=want_hist,
            )

        b, mn, hist = _stream_tiles(st.b, alive, bounds, tile_fn,
                                    decrease_key=decrease_key,
                                    want_hist=want_hist)
        return b, False, mn, hist

    def shrink_caps():
        if not adaptive:
            return ()
        out = [(caps["cap2"], 1)] if materialize else []
        if not stored:
            out.append((caps["cap1"], 0))
        return tuple(out)

    def update_caps(st):
        # geometric shrink: re-enter with pow2-tightened capacities
        if not stored:
            caps["cap1"] = min(caps["cap1"], _pow2_pad(st.rem[0]))
        if materialize:
            caps["cap2"] = min(caps["cap2"], _pow2_pad(st.rem[1]))

    b0 = torch.tensor(counts, device=device)
    state = _init_state(b0, n_side, decrease_key=decrease_key,
                        peel_mode=peel_mode, lvl1=lvl1, lvl2=lvl2)
    st = _drive_segments(
        lambda s: _device_round_loop(s, expand, work,
                                     decrease_key=decrease_key,
                                     peel_mode=peel_mode,
                                     shrink_caps=shrink_caps()),
        state, adaptive, update_caps,
    )
    if audit is not None:
        audit.append((state.syncs, state.segments, state.lanes))
    if st is None:
        note.append(f"bounded frontier buffer overflow (max_frontier "
                    f"budget {budget})")
        return None
    return _result(st, side)


def _peel_tips_host(counts, side, n_side, frontier, work, aggregation,
                    hash_bits, subtract, tile_budget, peel_mode, device,
                    audit=None) -> PeelResult:
    """Host tip round loop (the bottom rung of PEEL-V and WPEEL-V): one
    counted fetch of the counts per round, the round's frontier wedge
    pairs from ``frontier(a_ids) -> (u1_w, u2_w)`` in numpy (ascending
    u1; ``work`` holds each vertex's frontier size), and the shared
    tile subtract on the device: u1-aligned tiles, or under
    ``subtract="materialize"`` one block."""
    tile_cap = None
    if subtract == "fused":
        tb = _budgets(None, tile_budget, 0)[1]
        tile_cap = _tip_tile_cap(tb, int(work.sum()),
                                 int(work.max(initial=0)), 1)
    alive = np.ones(n_side, dtype=bool)
    tip = np.zeros(n_side, dtype=counts.dtype)
    b_dev = torch.tensor(counts, device=device)
    kappa = 0
    acct = _RoundAccounting(peel_mode)
    while alive.any():
        cnt_host = b_dev.cpu().numpy()
        acct.syncs += 1
        cur = np.where(alive, cnt_host, np.iinfo(cnt_host.dtype).max)
        mn = int(cur.min())
        kappa = max(kappa, mn)
        acct.open_round(mn)
        a_ids = np.flatnonzero(alive & (cur <= kappa))
        tip[a_ids] = kappa
        alive[a_ids] = False
        acct.peeled(a_ids.size)
        if not alive.any():
            break
        u1_w, u2_w = frontier(a_ids)
        ok = alive[u2_w]  # keep wedges whose second endpoint is alive
        u1_w, u2_w = u1_w[ok], u2_w[ok]
        if u1_w.size == 0:
            continue
        b_dev = _host_subtract_frontier(b_dev, u1_w, u2_w, n_side,
                                        aggregation, hash_bits, tile_cap)
    if audit is not None:
        audit.append((acct.syncs, 0, 0))
    return acct.result(tip, side)


def _two_hop_frontier(off, nbr, base):
    """PEEL-V's frontier (GET-V-WEDGES): 2-hop re-enumeration from the
    peeled set."""

    def frontier(a_ids):
        ga = a_ids + base
        deg1 = off[ga + 1] - off[ga]
        u1_rep = np.repeat(a_ids, deg1)
        v_rep = nbr[_ranges(off[ga], deg1)]
        deg2 = off[v_rep + 1] - off[v_rep]
        return (np.repeat(u1_rep, deg2),
                nbr[_ranges(off[v_rep], deg2)] - base)

    return frontier


def _stored_frontier(woff, w_u2):
    """WPEEL-V's frontier: stored-wedge CSR lookup."""

    def frontier(a_ids):
        lens = woff[a_ids + 1] - woff[a_ids]
        return np.repeat(a_ids, lens), w_u2[_ranges(woff[a_ids], lens)]

    return frontier


def _check_engine(engine: str) -> None:
    if engine not in PEEL_ENGINES:
        raise ValueError(
            f"engine must be {'|'.join(PEEL_ENGINES)}, got {engine}"
        )


def _check_knobs(aggregation: str, subtract: str, decrease_key: str,
                 capacity_schedule: str, peel_mode: str = "exact",
                 distributed: dict = ()) -> None:
    """Reject unknown knob values (ValueError) and the reference's knobs
    this port does not run yet (NotImplementedError)."""
    if aggregation not in ("sort", "hash"):
        raise ValueError(
            f"peeling aggregation must be sort|hash, got {aggregation}"
        )
    if subtract not in PEEL_SUBTRACTS:
        raise ValueError(
            f"subtract must be {'|'.join(PEEL_SUBTRACTS)}, got {subtract}"
        )
    if decrease_key not in PEEL_DECREASE_KEYS:
        raise ValueError(
            f"decrease_key must be {'|'.join(PEEL_DECREASE_KEYS)}, "
            f"got {decrease_key}"
        )
    if capacity_schedule not in PEEL_SCHEDULES:
        raise ValueError(
            f"capacity_schedule must be {'|'.join(PEEL_SCHEDULES)}, "
            f"got {capacity_schedule}"
        )
    if peel_mode not in PEEL_MODES:
        raise ValueError(
            f"peel_mode must be {'|'.join(PEEL_MODES)}, got {peel_mode}"
        )
    for name, value in dict(distributed).items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= (the distributed rung) is {_NOT_PORTED}"
            )


class _RoundAccounting:
    """Host-loop round bookkeeping, the host mirror of the device loop's
    exact-vs-range accounting: exact mode opens one round per iteration;
    range mode opens a round only when the min leaves the active
    geometric bucket (the next range from the min's bit length)."""

    def __init__(self, peel_mode: str):
        self.range = peel_mode == "range"
        self.rounds = 0
        self.sub_rounds = 0
        self.sizes: list = []
        self.syncs = 0
        self._hi = 0

    def open_round(self, mn: int) -> None:
        """Called once per iteration with the pre-peel masked min."""
        self.sub_rounds += 1
        if self.range and mn < self._hi:
            return  # re-settle iteration inside the active bucket
        if self.range:
            self._hi = 1 << int(mn).bit_length()
        self.rounds += 1
        self.sizes.append(0)

    def peeled(self, k: int) -> None:
        self.sizes[-1] += int(k)

    def result(self, numbers, side) -> PeelResult:
        return PeelResult(numbers, side, self.rounds,
                          np.asarray(self.sizes, dtype=np.int64),
                          sub_rounds=self.sub_rounds)


def _peel_validator(counts: np.ndarray):
    """Result-invariant validator for the peeling ladders: every peel
    number is the κ of some round's masked min, so the numbers must be
    non-negative and at most the largest initial count. Checked on the
    host result, so a poisoned buffer or a truncated subtract descends
    to the next rung instead of escaping. Stands down when the initial
    counts are themselves negative."""
    counts = np.asarray(counts)
    if counts.size == 0 or int(counts.min()) < 0:
        return lambda res: None
    cmax = int(counts.max())

    def validate(res: "PeelResult") -> Optional[str]:
        nums = np.asarray(res.numbers)
        if nums.size == 0:
            return None
        lo, hi = int(nums.min()), int(nums.max())
        if lo < 0:
            return f"negative peel number {lo}"
        if hi > cmax:
            return f"peel number {hi} exceeds max initial count {cmax}"
        return None

    return validate


# public name: the same result-invariant check for callers that run the
# peeling ladders themselves
peel_validator = _peel_validator


def _capacity(max_frontier, tile_budget) -> tuple:
    return (
        ("max_frontier",
         _I32_MAX if max_frontier is None else int(max_frontier)),
        ("tile_budget",
         _DEFAULT_TILE_TARGET if tile_budget is None else int(tile_budget)),
    )


def _run_ladder(kind, policy, rungs, counts, plan, audit):
    """Run the rungs and record on the report what the round loops
    counted: host syncs and capacity segments summed over the attempts,
    and the largest round frontier."""
    out, report = _execute_ladder(kind, policy, rungs,
                                  _peel_validator(counts), plan=plan)
    report.host_syncs = sum(a[0] for a in audit)
    report.segments = sum(a[1] for a in audit)
    report.frontier_lanes = max((a[2] for a in audit), default=0)
    return policy.attach(out, report)


def _distributed_knobs(devices, checkpoint, round_deadline_s, deadline_s):
    return dict(devices=devices, checkpoint=checkpoint,
                round_deadline_s=round_deadline_s, deadline_s=deadline_s)


def peel_tips(
    g: BipartiteGraph,
    counts: Optional[np.ndarray] = None,
    side: Optional[int] = None,
    aggregation: str = "sort",
    count_kwargs: Optional[dict] = None,
    engine: str = "host",
    max_frontier: Optional[int] = None,
    hash_bits: Optional[int] = None,
    subtract: str = "fused",
    decrease_key: str = "bucket",
    capacity_schedule: str = "fixed",
    tile_budget: Optional[int] = None,
    peel_mode: str = "exact",
    devices=None,
    checkpoint=None,
    round_deadline_s: Optional[float] = None,
    deadline_s: Optional[float] = None,
    resilience=None,
    device=None,
) -> PeelResult:
    """Tip decomposition (PEEL-V, Alg. 5).

    Peels the bipartition producing fewer wedges-as-endpoints unless
    ``side`` is forced. ``counts`` are the peeled side's per-vertex
    butterfly counts (computed with ``count_butterflies(...,
    **count_kwargs)`` if omitted). ``engine="device"`` runs the round
    loop on the device with the ``bucket_update`` (``decrease_key=
    "bucket"``) or ``bucket_min`` (``"scatter"``) kernel; the host
    engine is always the ladder's bottom rung. ``max_frontier`` bounds
    the device engine's level-1 frontier, and under
    ``subtract="materialize"`` its whole frontier (overflow descends to
    host); ``hash_bits`` sizes the hash aggregation's table;
    ``subtract``, ``capacity_schedule``, ``tile_budget``, ``peel_mode``
    and the rest as in the module docstring. Every knob combination
    gives the same numbers. ``resilience`` selects the degradation
    policy; ``result.report`` records the rung path,
    ``report.host_syncs``, ``report.segments`` and
    ``report.frontier_lanes``. ``device=None`` means CUDA; pass
    ``device="cpu"`` for the host.
    """
    _check_engine(engine)
    _check_knobs(aggregation, subtract, decrease_key, capacity_schedule,
                 peel_mode, _distributed_knobs(devices, checkpoint,
                                               round_deadline_s, deadline_s))
    device = resolve_device(device)
    policy = _res.resolve_policy(resilience)
    hash_bits = _faults.hash_bits_override("peel_tips", hash_bits)
    side, counts = _side_and_counts(g, counts, side, count_kwargs, device)
    off, nbr, _ = _csr(g)
    n_side = g.n_u if side == 0 else g.n_v
    base = 0 if side == 0 else g.n_u
    # shared by the device planner and the host tile plan, so a
    # device -> host descent never recomputes them
    w2 = _level2_totals(off, nbr, base, n_side)
    audit: list = []

    def run_device(shrinks: int):
        _faults.maybe_oom("peel_tips.device")
        _faults.maybe_slow_rung("peel_tips.device")
        mf = _faults.capacity_override("peel_tips.device", max_frontier)
        c = _faults.maybe_poison("peel_tips.device",
                                 torch.from_numpy(counts)).numpy()
        notes: list = []
        res = _peel_tips_device_run(
            g, c, side, aggregation, False, mf, hash_bits, (off, nbr),
            subtract=subtract, decrease_key=decrease_key,
            capacity_schedule=capacity_schedule, tile_budget=tile_budget,
            w2=w2, peel_mode=peel_mode, budget_shrinks=shrinks, note=notes,
            audit=audit, device=device,
        )
        return _res.require_rung(res, notes)

    def run_host(shrinks: int):
        _faults.maybe_oom("peel_tips.host")
        _faults.maybe_slow_rung("peel_tips.host")
        return _peel_tips_host(counts, side, n_side,
                               _two_hop_frontier(off, nbr, base), w2,
                               aggregation, hash_bits, subtract, tile_budget,
                               peel_mode, device, audit)

    plan = _plan_peel(
        "peel_tips", expansion="peel_tips_2hop", engine=engine,
        aggregation=aggregation, n_out=n_side, dtype=counts.dtype.name,
        capacity=_capacity(max_frontier, tile_budget), hash_bits=hash_bits,
        entity_work=w2,
    )
    rungs = [_res.Rung("host", run_host, shrinkable=False)]
    if engine == "device":
        rungs.insert(0, _res.Rung("device", run_device))
    return _run_ladder("peel_tips", policy, rungs, counts, plan, audit)


def peel_tips_stored(
    g: BipartiteGraph,
    counts: Optional[np.ndarray] = None,
    side: Optional[int] = None,
    aggregation: str = "sort",
    count_kwargs: Optional[dict] = None,
    engine: str = "host",
    max_frontier: Optional[int] = None,
    hash_bits: Optional[int] = None,
    subtract: str = "fused",
    decrease_key: str = "bucket",
    capacity_schedule: str = "fixed",
    tile_budget: Optional[int] = None,
    peel_mode: str = "exact",
    devices=None,
    checkpoint=None,
    round_deadline_s: Optional[float] = None,
    deadline_s: Optional[float] = None,
    resilience=None,
    device=None,
) -> PeelResult:
    """WPEEL-V (paper Alg. 7): store all side-oriented wedges up front
    (``_stored_wedge_csr``, O(Σ deg²_side) space), then subtract each
    round by index lookups instead of a 2-hop re-enumeration: the
    paper's work/space trade-off. One orientation suffices: every
    butterfly on the peeled side is accounted by its wedge group at
    that side's endpoints (Lemma 4.2).

    Knobs as in :func:`peel_tips`. Under ``subtract="fused"`` the
    device engine recovers each tile straight from the stored-wedge CSR
    (no per-round frontier buffer), so ``max_frontier`` and capacity
    overflow only apply to ``subtract="materialize"``. The device engine
    holds the stored wedges on the card as int32, 4 bytes each.
    """
    _check_engine(engine)
    _check_knobs(aggregation, subtract, decrease_key, capacity_schedule,
                 peel_mode, _distributed_knobs(devices, checkpoint,
                                               round_deadline_s, deadline_s))
    device = resolve_device(device)
    policy = _res.resolve_policy(resilience)
    hash_bits = _faults.hash_bits_override("peel_tips_stored", hash_bits)
    side, counts = _side_and_counts(g, counts, side, count_kwargs, device)
    n_side = g.n_u if side == 0 else g.n_v
    woff, w_u2 = _stored_wedge_csr(g, side)
    audit: list = []

    def run_device(shrinks: int):
        _faults.maybe_oom("peel_tips_stored.device")
        _faults.maybe_slow_rung("peel_tips_stored.device")
        mf = _faults.capacity_override("peel_tips_stored.device",
                                       max_frontier)
        c = _faults.maybe_poison("peel_tips_stored.device",
                                 torch.from_numpy(counts)).numpy()
        notes: list = []
        res = _peel_tips_device_run(
            g, c, side, aggregation, True, mf, hash_bits, (woff, w_u2),
            subtract=subtract, decrease_key=decrease_key,
            capacity_schedule=capacity_schedule, tile_budget=tile_budget,
            peel_mode=peel_mode, budget_shrinks=shrinks, note=notes,
            audit=audit, device=device,
        )
        return _res.require_rung(res, notes)

    def run_host(shrinks: int):
        _faults.maybe_oom("peel_tips_stored.host")
        _faults.maybe_slow_rung("peel_tips_stored.host")
        return _peel_tips_host(counts, side, n_side,
                               _stored_frontier(woff, w_u2), np.diff(woff),
                               aggregation, hash_bits, subtract, tile_budget,
                               peel_mode, device, audit)

    plan = _plan_peel(
        "peel_tips_stored", expansion="peel_tips_stored", engine=engine,
        aggregation=aggregation, n_out=n_side, dtype=counts.dtype.name,
        capacity=_capacity(max_frontier, tile_budget)
        + (("stored_wedges", int(woff[-1])),),
        hash_bits=hash_bits, entity_work=np.diff(woff),
    )
    rungs = [_res.Rung("host", run_host, shrinkable=False)]
    if engine == "device":
        rungs.insert(0, _res.Rung("device", run_device))
    return _run_ladder("peel_tips_stored", policy, rungs, counts, plan,
                       audit)


# ---------------------------------------------------------------------------
# Device wing engine (PEEL-E): butterfly triples recovered from flat ids
# ---------------------------------------------------------------------------


def _wing_work_totals(g: BipartiteGraph, off: np.ndarray, nbr: np.ndarray):
    """Per-edge wing expansion totals: for each edge ``a = (u1, v1)``,
    ``l1[a] = deg(v1)`` and ``l2[a] = Σ_{u2 in N(v1)} min(deg(u1),
    deg(u2))``, the candidate triple space the device engine streams
    (the ``u2 == u1`` slot included; its lanes mask out). Returns
    ``(eu, ev, l1, l2)``: endpoints in global ids, totals int64."""
    deg = np.diff(off)
    eu = g.edges[:, 0].astype(np.int64)
    ev = (g.edges[:, 1] + g.n_u).astype(np.int64)
    l1 = deg[ev]
    l2 = np.zeros(g.m, dtype=np.int64)
    if int(l1.sum()):
        a_rep = np.repeat(np.arange(g.m), l1)
        u2 = nbr[_ranges(off[ev], l1)]
        np.add.at(l2, a_rep, np.minimum(deg[eu[a_rep]], deg[u2]))
    return eu, ev, l1, l2


def _peel_wings_device_run(g, counts, aggregation, max_frontier, hash_bits,
                           csr, *, subtract="fused", decrease_key="bucket",
                           capacity_schedule="fixed", tile_budget=None,
                           peel_mode="exact", budget_shrinks=0, note=None,
                           w_totals=None, audit=None,
                           device=None) -> Optional[PeelResult]:
    """Plan and run the device wing loop. Returns None when the device
    engine does not apply (no edges, counts or expansion totals beyond
    int32) or, under ``subtract="materialize"``, a round's frontier
    exceeded a ``max_frontier``-derived capacity; the ladder then
    descends to the host loop. The loop's ``(host syncs, segments,
    largest frontier)`` are appended to ``audit``.

    A round's flat triple space is the prefix of the static per-edge
    totals ``l2`` over the peel set. A flat id inverts in O(log) per
    lane: (1) the prefix locates the peeled edge a = (u1, v1) and the
    offset inside its space; (2) in v1's row of the degree-sorted CSR
    the candidates u2 with ``deg(u2) < deg(u1)`` form a prefix whose
    ragged inner sizes are read from the neighbor-degree prefix (one
    binary search), and every later candidate scans exactly ``deg(u1)``
    centers (one division). Each binary search is one
    ``torch.searchsorted`` over a globally sorted key (the row id times
    a stride plus the in-row value), so no ragged search loop runs.
    ``subtract="fused"`` streams that space in tiles of ``tile_cap``
    lanes; ``"materialize"`` takes the whole of it as one tile. Its
    capacities bound what the reference's materializing buffers hold:
    the level-1 candidates (``l1`` over the peel set) and the level-2
    scans of the candidates that survive the presence test, which the
    loop counts on the device (one more sync) only when the round's
    triple space exceeds that capacity."""
    note = [] if note is None else note
    off, nbr, uid = csr
    m, n = g.m, g.n
    if m == 0 or int(counts.max(initial=0)) >= _I32_MAX:
        note.append("device engine unavailable: no edges or counts "
                    "beyond int32")
        return None
    if 2 * m >= _I32_MAX:
        note.append("device engine unavailable: edge slots beyond int32")
        return None
    eu, ev, l1, l2 = (
        _wing_work_totals(g, off, nbr) if w_totals is None else w_totals
    )
    lvl1, lvl2 = int(l1.sum()), int(l2.sum())
    if lvl1 >= _I32_MAX or lvl2 >= _I32_MAX:
        note.append("device engine unavailable: expansion totals beyond "
                    "int32 indexing")
        return None
    materialize = subtract == "materialize"
    adaptive = capacity_schedule == "adaptive"
    nbr_ds, uid_ds, degs_ds, cumdeg = degree_sorted_csr(off, nbr, uid)
    if (not materialize and cumdeg.size
            and int((cumdeg + degs_ds).max(initial=0)) >= _I32_MAX):
        note.append("device engine unavailable: degree-sorted prefixes "
                    "beyond int32 indexing")
        return None
    budget, tb = _budgets(max_frontier, tile_budget, budget_shrinks)
    caps = {"cap1": _pow2_pad(min(lvl1, budget)),
            "cap2": _pow2_pad(min(lvl2, budget))}
    tile_cap = _pow2_pad(min(tb, max(lvl2, 1)))
    want_hist = peel_mode == "range" and decrease_key == "bucket"
    deg = np.diff(off)
    src = np.repeat(np.arange(n), deg)
    stride = int(deg.max(initial=0)) + 1

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64),
                               device=device)

    off_d, nbr_d, uid_d, deg_d = dev(off), dev(nbr), dev(uid), dev(deg)
    eu_d, ev_d = dev(eu), dev(ev)
    nbr_ds_d, uid_ds_d = dev(nbr_ds), dev(uid_ds)
    # globally sorted search keys: CSR membership (row, neighbor), the
    # degree split (row, neighbor degree) and the global exclusive
    # prefix of neighbor degrees (in-row prefix = G[p] - G[row start])
    comp_d = dev(src * n + nbr)
    degkey_d = dev(src * stride + degs_ds)
    gpre_d = dev(np.concatenate([[0], np.cumsum(degs_ds)]))
    slot_max = 2 * m - 1

    # per-edge level-1 candidates and triple-space sizes
    work = torch.stack([dev(l1), dev(l2)])

    def expand(st, peel, alive_prev, n_peel, tot):
        total1, total = tot
        alive = st.alive
        ids = _compact(peel, n_peel)

        def present(x, a):
            return alive_prev[x] & (~peel[x] | (x > a))

        if materialize:
            if total1 > caps["cap1"] or (
                    total > caps["cap2"]
                    and _fetch(st, [level2_total(ids, total1, present)])[0]
                    > caps["cap2"]):
                return st.b, True, None, None
            bounds = [(0, total)] if total else []
        else:
            bounds = _tile_bounds(total, tile_cap)
        roff = _prefix(work[1][ids])

        def tile_fn(bt, ts, te):
            wid = torch.arange(ts, te, device=bt.device)
            seg, tp = ragged_slots_at(roff, torch.zeros_like(roff[:-1]),
                                      wid)
            a2 = ids[seg]
            u1, v1 = eu_d[a2], ev_d[a2]
            d1 = deg_d[u1]
            rs = off_d[v1]
            # split N(v1) (degree-sorted) at deg(u2) >= deg(u1)
            q = torch.searchsorted(degkey_d, v1 * stride + d1)
            g_rs = gpre_d[rs]
            head = gpre_d[q] - g_rs
            in_head = tp < head
            # head: ragged inner sizes from the neighbor-degree prefix
            p_head = torch.minimum(
                torch.searchsorted(gpre_d, g_rs + tp + 1), q) - 1
            # tail: deg(u1)-sized blocks, pure arithmetic
            r_tail = tp - head
            d1s = torch.clamp(d1, min=1)
            j_tail = r_tail // d1s
            p1 = torch.clamp(torch.where(in_head, p_head, q + j_tail),
                             0, slot_max)
            i = torch.where(in_head, tp - (gpre_d[p1] - g_rs),
                            r_tail - j_tail * d1s)
            u2 = nbr_ds_d[p1]
            b_2 = uid_ds_d[p1]
            kp = (u2 != u1) & present(b_2, a2)
            si = d1 <= deg_d[u2]
            small = torch.where(si, u1, u2)
            oth = torch.where(si, u2, u1)
            i = torch.minimum(torch.clamp(i, min=0),
                              torch.clamp(deg_d[small] - 1, min=0))
            pos2 = torch.clamp(off_d[small] + i, 0, slot_max)
            v2 = nbr_d[pos2]
            e_small = uid_d[pos2]
            # membership: (other, v2) must be an edge
            key = oth * n + v2
            p = torch.clamp(torch.searchsorted(comp_d, key), max=slot_max)
            hit = comp_d[p] == key
            e_other = uid_d[p]
            # c = (u1, v2), d = (u2, v2): map small/other back
            c_edge = torch.where(si, e_small, e_other)
            d_edge = torch.where(si, e_other, e_small)
            ok = (kp & hit & (v2 != v1) & present(c_edge, a2)
                  & present(d_edge, a2))
            return _subtract_edge_groups(
                torch.cat([b_2, c_edge, d_edge]), torch.cat([ok, ok, ok]),
                bt, alive, aggregation=aggregation, m=m,
                hash_bits=hash_bits, decrease_key=decrease_key,
                want_hist=want_hist,
            )

        b, mn, hist = _stream_tiles(
            st.b, alive, bounds, tile_fn,
            decrease_key=decrease_key, want_hist=want_hist,
        )
        return b, False, mn, hist

    def level2_total(ids, total1, present):
        """The reference's materialized level-2 size: per level-1
        candidate (a, u2 in N(v1)) that is not a itself and is present,
        min(deg(u1), deg(u2)) centers to scan."""
        v1 = ev_d[ids]
        seg, pos1, _, _ = expand_ragged(off_d[v1], deg_d[v1], total1)
        a1 = ids[seg]
        u1, u2 = eu_d[a1], nbr_d[pos1]
        keep = (u2 != u1) & present(uid_d[pos1], a1)
        return torch.where(keep, torch.minimum(deg_d[u1], deg_d[u2]),
                           0).sum()

    def shrink_caps():
        if not (adaptive and materialize):
            return ()
        return ((caps["cap1"], 0), (caps["cap2"], 1))

    def update_caps(st):
        if materialize:
            caps["cap1"] = min(caps["cap1"], _pow2_pad(st.rem[0]))
            caps["cap2"] = min(caps["cap2"], _pow2_pad(st.rem[1]))

    b0 = torch.tensor(counts, device=device)
    state = _init_state(b0, m, decrease_key=decrease_key,
                        peel_mode=peel_mode, lvl1=lvl1, lvl2=lvl2)
    st = _drive_segments(
        lambda s: _device_round_loop(s, expand, work,
                                     decrease_key=decrease_key,
                                     peel_mode=peel_mode,
                                     shrink_caps=shrink_caps()),
        state, adaptive, update_caps,
    )
    if audit is not None:
        audit.append((state.syncs, state.segments, state.lanes))
    if st is None:
        note.append(f"bounded frontier buffer overflow (max_frontier "
                    f"budget {budget})")
        return None
    return _result(st, None)




def _peel_wings_host(g, counts, off, nbr, uid, peel_mode, device,
                     audit=None) -> PeelResult:
    """Host wing round loop (PEEL-E's bottom rung): per-butterfly triple
    location in numpy via min-degree-side intersections and
    binary-search edge membership, subtracted on the device. While the
    counts fit int32 the round's extract-min is the ``bucket_min``
    kernel (on the card), fetched with the counts in one copy."""
    n, m = g.n, g.m
    # lexsorted composite keys for edge-membership binary search
    src = np.repeat(np.arange(n), np.diff(off))
    comp = src * np.int64(n) + nbr
    deg = np.diff(off)
    eu = g.edges[:, 0].astype(np.int64)
    ev = (g.edges[:, 1] + g.n_u).astype(np.int64)
    # bucket_min reduces in int32: counts at/above INT32_MAX would alias
    # its empty sentinel, so such graphs keep the host min
    kernel_min = int(counts.max(initial=0)) < _I32_MAX

    alive = np.ones(m, dtype=bool)
    wing = np.zeros(m, dtype=counts.dtype)
    b_dev = torch.tensor(counts, device=device)
    kappa = 0
    acct = _RoundAccounting(peel_mode)
    while alive.any():
        if kernel_min:
            mn_dev = _kops.bucket_min(b_dev, torch.as_tensor(alive).to(device))
            both = torch.cat([mn_dev.to(b_dev.dtype).reshape(1), b_dev])
            both = both.cpu().numpy()
            mn, cnt_host = int(both[0]), both[1:]
        else:
            cnt_host = b_dev.cpu().numpy()
            mn = int(np.where(alive, cnt_host,
                              np.iinfo(cnt_host.dtype).max).min())
        acct.syncs += 1
        kappa = max(kappa, mn)
        acct.open_round(mn)
        a_ids = np.flatnonzero(alive & (cnt_host <= kappa))
        wing[a_ids] = kappa
        in_a = np.zeros(m, dtype=bool)
        in_a[a_ids] = True
        acct.peeled(a_ids.size)

        # presence of edge x w.r.t. peeled edge a (ids break ties):
        #   alive_before[x] and (x not in A or x > a)
        def present(x, a):
            return alive[x] & (~in_a[x] | (x > a))

        # level 1: (a=(u1,v1), u2 in N(v1))
        u1s, v1s = eu[a_ids], ev[a_ids]
        d1 = deg[v1s]
        a_rep = np.repeat(a_ids, d1)
        u1_rep = np.repeat(u1s, d1)
        v1_rep = np.repeat(v1s, d1)
        pos_b = _ranges(off[v1s], d1)
        u2_rep = nbr[pos_b]
        b_edge = uid[pos_b]
        keep = (u2_rep != u1_rep) & present(b_edge, a_rep)
        a_rep, u1_rep, v1_rep, u2_rep, b_edge = (
            a_rep[keep], u1_rep[keep], v1_rep[keep], u2_rep[keep],
            b_edge[keep],
        )
        if a_rep.size:
            # level 2: scan the smaller of N(u1), N(u2)
            small_is_u1 = deg[u1_rep] <= deg[u2_rep]
            small = np.where(small_is_u1, u1_rep, u2_rep)
            other = np.where(small_is_u1, u2_rep, u1_rep)
            d2 = deg[small]
            a2 = np.repeat(a_rep, d2)
            v1_2 = np.repeat(v1_rep, d2)
            b_2 = np.repeat(b_edge, d2)
            oth2 = np.repeat(other, d2)
            pos_s = _ranges(off[small], d2)
            v2 = nbr[pos_s]
            e_small = uid[pos_s]
            # membership: (other, v2) must be an edge
            key = oth2 * np.int64(n) + v2
            p = np.minimum(np.searchsorted(comp, key), comp.shape[0] - 1)
            hit = comp[p] == key
            e_other = uid[p]
            # c = (u1, v2), d = (u2, v2): map small/other back
            si2 = np.repeat(small_is_u1, d2)
            c_edge = np.where(si2, e_small, e_other)
            d_edge = np.where(si2, e_other, e_small)
            ok = (hit & (v2 != v1_2) & present(c_edge, a2)
                  & present(d_edge, a2))
            tri = np.stack([b_2, c_edge, d_edge], axis=1)[ok].ravel()
            if tri.size:
                b_dev.index_add_(
                    0, torch.as_tensor(tri, device=device),
                    torch.full((tri.size,), -1, dtype=b_dev.dtype,
                               device=device),
                )
        alive[a_ids] = False
    if audit is not None:
        audit.append((acct.syncs, 0, 0))
    return acct.result(wing, None)


def peel_wings(
    g: BipartiteGraph,
    counts: Optional[np.ndarray] = None,
    count_kwargs: Optional[dict] = None,
    engine: str = "host",
    aggregation: str = "sort",
    max_frontier: Optional[int] = None,
    hash_bits: Optional[int] = None,
    subtract: str = "fused",
    decrease_key: str = "bucket",
    capacity_schedule: str = "fixed",
    tile_budget: Optional[int] = None,
    peel_mode: str = "exact",
    devices=None,
    checkpoint=None,
    round_deadline_s: Optional[float] = None,
    deadline_s: Optional[float] = None,
    resilience=None,
    device=None,
) -> PeelResult:
    """Wing decomposition (PEEL-E, Alg. 6).

    Butterflies incident to peeled edges are located individually via
    min-degree-side intersections, matching the paper's
    Σ min(deg(u), deg(u')) work bound. ``engine="host"`` keeps the
    numpy round loop with the ``bucket_min`` kernel as its extract-min;
    ``engine="device"`` recovers each round's triples on the device from
    flat ids (see ``_peel_wings_device_run``) and subtracts through
    ``bucket_update`` or a scatter. ``aggregation``/``hash_bits`` select
    the device engine's grouped edge subtract (the host engine's raw
    triple scatter gives the same sums). ``max_frontier`` bounds only
    ``subtract="materialize"``: the fused device engine keeps no
    frontier buffer. Other knobs as in :func:`peel_tips`; every
    combination gives the same numbers.
    """
    _check_engine(engine)
    _check_knobs(aggregation, subtract, decrease_key, capacity_schedule,
                 peel_mode, _distributed_knobs(devices, checkpoint,
                                               round_deadline_s, deadline_s))
    device = resolve_device(device)
    policy = _res.resolve_policy(resilience)
    hash_bits = _faults.hash_bits_override("peel_wings", hash_bits)
    if counts is None:
        r = count_butterflies(
            g, mode="edge", count_dtype=default_count_dtype(),
            device=device, **(count_kwargs or {})
        )
        counts = r.per_edge
    counts = np.asarray(counts).copy()
    off, nbr, uid = _csr(g)
    w_totals = _wing_work_totals(g, off, nbr)
    audit: list = []

    def run_device(shrinks: int):
        _faults.maybe_oom("peel_wings.device")
        _faults.maybe_slow_rung("peel_wings.device")
        mf = _faults.capacity_override("peel_wings.device", max_frontier)
        c = _faults.maybe_poison("peel_wings.device",
                                 torch.from_numpy(counts)).numpy()
        notes: list = []
        res = _peel_wings_device_run(
            g, c, aggregation, mf, hash_bits, (off, nbr, uid),
            subtract=subtract, decrease_key=decrease_key,
            capacity_schedule=capacity_schedule, tile_budget=tile_budget,
            peel_mode=peel_mode, budget_shrinks=shrinks, note=notes,
            w_totals=w_totals, audit=audit, device=device,
        )
        return _res.require_rung(res, notes)

    def run_host(shrinks: int):
        _faults.maybe_oom("peel_wings.host")
        _faults.maybe_slow_rung("peel_wings.host")
        return _peel_wings_host(g, counts, off, nbr, uid, peel_mode, device,
                                audit)

    plan = _plan_peel(
        "peel_wings", expansion="peel_wings_triples", engine=engine,
        aggregation=aggregation, n_out=g.m, dtype=counts.dtype.name,
        capacity=_capacity(max_frontier, tile_budget), hash_bits=hash_bits,
        entity_work=w_totals[3],
    )
    rungs = [_res.Rung("host", run_host, shrinkable=False)]
    if engine == "device":
        rungs.insert(0, _res.Rung("device", run_device))
    return _run_ladder("peel_wings", policy, rungs, counts, plan, audit)
