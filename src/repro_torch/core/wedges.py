"""Vectorized rank-filtered wedge retrieval (paper Alg. 2 GET-WEDGES).

The paper's nested parallel-for over (vertex, neighbor, 2nd-neighbor) is
a *flat wedge index space*:

  - every directed edge slot ``e = (x1 -> y)`` contributes
    ``cnt[e] = |{x2 in N(y) : rank(x2) > rank(x1)}|`` wedges when
    ``rank(y) > rank(x1)`` (and 0 otherwise),
  - a global prefix sum over ``cnt`` assigns each wedge a dense id
    ``w in [0, W)``,
  - wedge ``w`` is materialized with two gathers and one binary search:
    ``e = upper_bound(w_off, w) - 1``, ``j = w - w_off[e]``.

``direction="low"`` iterates from the lowest-ranked endpoint (paper
default); ``direction="high"`` iterates from the highest-ranked endpoint
(the Wang et al. cache optimization, paper §3.1.4): the wedge *set* is
identical, the access pattern differs.

Every count path plans and runs from one :class:`PreparedGraph`
(:func:`prepare`): the host ``RankedGraph``, its ``DeviceGraph`` and the
per-slot wedge counts of one ``slot_wedge_counts`` pass on that graph's
device, with one copy to the host. The host planners
(``greedy_vertex_blocks``, ``plan_wedge_chunks``, ``degree_sorted_csr``)
are numpy and identical to the reference package's, so plans compare
field for field; they take the per-slot wedge counts from their caller
and read per-vertex loads from :func:`wedge_prefix`. The numpy
``host_wedge_counts`` is the tests' oracle for the pass. The device
side is PyTorch on the tensors of a :class:`DeviceGraph`. Flat wedge
ids and wedge fields are int64 tensors.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .graph import BipartiteGraph, RankedGraph, build_csr, ranked_from_csr

__all__ = [
    "DeviceGraph",
    "PreparedGraph",
    "Wedges",
    "DEFAULT_CHUNK_BUDGET",
    "auto_chunk_budget",
    "shrink_budget",
    "device_graph",
    "preprocess_device",
    "prepare",
    "slot_wedge_counts",
    "host_wedge_counts",
    "wedge_offsets",
    "wedge_prefix",
    "wedges_at",
    "gather_wedges",
    "degree_sorted_csr",
    "greedy_vertex_blocks",
    "plan_wedge_chunks",
    "ragged_slots_at",
    "aligned_tile_end",
    "expand_ragged",
]

# Streaming/tile wedge budget used off the card (the reference package's
# documented default, so CPU plans equal the reference's): 2^18 wedges.
DEFAULT_CHUNK_BUDGET = 1 << 18

# Per-wedge working-set estimate for one live tile (the reference's
# figure): six wedge vectors plus roughly one same-sized copy for the
# aggregation temporaries, rounded to 64 bytes.
_BYTES_PER_WEDGE = 64


@functools.lru_cache(maxsize=None)
def auto_chunk_budget(
    device: torch.device,
    fraction: float = 0.125,
    default: int = DEFAULT_CHUNK_BUDGET,
    lo: int = 1 << 14,
    hi: int = 1 << 24,
) -> int:
    """Derive the streaming/tile wedge budget (``max_chunk="auto"``):
    on a CUDA device, a ``fraction`` of its free bytes
    (``torch.cuda.mem_get_info``) divided by the per-wedge working-set
    estimate, clamped to [lo, hi] and quantized down to a power of two;
    on any other device the documented ``DEFAULT_CHUNK_BUDGET``.

    The reading is snapshotted once per process and device (lru_cache)
    so plans do not wobble with live allocator state."""
    device = torch.device(device)
    if device.type != "cuda":
        return default
    free, _total = torch.cuda.mem_get_info(device)
    raw = int(min(hi, max(lo, (int(free) * fraction) // _BYTES_PER_WEDGE)))
    return 1 << (raw.bit_length() - 1)


def shrink_budget(budget: int, shrinks: int, floor: int = 128) -> int:
    """Halve ``budget`` ``shrinks`` times, floored: the resilience
    ladder's RESOURCE_EXHAUSTED re-entry schedule."""
    return max(int(floor), int(budget) >> max(0, int(shrinks)))


@dataclasses.dataclass
class DeviceGraph:
    """RankedGraph CSR arrays on a device: int32 tensors, ``side_of``
    int8. ``n`` and ``m`` are the real vertex / undirected edge
    counts."""

    offsets: torch.Tensor  # (n_pad + 1,)
    neighbors: torch.Tensor  # (e_pad,)
    edge_src: torch.Tensor  # (e_pad,)
    undirected_id: torch.Tensor  # (e_pad,)
    side_of: torch.Tensor  # (n_pad,) int8
    n: int
    m: int

    @property
    def n_pad(self) -> int:
        return int(self.side_of.shape[0])

    @property
    def e_pad(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def device(self) -> torch.device:
        return self.neighbors.device


def device_graph(rg: RankedGraph, device) -> DeviceGraph:
    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return DeviceGraph(
        offsets=put(rg.offsets, torch.int32),
        neighbors=put(rg.neighbors, torch.int32),
        edge_src=put(rg.edge_src, torch.int32),
        undirected_id=put(rg.undirected_id, torch.int32),
        side_of=put(rg.side_of, torch.int8),
        n=rg.n,
        m=rg.m,
    )


def preprocess_device(g: BipartiteGraph, order, order_name: str,
                      device) -> tuple[RankedGraph, DeviceGraph]:
    """PREPROCESS on ``device`` (``graph.build_csr``), kept there: the
    host :class:`RankedGraph` from one copy of the build's buffer, and
    the :class:`DeviceGraph` of views into that buffer, equal tensor for
    tensor to ``device_graph(rg, device)`` without its upload."""
    csr = build_csr(g, order, device=device)
    f = csr.fields()
    dg = DeviceGraph(
        offsets=f["offsets"],
        neighbors=f["neighbors"],
        edge_src=f["edge_src"],
        undirected_id=f["undirected_id"],
        side_of=f["side_of"].to(torch.int8),
        n=g.n,
        m=g.m,
    )
    return ranked_from_csr(g, csr, order_name), dg


class Wedges(NamedTuple):
    """A batch of wedges (x1, x2, y): endpoints x1 < x2, center y.

    ``center_slot`` is the directed-edge slot of (x1 -> y) under
    ``direction="low"`` (resp. (x2 -> y) under "high");
    ``second_slot`` is the neighbor-array position of x2 within N(y)
    (resp. x1), i.e. the directed edge (y -> x2). Both index
    ``undirected_id`` for per-edge butterfly scatter. ``valid`` masks
    padding lanes, whose x1, x2 and y hold the ``n_pad`` sentinel.
    All fields int64 except the bool ``valid``.
    """

    x1: torch.Tensor
    x2: torch.Tensor
    y: torch.Tensor
    center_slot: torch.Tensor
    second_slot: torch.Tensor
    valid: torch.Tensor


def slot_wedge_counts(dg: DeviceGraph, direction: str = "low") -> torch.Tensor:
    """Per directed-edge-slot wedge counts on the device, int64 (e_pad,).

    The CSR is globally sorted by (src, dst), so the per-row
    upper/lower bound of the reference's ragged binary search is one
    ``searchsorted`` on the composite key ``src * (n_pad + 1) + dst``
    (padding slots hold the ``n_pad`` sentinel and sort last)."""
    n_pad1 = dg.n_pad + 1
    src = dg.edge_src.long()
    dst = dg.neighbors.long()
    off = dg.offsets.long()
    comp = src * n_pad1 + dst
    y = torch.clamp(dst, max=dg.n_pad - 1)
    real = (src < dg.n) & (dst < dg.n)
    if direction == "low":
        # e = (x1 -> y), need rank(y) > rank(x1); eligible x2 in N(y)
        # with x2 > x1: suffix of the ascending adjacency list.
        eligible = real & (dst > src)
        ub = torch.searchsorted(comp, dst * n_pad1 + src, right=True)
        cnt = off[y + 1] - ub
    elif direction == "high":
        # e = (x2 -> y) from the highest endpoint: eligible x1 in N(y)
        # with x1 < min(src, dst): prefix of the adjacency list.
        eligible = real
        lb = torch.searchsorted(comp, dst * n_pad1 + torch.minimum(src, dst))
        cnt = lb - off[y]
    else:
        raise ValueError(f"direction must be low|high, got {direction}")
    return torch.where(eligible, cnt, torch.zeros_like(cnt))


def host_wedge_counts(rg: RankedGraph, direction: str = "low") -> np.ndarray:
    """Numpy mirror of slot_wedge_counts: the tests' oracle for the
    pass of :func:`prepare`, element for element the same. No module of
    the program calls it; every count path plans from its prepared
    graph's ``host`` copy.

    Vectorized via composite keys: CSR entries are globally lexsorted by
    (src, dst), so a per-slice searchsorted is a global searchsorted on
    ``src * n_pad1 + dst``.
    """
    src = rg.edge_src.astype(np.int64)
    dst = rg.neighbors.astype(np.int64)
    n_real = 2 * rg.m
    n_pad1 = np.int64(rg.n_pad + 1)
    off = rg.offsets.astype(np.int64)
    comp = src[:n_real] * n_pad1 + dst[:n_real]  # ascending
    s, d = src[:n_real], dst[:n_real]
    cnt = np.zeros(src.shape[0], dtype=np.int64)
    if direction == "low":
        # |{x2 in N(y) : x2 > x1}| for slots with y > x1
        ub = np.searchsorted(comp, d * n_pad1 + s, side="right")
        cnt[:n_real] = np.where(d > s, off[np.minimum(d, rg.n_pad - 1) + 1] - ub, 0)
    else:
        lb = np.searchsorted(comp, d * n_pad1 + np.minimum(s, d), side="left")
        cnt[:n_real] = lb - off[np.minimum(d, rg.n_pad - 1)]
    return cnt


def wedge_offsets(cnt: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over per-slot wedge counts: int64 (e_pad + 1,)."""
    return torch.cat([cnt.new_zeros(1, dtype=torch.int64),
                      torch.cumsum(cnt, 0, dtype=torch.int64)])


def wedge_prefix(offsets: np.ndarray, wv_slots: np.ndarray):
    """The host wedge prefixes of per-slot wedge counts ``wv_slots``
    (int64 (e_pad,)): ``(w_off, voff)``, with ``w_off`` the exclusive
    prefix over slots, int64 (e_pad + 1,) (:func:`wedge_offsets` on the
    host), and ``voff = w_off[offsets]``, int64 (n_pad + 1,): the flat
    id of each vertex's first wedge, so ``voff[v + 1] - voff[v]`` is
    vertex ``v``'s wedge load as iterating endpoint (padding slots
    count 0 and padding vertices start at ``2m``)."""
    w_off = np.zeros(wv_slots.shape[0] + 1, dtype=np.int64)
    np.cumsum(wv_slots, out=w_off[1:])
    return w_off, w_off[np.asarray(offsets, np.int64)]


class PreparedGraph(NamedTuple):
    """A graph ready to count: the host :class:`RankedGraph` the
    planners and ``interpret_counts`` read, its :class:`DeviceGraph`,
    and the per-slot wedge counts of ``direction`` from one
    :func:`slot_wedge_counts` pass, ``cnt`` on ``dg``'s device and
    ``host`` its one numpy copy."""

    rg: RankedGraph
    dg: DeviceGraph
    direction: str
    cnt: torch.Tensor  # int64 (e_pad,)
    host: np.ndarray  # int64 (e_pad,)


def prepare(rg: RankedGraph, dg: DeviceGraph,
            direction: str) -> PreparedGraph:
    """One :func:`slot_wedge_counts` pass on ``dg``, the device graph of
    ``rg``, and one copy of its counts to the host. The caller says
    where ``dg`` comes from: the CSR build on the count's device
    (:func:`preprocess_device`) or an upload (:func:`device_graph`)."""
    cnt = slot_wedge_counts(dg, direction)
    return PreparedGraph(rg, dg, direction, cnt, cnt.cpu().numpy())


def wedges_at(
    dg: DeviceGraph,
    cnt: Optional[torch.Tensor],
    w_off: torch.Tensor,
    wid: torch.Tensor,
    valid: torch.Tensor,
    direction: str = "low",
) -> Wedges:
    """Materialize wedges for an arbitrary array of flat wedge ids
    (binary search of ``w_off``, then CSR gathers). ``cnt`` may be None:
    per-slot wedge counts are then recovered as w_off[e+1] - w_off[e].
    Invalid lanes get the ``n_pad`` sentinel endpoints."""
    total = int(w_off[-1])
    wc = torch.clamp(wid.long(), 0, max(total - 1, 0))
    e = torch.searchsorted(w_off, wc, right=True) - 1
    e = torch.clamp(e, 0, dg.e_pad - 1)
    j = wc - w_off[e]
    cnt_e = (w_off[e + 1] - w_off[e]) if cnt is None else cnt[e]
    nbr = dg.neighbors.long()
    y = nbr[e]
    y_safe = torch.clamp(y, max=dg.n_pad - 1)
    off = dg.offsets.long()
    if direction == "low":
        x1 = dg.edge_src[e].long()
        # eligible x2 = suffix of N(y) of length cnt[e]
        pos = off[y_safe + 1] - cnt_e + j
        x2 = nbr[torch.clamp(pos, 0, dg.e_pad - 1)]
    elif direction == "high":
        x2 = dg.edge_src[e].long()
        # eligible x1 = prefix of N(y) of length cnt[e]
        pos = off[y_safe] + j
        x1 = nbr[torch.clamp(pos, 0, dg.e_pad - 1)]
    else:
        raise ValueError(f"direction must be low|high, got {direction}")
    pos = torch.clamp(pos, 0, dg.e_pad - 1)
    sent = torch.full_like(x1, dg.n_pad)
    last = torch.full_like(e, dg.e_pad - 1)
    return Wedges(
        x1=torch.where(valid, x1, sent),
        x2=torch.where(valid, x2, sent),
        y=torch.where(valid, y, sent),
        center_slot=torch.where(valid, e, last),
        second_slot=torch.where(valid, pos, last),
        valid=valid,
    )


def gather_wedges(
    dg: DeviceGraph,
    cnt: torch.Tensor,
    w_cap: int,
    direction: str = "low",
) -> Wedges:
    """Materialize the flat wedge space into a (w_cap,) batch."""
    w_off = wedge_offsets(cnt)
    wid = torch.arange(w_cap, dtype=torch.int64, device=cnt.device)
    valid = wid < w_off[-1]
    return wedges_at(dg, cnt, w_off, wid, valid, direction)


def degree_sorted_csr(
    off: np.ndarray, nbr: np.ndarray, uid: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Re-sort every CSR row by neighbor degree and attach the in-row
    neighbor-degree prefix: the O(m)-space index the fused wing
    subtract recovers its per-butterfly triple space from.

    Returns ``(nbr_ds, uid_ds, degs_ds, cumdeg)``: the permuted
    neighbor/edge-id arrays, ``degs_ds[p] = deg(nbr_ds[p])``, and the
    *in-row exclusive* prefix sum of ``degs_ds`` (int64).
    """
    deg = np.diff(off)
    src = np.repeat(np.arange(deg.shape[0]), deg)
    order = np.lexsort((nbr, deg[nbr], src))
    nbr_ds, uid_ds = nbr[order], uid[order]
    degs_ds = deg[nbr_ds].astype(np.int64)
    excl = np.concatenate([[0], np.cumsum(degs_ds)])  # global, (2m + 1,)
    cumdeg = excl[:-1] - np.repeat(excl[off[:-1]], deg)
    return nbr_ds, uid_ds, degs_ds, cumdeg


def greedy_vertex_blocks(
    wv: np.ndarray,
    n: int,
    rows: Optional[int] = None,
    target: Optional[int] = None,
) -> tuple[np.ndarray, int]:
    """Greedy vertex-aligned block boundaries over per-vertex wedge counts.

    Each block spans at most ``rows`` vertices (when given) and at most
    ``target`` wedges (when given; a single vertex whose wedge count
    already exceeds the target gets a solo block).

    Returns (boundaries (n_blocks + 1,) int64, max wedges per block).
    """
    wv = np.asarray(wv[:n], dtype=np.int64)
    woff = np.concatenate([[0], np.cumsum(wv)])
    bounds = [0]
    b = 0
    while b < n:
        nxt = n
        if target is not None:
            # largest v with sum(wv[b:v]) <= target
            nxt = int(np.searchsorted(woff, woff[b] + target, side="right")) - 1
        if rows is not None:
            nxt = min(nxt, b + rows)
        nxt = min(max(nxt, b + 1), n)
        bounds.append(nxt)
        b = nxt
    bounds = np.asarray(bounds, dtype=np.int64)
    per_block = woff[bounds[1:]] - woff[bounds[:-1]]
    return bounds, int(per_block.max(initial=1))


def plan_wedge_chunks(
    rg: RankedGraph,
    direction: str = "low",
    max_chunk: int = 1 << 18,
    pad: int = 128,
    *,
    wv_slots: np.ndarray,
) -> tuple[np.ndarray, int]:
    """Vertex-aligned streaming chunks of the flat wedge space, from the
    per-slot wedge counts ``wv_slots`` (of ``direction``, which the
    counts already carry; the argument keeps the reference's
    signature).

    Flat wedge ids follow CSR slot order, so all wedges produced by one
    iterating endpoint are contiguous, and every group (x1, x2) lives
    entirely inside its iterating endpoint's range. Cutting the stream
    only at vertex boundaries therefore keeps aggregation exact per
    chunk: no group ever spans two chunks, so per-chunk butterfly
    contributions add.

    Returns (vertex boundaries (n_blocks + 1,), chunk_cap): the largest
    chunk's wedge count rounded up to ``pad``.
    """
    voff = wedge_prefix(rg.offsets, wv_slots)[1]
    bounds, chunk = greedy_vertex_blocks(np.diff(voff), rg.n_pad,
                                         target=int(max_chunk))
    chunk_cap = max(pad, ((chunk + pad - 1) // pad) * pad)
    return bounds, chunk_cap


def ragged_slots_at(roff: torch.Tensor, starts: torch.Tensor,
                    wid: torch.Tensor):
    """Recover ``(segment, absolute position)`` for flat ragged ids.

    ``roff`` is the exclusive prefix sum of the segment lengths,
    ``starts[i]`` the absolute start of segment ``i``'s range. Flat id
    ``w`` belongs to the segment ``seg`` with ``roff[seg] <= w <
    roff[seg + 1]``, at position ``starts[seg] + w - roff[seg]``. Ids
    are clamped into ``[0, roff[-1])``; callers mask invalid lanes.
    The peeling subtract calls this once per frontier tile, so no round
    materializes its whole frontier expansion."""
    total = roff[-1]
    kc = torch.minimum(wid.to(torch.int64), torch.clamp(total - 1, min=0))
    seg = torch.searchsorted(roff, kc, right=True) - 1
    seg = torch.clamp(seg, 0, starts.shape[0] - 1)
    return seg, starts[seg] + kc - roff[seg]


def aligned_tile_end(roff, ts: int, tile_cap: int) -> int:
    """Largest segment boundary in ``roff`` at most ``ts + tile_cap``.

    Greedy tile planning for the peeling subtract: tiles of a round's
    frontier wedge space cut only at iterating-endpoint boundaries (no
    endpoint-pair group may span a tile, or its C(d, 2) would split).
    Callers guarantee ``tile_cap`` is at least the largest segment, so
    the returned boundary advances past ``ts`` whenever ``ts`` is a
    boundary below ``roff[-1]``. ``roff`` is a host array here: the
    port plans a round's tiles on the host and pads none of them."""
    roff = np.asarray(roff)
    ub = int(np.searchsorted(roff, int(ts) + int(tile_cap), side="right")) - 1
    return int(roff[min(max(ub, 0), roff.shape[0] - 1)])


def expand_ragged(starts: torch.Tensor, lens: torch.Tensor, cap: int):
    """Flatten the ranges ``[starts[i], starts[i] + lens[i])`` into a
    ``(cap,)`` batch: flat slot ``k`` belongs to segment ``seg[k]`` at
    absolute position ``pos[k]``; ``valid`` masks slots beyond the true
    total, which comes back as ``total`` (a () tensor) so callers can
    detect ``total > cap``. The port passes the exact total as ``cap``
    (known from the round's one host sync), so no slot is padding.
    Returns ``(seg, pos, valid, total)``."""
    roff = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                       device=lens.device)
    torch.cumsum(lens.to(torch.int64), 0, out=roff[1:])
    k = torch.arange(cap, dtype=torch.int64, device=lens.device)
    seg, pos = ragged_slots_at(roff, starts.to(torch.int64), k)
    return seg, pos, k < roff[-1], roff[-1]
