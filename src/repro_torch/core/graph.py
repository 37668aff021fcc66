"""Bipartite graphs for the ParButterfly engine.

A :class:`BipartiteGraph` and its checks are host numpy, identical to
the reference package's. PREPROCESS (:func:`build_csr`) is torch, run
on the device it is given: one stable sort of a composite key orders
the directed edges, and the padded CSR is written into one int32 buffer
there. :func:`preprocess` returns that CSR as a host
:class:`RankedGraph`, the same array for array as the reference's on
any device; a count builds it on its own device and keeps the device
buffer as its ``DeviceGraph`` (``wedges.preprocess_device``).

Vertex convention after preprocessing (paper Alg. 1 PREPROCESS):
  - vertices are relabeled so that ``id == rank`` (0 = first in the order,
    i.e. highest priority / processed first),
  - a wedge (x1, x2, y) with endpoints x1 < x2 and center y is *retrieved*
    by x1 iff ``y > x1`` and ``x2 > x1`` (both later in the order),
  - adjacency lists are sorted ascending, so the retrievable neighbors of
    any vertex form a suffix of its adjacency list.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from .resilience import AccumulatorOverflowRisk, GraphValidationError

__all__ = [
    "BipartiteGraph",
    "RankedGraph",
    "CsrBuffer",
    "build_csr",
    "preprocess",
    "ranked_from_csr",
]

_DUP_POLICIES = ("dedupe", "raise", "assume_unique")


def _round_up(x: int, mult: int) -> int:
    return ((int(x) + mult - 1) // mult) * mult


@dataclasses.dataclass
class BipartiteGraph:
    """An undirected simple bipartite graph G = (U, V, E), host-side.

    ``edges`` is an (m, 2) int array of (u, v) pairs with ``0 <= u < n_u``
    and ``0 <= v < n_v``. Self-loops are impossible by construction;
    duplicate edges are removed on construction (paper §6.1) unless
    ``on_duplicate`` overrides that: ``"dedupe"`` (default, silent
    removal), ``"raise"`` (typed :class:`GraphValidationError`), or
    ``"assume_unique"`` (skip the O(m log m) uniqueness pass entirely —
    the opt-out for callers that pre-dedupe; duplicates passed under it
    corrupt counts, so it is strictly a contract with the caller).

    Malformed inputs — wrong shape, non-integral or out-of-range
    endpoints, empty sides — raise :class:`GraphValidationError`
    (a ``ValueError`` subclass) before any kernel sees the data.
    """

    n_u: int
    n_v: int
    edges: np.ndarray  # (m, 2) int64
    on_duplicate: str = "dedupe"

    def __post_init__(self):
        if self.on_duplicate not in _DUP_POLICIES:
            raise GraphValidationError(
                f"on_duplicate must be {'|'.join(_DUP_POLICIES)}, "
                f"got {self.on_duplicate!r}"
            )
        if int(self.n_u) <= 0 or int(self.n_v) <= 0:
            raise GraphValidationError(
                f"empty-side graph: n_u={self.n_u}, n_v={self.n_v} "
                "(both sides must be non-empty)"
            )
        e = np.asarray(self.edges)
        if e.ndim != 2 or e.shape[1] != 2:
            raise GraphValidationError(f"edges must be (m, 2), got {e.shape}")
        if e.dtype.kind == "f":
            if e.size and not np.isfinite(e).all():
                raise GraphValidationError("non-finite edge endpoints")
            if e.size and not (e == np.floor(e)).all():
                raise GraphValidationError("non-integral edge endpoints")
        elif e.dtype.kind not in "iu":
            raise GraphValidationError(
                f"edge endpoints must be integers, got dtype {e.dtype}"
            )
        e = e.astype(np.int64)
        if e.shape[0]:
            if e[:, 0].min() < 0 or e[:, 0].max() >= self.n_u:
                raise GraphValidationError("u endpoint out of range")
            if e[:, 1].min() < 0 or e[:, 1].max() >= self.n_v:
                raise GraphValidationError("v endpoint out of range")
        if self.on_duplicate == "assume_unique":
            self.edges = e
            return
        key = e[:, 0] * max(self.n_v, 1) + e[:, 1]
        _, idx = np.unique(key, return_index=True)
        if self.on_duplicate == "raise" and idx.shape[0] != e.shape[0]:
            raise GraphValidationError(
                f"{e.shape[0] - idx.shape[0]} duplicate edges "
                "(on_duplicate='raise'; use 'dedupe' to drop them)"
            )
        self.edges = e[np.sort(idx)]

    @classmethod
    def from_csr(cls, indptr, indices, n_v: int,
                 on_duplicate: str = "dedupe") -> "BipartiteGraph":
        """Build from a U-side CSR adjacency, validating the structure:
        ``indptr`` must be 1-D, start at 0, be non-decreasing (ragged /
        non-monotone offsets raise :class:`GraphValidationError`), and
        end at ``len(indices)``; ``indices`` are V ids in ``[0, n_v)``
        (range-checked by ``__post_init__``)."""
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        if indptr.ndim != 1 or indptr.shape[0] < 1:
            raise GraphValidationError(
                f"indptr must be 1-D and non-empty, got shape {indptr.shape}"
            )
        if indptr.dtype.kind not in "iu":
            raise GraphValidationError(
                f"indptr must be integers, got dtype {indptr.dtype}"
            )
        if indices.ndim != 1:
            raise GraphValidationError(
                f"indices must be 1-D, got shape {indices.shape}"
            )
        indptr = indptr.astype(np.int64)
        if int(indptr[0]) != 0:
            raise GraphValidationError(
                f"indptr must start at 0, got {int(indptr[0])}"
            )
        if indptr.shape[0] > 1 and (np.diff(indptr) < 0).any():
            raise GraphValidationError("non-monotone CSR indptr")
        if int(indptr[-1]) != indices.shape[0]:
            raise GraphValidationError(
                f"ragged CSR: indptr[-1]={int(indptr[-1])} but "
                f"len(indices)={indices.shape[0]}"
            )
        n_u = indptr.shape[0] - 1
        us = np.repeat(np.arange(n_u, dtype=np.int64), np.diff(indptr))
        edges = np.stack([us, indices.astype(np.int64)], axis=1)
        return cls(n_u, int(n_v), edges, on_duplicate=on_duplicate)

    @property
    def m(self) -> int:
        return int(self.edges.shape[0])

    @property
    def n(self) -> int:
        return int(self.n_u + self.n_v)

    def degrees(self) -> tuple[np.ndarray, np.ndarray]:
        du = np.bincount(self.edges[:, 0], minlength=self.n_u)
        dv = np.bincount(self.edges[:, 1], minlength=self.n_v)
        return du, dv

    def wedge_totals(self) -> tuple[int, int]:
        """(#wedges with endpoints in U, #wedges with endpoints in V).

        Wedges with endpoints in U have centers in V and vice versa.
        """
        du, dv = self.degrees()
        w_u = int((dv.astype(np.int64) * (dv - 1) // 2).sum())
        w_v = int((du.astype(np.int64) * (du - 1) // 2).sum())
        return w_u, w_v

    def content_hash(self) -> str:
        """Stable content identity: sha256 over ``(n_u, n_v)`` and the
        canonical (validated, dedup-resolved, int64) edge array. Two
        graphs hash equal iff they are the same bipartite graph in the
        same vertex numbering — the serving layer's graph *version* key,
        so re-registering identical data is a no-op while any edit
        invalidates that version's cached results."""
        e = np.ascontiguousarray(self.edges, dtype=np.int64)
        h = hashlib.sha256()
        h.update(f"bipartite/{self.n_u}/{self.n_v}/{e.shape[0]}".encode())
        h.update(e.tobytes())
        return h.hexdigest()

    def accumulator_preflight(self, budget_bits: int = 63) -> int:
        """Worst-case butterfly bound vs. the accumulator budget.

        Σ C(d, 2) over endpoint-pair groups with Σ d = W is maximized
        (convexity) by one group holding all W wedges, so
        ``C(min(w_u, w_v), 2)`` bounds the exact total. Computed in
        arbitrary-precision host ints; raises
        :class:`AccumulatorOverflowRisk` when the bound needs more
        than ``budget_bits`` bits (default: the engines' int64
        accumulators, exact below 2^63). Returns the bound."""
        w_u, w_v = self.wedge_totals()
        w = min(w_u, w_v)
        bound = w * (w - 1) // 2
        if bound >= (1 << int(budget_bits)):
            raise AccumulatorOverflowRisk(
                f"worst-case butterfly bound C({w}, 2) = {bound} exceeds "
                f"the {budget_bits}-bit accumulator budget; exact counts "
                "cannot be guaranteed on any engine rung"
            )
        return bound


@dataclasses.dataclass
class RankedGraph:
    """Preprocessed (ranked + relabeled) graph in padded CSR form.

    All arrays are numpy on the host; engine entry points move them to
    the device. Shapes are padded exactly as the reference pads them, so
    plans and counts compare array for array.

    Attributes:
      n: number of real vertices (ids ``0..n-1`` are real; ``n..n_pad-1``
         are padding with degree 0).
      m: number of undirected edges. Directed edge slots ``0..2m-1`` are
         real; the rest padding.
      offsets: (n_pad + 1,) int32 CSR offsets into ``neighbors``.
      neighbors: (e_pad,) int32, ascending within each vertex; padded
         entries hold ``n_pad`` (an out-of-range sentinel).
      edge_src: (e_pad,) int32 source of each directed edge slot.
      undirected_id: (e_pad,) int32 undirected edge id in [0, m) for real
         slots, ``m`` sentinel for padding.
      side_of: (n_pad,) int8: 0 if the vertex came from U, 1 from V,
         -1 padding.
      orig_id: (n_pad,) int32 original vertex id *within its side*.
      rank_of_u / rank_of_v: (n_u,) / (n_v,) int32 mapping original ids
         to new ids (ranks).
      n_u, n_v: original side sizes.
    """

    n: int
    m: int
    offsets: np.ndarray
    neighbors: np.ndarray
    edge_src: np.ndarray
    undirected_id: np.ndarray
    side_of: np.ndarray
    orig_id: np.ndarray
    rank_of_u: np.ndarray
    rank_of_v: np.ndarray
    n_u: int
    n_v: int
    order_name: str = "side"

    @property
    def n_pad(self) -> int:
        return int(self.side_of.shape[0])

    @property
    def e_pad(self) -> int:
        return int(self.neighbors.shape[0])

    def degrees(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int32)

    @classmethod
    def from_arrays(
        cls,
        *,
        n: int,
        m: int,
        offsets,
        neighbors,
        edge_src,
        undirected_id,
        side_of,
        orig_id,
        rank_of_u,
        rank_of_v,
        n_u: int,
        n_v: int,
        order_name: str = "custom",
    ) -> "RankedGraph":
        """Build from the numpy fields of an already preprocessed graph
        (the reference package's ``RankedGraph`` has the same fields),
        checking the CSR shape contract: ``offsets`` (n_pad + 1,),
        ``neighbors`` / ``edge_src`` / ``undirected_id`` (e_pad,) with
        e_pad >= 2m, ``side_of`` / ``orig_id`` (n_pad,) with n_pad >= n,
        ``rank_of_u`` (n_u,) and ``rank_of_v`` (n_v,)."""
        arr = dict(
            offsets=np.ascontiguousarray(offsets, np.int32),
            neighbors=np.ascontiguousarray(neighbors, np.int32),
            edge_src=np.ascontiguousarray(edge_src, np.int32),
            undirected_id=np.ascontiguousarray(undirected_id, np.int32),
            side_of=np.ascontiguousarray(side_of, np.int8),
            orig_id=np.ascontiguousarray(orig_id, np.int32),
            rank_of_u=np.ascontiguousarray(rank_of_u, np.int32),
            rank_of_v=np.ascontiguousarray(rank_of_v, np.int32),
        )
        n, m, n_u, n_v = int(n), int(m), int(n_u), int(n_v)
        n_pad = arr["side_of"].shape[0]
        e_pad = arr["neighbors"].shape[0]
        checks = (
            (n == n_u + n_v, "n must equal n_u + n_v"),
            (n_pad >= n, "side_of must cover the n real vertices"),
            (arr["offsets"].shape == (n_pad + 1,), "offsets must be (n_pad+1,)"),
            (e_pad >= 2 * m, "neighbors must cover the 2m directed slots"),
            (arr["edge_src"].shape == (e_pad,), "edge_src must be (e_pad,)"),
            (arr["undirected_id"].shape == (e_pad,),
             "undirected_id must be (e_pad,)"),
            (arr["orig_id"].shape == (n_pad,), "orig_id must be (n_pad,)"),
            (arr["rank_of_u"].shape == (n_u,), "rank_of_u must be (n_u,)"),
            (arr["rank_of_v"].shape == (n_v,), "rank_of_v must be (n_v,)"),
        )
        for ok, msg in checks:
            if not ok:
                raise GraphValidationError(f"RankedGraph.from_arrays: {msg}")
        if int(arr["offsets"][0]) != 0 or int(arr["offsets"][-1]) != 2 * m:
            raise GraphValidationError(
                "RankedGraph.from_arrays: offsets must run from 0 to 2m"
            )
        if (np.diff(arr["offsets"]) < 0).any():
            raise GraphValidationError(
                "RankedGraph.from_arrays: non-monotone CSR offsets"
            )
        return cls(n=n, m=m, n_u=n_u, n_v=n_v, order_name=str(order_name),
                   **arr)


# Field order of the one int32 buffer a CSR build writes: the build
# fills it in place on its device and the host reads it with one copy.
# ``side_of`` rides in it as int32 and is narrowed to int8 on each side.
_CSR_FIELDS = ("offsets", "neighbors", "edge_src", "undirected_id",
               "orig_id", "rank_of_u", "rank_of_v", "side_of")


class CsrBuffer(NamedTuple):
    """What :func:`build_csr` writes: the CSR fields of a
    :class:`RankedGraph`, int32, end to end in one buffer on the build's
    device, in the order of ``_CSR_FIELDS`` with lengths ``sizes``."""

    buf: torch.Tensor
    sizes: tuple

    def fields(self) -> dict:
        """Each field by name, a view into ``buf``."""
        return dict(zip(_CSR_FIELDS, torch.split(self.buf, self.sizes)))


def build_csr(
    g: BipartiteGraph,
    order,
    pad_vertices: int = 8,
    pad_edges: int = 128,
    device="cpu",
) -> CsrBuffer:
    """Paper Alg. 1 PREPROCESS in torch on ``device``: the padded CSR of
    :class:`RankedGraph`, written into one int32 buffer there.

    The directed edges, relabeled to ranks, are ordered by one stable
    sort of the composite key ``src * n_pad + dst`` (below ``n_pad**2 <
    2**62``), which gives ``np.lexsort((dst, src))``'s permutation, ties
    among repeated pairs included. ``order`` is checked on the host
    before any device work."""
    n, m, n_u = g.n, g.m, g.n_u
    order = np.ascontiguousarray(order, dtype=np.int64)
    if order.shape != (n,):
        raise GraphValidationError(
            f"order must be a permutation of {n} vertices, "
            f"got shape {order.shape}"
        )
    if n and (order.min() < 0 or order.max() >= n):
        raise GraphValidationError(
            f"order must be a permutation of {n} vertices: "
            "entries out of range"
        )
    if n and (np.bincount(order, minlength=n) != 1).any():
        # a duplicated entry would silently corrupt rank[order] below
        raise GraphValidationError(
            f"order must be a permutation of {n} vertices: "
            "duplicate entries"
        )
    n_pad = _round_up(max(n, 1), pad_vertices)
    e_pad = _round_up(max(2 * m, 1), pad_edges)
    i64 = dict(dtype=torch.int64, device=device)

    rank = torch.empty(n, **i64)
    rank[torch.as_tensor(order, device=device)] = torch.arange(n, **i64)
    # Global ids: u -> u, v -> n_u + v; directed edges both ways.
    e = torch.as_tensor(g.edges, device=device)
    ru, rv = rank[e[:, 0]], rank[e[:, 1] + n_u]
    key, perm = torch.sort(torch.cat([ru * n_pad + rv, rv * n_pad + ru]),
                           stable=True)
    src = torch.div(key, n_pad, rounding_mode="floor")
    dst = key - src * n_pad
    uid = torch.where(perm >= m, perm - m, perm)  # slots i, m + i: edge i

    sizes = (n_pad + 1, e_pad, e_pad, e_pad, n_pad, n_u, g.n_v, n_pad)
    csr = CsrBuffer(torch.empty(sum(sizes), dtype=torch.int32,
                                device=device), sizes)
    f = csr.fields()
    f["offsets"][0] = 0
    f["offsets"][1:] = torch.cumsum(torch.bincount(src, minlength=n_pad), 0)
    for name, real, pad in (("neighbors", dst, n_pad),
                            ("edge_src", src, n_pad),
                            ("undirected_id", uid, m)):
        f[name][: 2 * m] = real
        f[name][2 * m:] = pad
    for side, ranks in enumerate((rank[:n_u], rank[n_u:])):
        f["orig_id"][ranks] = torch.arange(ranks.shape[0], dtype=torch.int32,
                                           device=device)
        f["side_of"][ranks] = side
    f["orig_id"][n:] = -1
    f["side_of"][n:] = -1
    f["rank_of_u"][:] = rank[:n_u]
    f["rank_of_v"][:] = rank[n_u:]
    return csr


def ranked_from_csr(g: BipartiteGraph, csr: CsrBuffer,
                    order_name: str) -> RankedGraph:
    """The host :class:`RankedGraph` of a :func:`build_csr` buffer, by
    one copy of the buffer to the host (none from the CPU): every array
    but ``side_of`` is a view into that copy."""
    host = csr.buf.cpu().numpy()
    a = dict(zip(_CSR_FIELDS, np.split(host, np.cumsum(csr.sizes)[:-1])))
    a["side_of"] = a["side_of"].astype(np.int8)
    return RankedGraph(n=g.n, m=g.m, n_u=g.n_u, n_v=g.n_v,
                       order_name=order_name, **a)


def preprocess(
    g: BipartiteGraph,
    order: np.ndarray,
    order_name: str = "custom",
    pad_vertices: int = 8,
    pad_edges: int = 128,
    device="cpu",
) -> RankedGraph:
    """Paper Alg. 1 PREPROCESS: relabel vertices by rank, build padded CSR.

    ``order`` is a permutation of global vertex ids (U ids are
    ``0..n_u-1``, V ids are ``n_u..n_u+n_v-1``) listing vertices from
    first-processed (rank 0) to last. The CSR is built on ``device``
    (:func:`build_csr`) and returned on the host, array for array the
    reference's whatever the device.
    """
    return ranked_from_csr(
        g, build_csr(g, order, pad_vertices, pad_edges, device), order_name)
