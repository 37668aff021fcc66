"""Wedge aggregation strategies (paper §3.1.2).

All strategies group wedges by their endpoint pair (x1, x2) and return
(a) the group size ``d`` gathered back per wedge and (b) a table of
groups for endpoint-side butterfly contributions.

  - **sort**: one stable sort on the composite key ``x1 << 32 | x2``
    (lexicographic on (x1, x2): both are below 2^31), payload gathered
    through the permutation.
  - **hash**: the reference's cohort-claiming double-hash table: each
    probe round does a scatter-min "claim" (``scatter_reduce_`` amin,
    the stand-in for CAS) followed by a gather re-check. All wedges of
    one key probe an identical slot sequence, so they resolve as a
    cohort. Bounded probes; a failure to resolve is reported in
    ``Groups.ok`` so callers fall back to sort.
  - **histogram**: dense histogram over the (x1, x2) key space, O(n²)
    table; only for small n.

Engine contract: ``aggregate_hash`` and ``aggregate_dense`` accept
``engine="torch"|"cuda"``. Under "cuda" the histogram step runs through
the hand-written CUDA kernel via ``kernels/ops.wedge_histogram`` (which
takes its plain PyTorch version for a tensor on the CPU); "torch" keeps
``index_add_``. Both produce identical int32 counts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops as _kops
from .wedges import Wedges

__all__ = [
    "Groups",
    "table_bits_for",
    "hash_resolve",
    "aggregate_sort",
    "aggregate_hash",
    "aggregate_dense",
]

_FREE = int(np.iinfo(np.int32).max)
_M32 = 0xFFFFFFFF


def _histogram(keys: torch.Tensor, valid: torch.Tensor, num_buckets: int,
               engine: str) -> torch.Tensor:
    """Count ``keys`` (masked by ``valid``) into ``num_buckets`` int32
    bins on the selected engine. Keys of masked-out entries must already
    be in range (callers zero them)."""
    if engine == "cuda":
        return _kops.wedge_histogram(keys, valid, num_buckets)
    if engine != "torch":
        raise ValueError(f"engine must be torch|cuda, got {engine}")
    out = torch.zeros(num_buckets, dtype=torch.int32, device=keys.device)
    return out.index_add_(0, keys.long(), valid.to(torch.int32))


class Groups(NamedTuple):
    """Endpoint-pair groups.

    ``d_per_wedge[w]`` is the multiplicity of wedge w's group (0 for
    invalid wedges), int32. ``(x1, x2, d, valid)`` describe a table of
    groups (entries with ``valid`` False are empty). ``ok`` is False iff
    the strategy failed (hash overflow) and the caller should fall
    back.
    """

    d_per_wedge: torch.Tensor
    x1: torch.Tensor
    x2: torch.Tensor
    d: torch.Tensor
    valid: torch.Tensor
    ok: bool


def aggregate_sort(w: Wedges):
    """Sort-based aggregation. Returns (Groups, sorted Wedges);
    ``d_per_wedge`` aligns with the *sorted* wedges (scatter targets are
    order-independent, so callers accumulate from the sorted view). The
    group table holds exactly one entry per group."""
    w_cap = int(w.x1.shape[0])
    # invalid wedges carry the x1 == x2 == n_pad sentinel -> sort last
    perm = torch.sort((w.x1 << 32) | w.x2, stable=True).indices
    sx1, sx2 = w.x1[perm], w.x2[perm]
    sval = w.valid[perm]
    prev_same = torch.zeros_like(sval)
    prev_same[1:] = (sx1[1:] == sx1[:-1]) & (sx2[1:] == sx2[:-1])
    starts = sval & ~prev_same
    seg = torch.cumsum(starts, 0) - 1  # group id per sorted position
    seg = torch.where(sval, seg, torch.full_like(seg, max(w_cap - 1, 0)))
    counts = torch.zeros(w_cap, dtype=torch.int32, device=w.x1.device)
    counts.index_add_(0, seg, sval.to(torch.int32))
    d_sorted = torch.where(sval, counts[seg], torch.zeros_like(counts))
    n_groups = int(starts.sum())
    groups = Groups(
        d_per_wedge=d_sorted,
        x1=sx1[starts],
        x2=sx2[starts],
        d=counts[:n_groups],
        valid=torch.ones(n_groups, dtype=torch.bool, device=w.x1.device),
        ok=True,
    )
    w_sorted = Wedges(
        x1=sx1, x2=sx2, y=w.y[perm], center_slot=w.center_slot[perm],
        second_slot=w.second_slot[perm], valid=sval,
    )
    return groups, w_sorted


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32): uint32 multiply in int64,
    split in 16-bit halves so no partial product leaves int64."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _hash_slots(x1: torch.Tensor, x2: torch.Tensor, probe: int,
                table_bits: int) -> torch.Tensor:
    """Double hashing on the endpoint pair; the reference's uint32
    multiply-mix, bit for bit."""
    a = x1 & _M32
    b = x2 & _M32
    h1 = _mul32(a, 0x9E3779B1) ^ _mul32(b, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 15)
    h2 = _mul32(a ^ ((b << 7) & _M32) ^ (b >> 3), 0xC2B2AE35) | 1
    return (h1 + probe * h2) & ((1 << table_bits) - 1)


def table_bits_for(w_cap: int) -> int:
    """The reference's default hash-table size for a ``w_cap``-lane
    wedge buffer: the smallest power of two >= 2 * w_cap, at least
    2^4."""
    return max(4, int(np.ceil(np.log2(max(2 * int(w_cap), 2)))))


def hash_resolve(w: Wedges, table_bits: int, max_probes: int = 32):
    """Run the cohort-claiming probe rounds. Returns ``(owner, slot,
    resolved)``: per table slot the claimant wedge id (``_FREE`` when
    empty), per wedge its resolved slot, and the resolved mask.

    Each round touches only the still-unresolved wedges: a resolved
    wedge neither claims nor changes state, so skipping it is the
    reference's round exactly, and the loop stops once every wedge is
    resolved."""
    dev = w.x1.device
    w_cap = int(w.x1.shape[0])
    owner = torch.full((1 << table_bits,), _FREE, dtype=torch.int64,
                       device=dev)
    slot = torch.zeros(w_cap, dtype=torch.int64, device=dev)
    resolved = ~w.valid
    for p in range(max_probes):
        idx = torch.nonzero(~resolved).squeeze(1)
        if idx.numel() == 0:
            break
        x1, x2 = w.x1[idx], w.x2[idx]
        cand = _hash_slots(x1, x2, p, table_bits)
        o = owner[cand]
        o_safe = torch.clamp(o, max=w_cap - 1)
        occupied = o != _FREE
        res_now = occupied & (w.x1[o_safe] == x1) & (w.x2[o_safe] == x2)
        try_claim = ~occupied
        claim = torch.where(try_claim, idx, torch.full_like(idx, _FREE))
        owner.scatter_reduce_(0, cand, claim, "amin")
        o2 = owner[cand]
        o2_safe = torch.clamp(o2, max=w_cap - 1)
        won = (try_claim & (o2 != _FREE) & (w.x1[o2_safe] == x1)
               & (w.x2[o2_safe] == x2))
        newly = res_now | won
        slot[idx[newly]] = cand[newly]
        resolved[idx[newly]] = True
    return owner, slot, resolved


def aggregate_hash(
    w: Wedges,
    table_bits: Optional[int] = None,
    max_probes: int = 32,
    engine: str = "torch",
) -> Groups:
    """Cohort-claiming double-hash aggregation (see
    :func:`hash_resolve`). ``ok`` is False if any wedge remains
    unresolved after ``max_probes`` rounds (callers fall back to sort).
    ``table_bits=None`` sizes the table for this batch
    (:func:`table_bits_for`)."""
    w_cap = int(w.x1.shape[0])
    if table_bits is None:
        table_bits = table_bits_for(w_cap)
    owner, slot, resolved = hash_resolve(w, table_bits, max_probes)
    ok = bool(resolved.all())
    counts = _histogram(slot, w.valid & resolved, 1 << table_bits, engine)
    zero = torch.zeros_like(counts[:1])
    d_per_wedge = torch.where(w.valid, counts[slot], zero)
    gvalid = owner != _FREE
    own_safe = torch.clamp(owner, max=max(w_cap - 1, 0))
    return Groups(
        d_per_wedge=d_per_wedge,
        x1=torch.where(gvalid, w.x1[own_safe], 0),
        x2=torch.where(gvalid, w.x2[own_safe], 0),
        d=torch.where(gvalid, counts, zero),
        valid=gvalid,
        ok=ok,
    )


def aggregate_dense(w: Wedges, n_pad: int, engine: str = "torch") -> Groups:
    """Exact dense histogram over the (x1, x2) key space. O(n²) table."""
    key = w.x1 * n_pad + w.x2
    key = torch.where(w.valid, key, torch.zeros_like(key))
    T = n_pad * n_pad
    counts = _histogram(key, w.valid, T, engine)
    d_per_wedge = torch.where(w.valid, counts[key], torch.zeros_like(counts[:1]))
    tkey = torch.arange(T, dtype=torch.int64, device=key.device)
    return Groups(
        d_per_wedge=d_per_wedge,
        x1=tkey // n_pad,
        x2=tkey % n_pad,
        d=counts,
        valid=counts > 0,
        ok=True,
    )

