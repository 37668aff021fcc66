"""Plain PyTorch versions of the three counting kernels.

Each function computes exactly what its CUDA kernel computes, on any
device: ``kernels/ops.py`` takes these for a tensor on the CPU, the CPU
tests hold them against the reference package's Pallas kernels, and
``chip_smoke.py`` holds each CUDA kernel against its plain version on
the card, bit for bit.
"""
from __future__ import annotations

import torch

__all__ = [
    "wedge_histogram_ref",
    "butterfly_combine_ref",
    "choose2_limbs",
    "fused_count_tiles_ref",
]


def wedge_histogram_ref(keys: torch.Tensor, valid: torch.Tensor,
                        num_buckets: int) -> torch.Tensor:
    """counts[b] = number of entries with ``valid > 0`` and key ``b``;
    keys outside ``[0, num_buckets)`` are dropped. int32 (num_buckets,)."""
    keys = keys.reshape(-1).long()
    live = (valid.reshape(-1).to(torch.int32) > 0)
    live &= (keys >= 0) & (keys < num_buckets)
    out = torch.zeros(num_buckets, dtype=torch.int32, device=keys.device)
    k = keys[live]
    return out.index_add_(0, k, torch.ones_like(k, dtype=torch.int32))


def butterfly_combine_ref(d: torch.Tensor, rep: torch.Tensor,
                          valid: torch.Tensor):
    """``dm1 = d - 1`` where ``valid & d > 0`` (else 0), int32; ``c2 =
    C(d, 2)`` where also ``rep`` (else 0), exact int64 for every int32
    ``d``. Returns ``(dm1, c2)``."""
    d = d.to(torch.int32)
    live = (valid.to(torch.int32) > 0) & (d > 0)
    dm1 = torch.where(live, d - 1, torch.zeros_like(d))
    dd = d.to(torch.int64)
    c2 = torch.where(live & (rep.to(torch.int32) > 0), dd * (dd - 1) // 2,
                     torch.zeros_like(dd))
    return dm1, c2


def choose2_limbs(d: torch.Tensor):
    """Exact C(d, 2) for int32 ``d`` in [0, 2^31) as the reference
    kernel's (lo, hi) int32 limbs of the 64-bit result (``lo`` is the
    low word's bit pattern). Only the parity tests use this: the port's
    kernels return C(d, 2) as int64."""
    dd = d.to(torch.int64)
    c2 = dd * (dd - 1) // 2
    lo = c2 & 0xFFFFFFFF
    lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo)
    return lo.to(torch.int32), (c2 >> 32).to(torch.int32)


def fused_count_tiles_ref(
    tile_bounds: torch.Tensor,
    offsets: torch.Tensor,
    neighbors: torch.Tensor,
    edge_src: torch.Tensor,
    undirected_id: torch.Tensor,
    w_off: torch.Tensor,
    *,
    n_pad: int,
    m: int,
    direction: str = "low",
    mode: str = "all",
):
    """Per vertex-aligned tile ``[ws, we)`` of flat wedge ids: rebuild
    each wedge (upper bound on ``w_off``, CSR gathers), group the tile's
    wedges by (x1, x2) into multiplicities d, add C(d, 2) per group to
    x1, x2 and the total, and d - 1 per wedge to the center y and both
    wedge edges. Returns exact int64 ``(total (), vertex (n_pad,),
    edge (m,))``; modes not requested by ``mode`` come back as zeros.
    ``tile_bounds`` is an (n_tiles, 2) integer tensor on any device."""
    dev = neighbors.device
    do_global = mode in ("global", "all")
    do_vertex = mode in ("vertex", "all")
    do_edge = mode in ("edge", "all")
    e_pad = int(neighbors.shape[0])
    nbr = neighbors.long()
    src = edge_src.long()
    off = offsets.long()
    uid = undirected_id.long()
    w_off = w_off.long()
    total = torch.zeros((), dtype=torch.int64, device=dev)
    vertex = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    edge = torch.zeros(m, dtype=torch.int64, device=dev)
    for ws, we in tile_bounds.tolist():
        if we <= ws:
            continue
        wid = torch.arange(ws, we, dtype=torch.int64, device=dev)
        e = torch.clamp(torch.searchsorted(w_off, wid, right=True) - 1,
                        0, e_pad - 1)
        j = wid - w_off[e]
        cnt_e = w_off[e + 1] - w_off[e]
        y = nbr[e]
        y_safe = torch.clamp(y, max=n_pad - 1)
        if direction == "low":
            x1 = src[e]
            pos = torch.clamp(off[y_safe + 1] - cnt_e + j, 0, e_pad - 1)
            x2 = nbr[pos]
        elif direction == "high":
            x2 = src[e]
            pos = torch.clamp(off[y_safe] + j, 0, e_pad - 1)
            x1 = nbr[pos]
        else:
            raise ValueError(f"direction must be low|high, got {direction}")
        keys, inv, d = torch.unique((x1 << 32) | x2, return_inverse=True,
                                    return_counts=True)
        c2 = d * (d - 1) // 2
        dm1 = d[inv] - 1
        if do_global:
            total += c2.sum()
        if do_vertex:
            vertex.index_add_(0, keys >> 32, c2)
            vertex.index_add_(0, keys & 0xFFFFFFFF, c2)
            vertex.index_add_(0, y, dm1)
        if do_edge:
            edge.index_add_(0, uid[e], dm1)
            edge.index_add_(0, uid[pos], dm1)
    return total, vertex, edge
