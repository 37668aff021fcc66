"""Dispatch for the counting and peeling kernels: the only module that
reaches the hand-written CUDA kernels (``kernels/cuda.py``).

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it computes the kernel's plain PyTorch version (``kernels/ref``).
There is no fallback from one to the other. Each wrapper adds one to its
entry of :data:`LAUNCHES` where it launches its kernel, and nowhere
else, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from ..testing import faults as _faults
from . import cuda as _cuda
from . import ref as _ref

__all__ = [
    "LAUNCHES",
    "MAX_TILE_CAP",
    "build",
    "build_info",
    "histogram_plan",
    "reset_launches",
    "wedge_histogram",
    "butterfly_combine",
    "fused_count_tiles",
    "fused_work",
    "bucket_min",
    "bucket_state",
    "bucket_update",
    # peeling-kernel contract constants and pure helpers, re-exported so
    # core/ reaches them through this dispatch module
    "NUM_BUCKETS",
    "bit_length",
    "bucket_upper_bound",
    "lowest_nonempty_bucket",
]

MAX_TILE_CAP = _cuda.MAX_TILE_CAP
NUM_BUCKETS = _ref.NUM_BUCKETS
bit_length = _ref.bit_length
bucket_upper_bound = _ref.bucket_upper_bound
lowest_nonempty_bucket = _ref.lowest_nonempty_bucket
build = _cuda.build
build_info = _cuda.build_info
histogram_plan = _cuda.histogram_plan

LAUNCHES = {"wedge_histogram": 0, "butterfly_combine": 0,
            "fused_count_tiles": 0, "bucket_min": 0, "bucket_update": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: tensors on {t.device} are not supported")


def wedge_histogram(keys: torch.Tensor, valid: torch.Tensor,
                    num_buckets: int) -> torch.Tensor:
    """int32 (num_buckets,) counts of the entries with ``valid > 0``;
    keys outside ``[0, num_buckets)`` are dropped."""
    _faults.maybe_oom("ops.wedge_histogram")
    if not 0 < int(num_buckets) < 2**31:
        raise ValueError(
            f"num_buckets must be in [1, 2^31), got {num_buckets}"
        )
    if not _on_cuda(keys, "wedge_histogram"):
        return _ref.wedge_histogram_ref(keys, valid, num_buckets)
    out = _cuda.wedge_histogram(keys, valid, num_buckets)
    LAUNCHES["wedge_histogram"] += 1
    return out


def butterfly_combine(d: torch.Tensor, rep: torch.Tensor,
                      valid: torch.Tensor):
    """``(dm1 int32, c2 int64)``: d - 1 where ``valid & d > 0``, and
    exact C(d, 2) where also ``rep``."""
    _faults.maybe_oom("ops.butterfly_combine")
    if not _on_cuda(d, "butterfly_combine"):
        return _ref.butterfly_combine_ref(d, rep, valid)
    out = _cuda.butterfly_combine(d, rep, valid)
    LAUNCHES["butterfly_combine"] += 1
    return out


def bucket_min(counts: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """() int32 min of ``counts`` where ``alive``, INT32_MAX if none;
    int64 counts are clamped to INT32_MAX, not wrapped."""
    _faults.maybe_oom("ops.bucket_min")
    if not _on_cuda(counts, "bucket_min"):
        return _ref.bucket_min_ref(counts, alive)
    out = _cuda.bucket_min(counts, alive)
    LAUNCHES["bucket_min"] += 1
    return out


def bucket_state(counts: torch.Tensor, alive: torch.Tensor):
    """``(min, hist)`` of the counts with no decrease-key batch. Plain
    PyTorch on every device: it only seeds the peeling loops' carried
    state and re-derives it on rounds with no frontier, off the
    per-tile path."""
    return _ref.bucket_state_ref(counts, alive)


def bucket_update(counts: torch.Tensor, alive: torch.Tensor,
                  idx: torch.Tensor, dec: torch.Tensor):
    """Batched decrease-key: ``(counts - scatter_add(idx, dec), min over
    alive, (32,) bit-length occupancy over alive)`` in one pass; ``idx``
    outside ``[0, n)`` is dropped. Any batch size, int32 or int64
    counts."""
    _faults.maybe_oom("ops.bucket_update")
    if not _on_cuda(counts, "bucket_update"):
        return _ref.bucket_update_ref(counts, alive, idx, dec)
    out = _cuda.bucket_update(counts, alive, idx, dec)
    LAUNCHES["bucket_update"] += 1
    return out


def fused_count_tiles(
    tile_bounds,
    offsets: torch.Tensor,
    neighbors: torch.Tensor,
    edge_src: torch.Tensor,
    undirected_id: torch.Tensor,
    w_off: torch.Tensor,
    *,
    tile_cap: int,
    n_pad: int,
    m: int,
    direction: str = "low",
    mode: str = "all",
    work=None,
):
    """Zero-materialization fused counting over vertex-aligned wedge
    tiles (the ``fused_cuda`` engine). ``tile_bounds`` is an (n_tiles, 2)
    host array or tensor of flat wedge ranges ``[ws, we)``, each at most
    ``tile_cap`` wedges. Returns exact int64 ``(total (), per_vertex
    (n_pad,), per_edge (m,))``; modes not requested by ``mode`` come back
    as zeros. ``work`` is :func:`fused_work` of the same call, planned
    on the host; the kernel plans it itself (from a device-to-host fetch)
    when it is not given, and the plain version needs none."""
    _faults.maybe_oom("ops.fused_count_tiles")
    if direction not in ("low", "high"):
        raise ValueError(f"direction must be low|high, got {direction}")
    if mode not in ("global", "vertex", "edge", "all"):
        raise ValueError(f"bad mode {mode}")
    tb = np.asarray(torch.as_tensor(tile_bounds).cpu(), np.int64).reshape(-1, 2)
    widths = tb[:, 1] - tb[:, 0]
    if widths.size and int(widths.max()) > int(tile_cap):
        raise ValueError(
            f"a tile holds {int(widths.max())} wedges, more than "
            f"tile_cap={tile_cap}"
        )
    if _on_cuda(neighbors, "fused_count_tiles"):
        out = _cuda.fused_count_tiles(
            tb, offsets, neighbors, edge_src, undirected_id, w_off,
            n_pad=n_pad, m=m, direction=direction, mode=mode, work=work,
        )
        LAUNCHES["fused_count_tiles"] += 1
    else:
        out = _ref.fused_count_tiles_ref(
            torch.as_tensor(tb), offsets, neighbors, edge_src,
            undirected_id, w_off, n_pad=n_pad, m=m, direction=direction,
            mode=mode,
        )
    # value-level poison hook: this wrapper runs at host level, outside
    # any captured graph, so a planted sentinel reaches the validator
    return _faults.maybe_poison("ops.fused_count_tiles", out)


def fused_work(tile_bounds, offsets: np.ndarray, w_off: np.ndarray,
               device):
    """The fused kernel's work list for a ``fused_count_tiles`` call on
    ``device`` (``kernels/cuda.fused_work``), planned from host arrays
    (the tile bounds, the (n_pad + 1,) CSR offsets and the (e_pad + 1,)
    wedge prefix) and copied to the card without blocking the host.
    None off the card, where the plain version needs none."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _cuda.upload_work(
        _cuda.fused_work(tile_bounds, offsets, w_off, sms), device)
