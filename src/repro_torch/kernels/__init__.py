"""The counting and peeling kernels, hand-written in CUDA C++ for Hopper.

  - ``wedge_histogram``: atomic histogram of hash-slot / dense wedge keys
    (replaces ``wedge_count.wedge_histogram_pallas``),
  - ``butterfly_combine``: d -> (d - 1, exact int64 C(d, 2)) (replaces
    ``butterfly_combine.butterfly_combine_pallas``),
  - ``fused_count_tiles``: zero-materialization fused counting over
    vertex-aligned wedge tiles (replaces
    ``wedge_fused.fused_count_tiles_pallas``),
  - ``bucket_min``: masked extract-min of the peeling loops (replaces
    ``bucket_min.bucket_min_pallas``),
  - ``bucket_update``: batched decrease-key with the next round's min
    and bit-length occupancy (replaces
    ``bucket_update.bucket_update_pallas``).

Callers go through ``ops``, which launches the kernel for CUDA tensors
and the plain PyTorch version in ``ref`` for CPU tensors.
"""
from .ops import (
    LAUNCHES,
    bucket_min,
    bucket_update,
    butterfly_combine,
    fused_count_tiles,
    reset_launches,
    wedge_histogram,
)

__all__ = [
    "LAUNCHES",
    "bucket_min",
    "bucket_update",
    "butterfly_combine",
    "fused_count_tiles",
    "reset_launches",
    "wedge_histogram",
]
