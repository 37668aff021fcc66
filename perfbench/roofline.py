"""Frozen roofline of the counting problem, independent of any kernel.

The least time an H100 SXM could take for one exact ``mode="all"``
count of a bipartite graph with ``n = n_u + n_v`` vertices, ``m`` edges
and ``W`` wedges under the degree order (each wedge taken once, from the
endpoint ranked before its centre and its other endpoint):

* bytes: each input byte read once and each output byte written once.
  The input is the edge list, ``8 m`` bytes (two int32 ids an edge); the
  output is the int64 total and the int64 per-vertex and per-edge
  counts, ``8 (1 + n + m)`` bytes;
* int32 operations: two for each wedge, one to form its endpoint pair
  and one to add it to the pair's group; the work per group and per
  output is left out, so the count is a floor.

``bound_s = max(bytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)`` at the
published H100 SXM rates (NVIDIA's data sheet, at the 700 W limit):
3.35e12 bytes/s of HBM3 and 16.7e12 int32 operations/s (132 SMs x 64
int32 lanes x 1.98 GHz boost). A kernel's share of this roofline is
``bound_s`` over the device time of all kernels one count launches.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "INT32_OPS_PER_S", "count_bytes",
           "count_ops", "count_bound"]

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12


def count_bytes(n: int, m: int) -> int:
    return 8 * m + 8 * (1 + n + m)


def count_ops(wedges: int) -> int:
    return 2 * wedges


def count_bound(n: int, m: int, wedges: int):
    """``(seconds, "bytes" | "ops")``: the least time and what sets it."""
    t_bytes = count_bytes(n, m) / HBM_BYTES_PER_S
    t_ops = count_ops(wedges) / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
