"""How a program's answer is held against the reference's: by the number
of values that differ, whose limit is 0 (the counts and tip numbers are
exact integers)."""
from __future__ import annotations

import numpy as np

__all__ = ["count_diffs", "value_diffs"]

FIELDS = {"global": ("total",), "vertex": ("per_u", "per_v"),
          "edge": ("per_edge",), "all": ("total", "per_u", "per_v",
                                         "per_edge")}
GROUP = {"total": "total_diff", "per_u": "vertex_diff",
         "per_v": "vertex_diff", "per_edge": "edge_diff"}


def value_diffs(got, want) -> int:
    """Values of ``got`` that differ from ``want`` (every value when the
    shapes differ or ``got`` is missing)."""
    want = np.asarray(want)
    if got is None:
        return max(int(want.size), 1)
    got = np.asarray(got)
    if got.shape != want.shape:
        return max(int(want.size), 1)
    return int(np.count_nonzero(got.astype(np.int64) != want))


def count_diffs(result, ref, mode: str) -> dict:
    """``{"total_diff", "vertex_diff", "edge_diff"}`` of one counting
    answer for ``mode`` against the reference's ``Counts``."""
    out = {"total_diff": 0, "vertex_diff": 0, "edge_diff": 0}
    for field in FIELDS[mode]:
        want = getattr(ref, field)
        want = np.asarray(want if field == "total" else want.numpy())
        out[GROUP[field]] += value_diffs(getattr(result, field, None), want)
    return out
