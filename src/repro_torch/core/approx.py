"""Sublinear wedge-sampling butterfly estimator (beyond the paper).

A copy of the reference package's estimator: host numpy only, with the
same ``numpy.random.Generator`` draws in the same order, so a seed gives
the same sample, estimate and error bars in both packages.

The sparsification estimators (:mod:`repro_torch.core.sparsify`) still
pay a full counting pass over the thinned graph. This module goes
sublinear: it never enumerates wedges at all. One sample is

  1. a uniformly random wedge ``(x1, c, x2)``: center ``c`` drawn with
     probability proportional to ``C(deg c, 2)`` from the *priority*
     center side, then a uniform unordered neighbor pair ``(x1, x2)``;
  2. one closure probe in the Wang-style priority order (retrieve from
     the lower-degree endpoint so per-sample work and variance are
     bounded by ``min(deg x1, deg x2)``): draw a second center ``c'``
     uniformly from ``N(x_lo) \\ {c}`` and binary-search whether
     ``c'`` also neighbors ``x_hi``.

With ``d`` the common-neighbor count of the endpoint pair, the probe
closes with probability ``(d - 1) / (deg x_lo - 1)``, so
``X = (deg x_lo - 1) * closed`` has ``E[X] = d - 1``. Over a uniform
wedge ``E[d - 1] = 2 B / W`` (each of the ``B`` butterflies owns
exactly two wedges centered on the chosen side, of ``W`` total), hence

    estimate = (W / 2) * mean(X)        (unbiased; docs/APPROXIMATION.md)

Error bars are the CLT interval ``1.96 * (W/2) * std(X)/sqrt(n)``
widened by a rule-of-three floor for the few-successes regime. Per-sample
cost is O(log deg) after an O(m log m) one-time :class:`SampleState`
build that the serving layer amortizes across queries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np

from .graph import BipartiteGraph
from .resilience import ExecutionReport

__all__ = [
    "ApproxCount",
    "SampleState",
    "sample_count",
    "samples_for_eps",
]

# CLT multiplier for the reported 95% interval
_Z95 = 1.96
# eps -> n mapping constant: n = ceil(_EPS_C / eps^2) (Chebyshev-style
# budget; the *reported* interval is always measured, never assumed)
_EPS_C = 8.0
_MIN_SAMPLES = 64


class ApproxCount(NamedTuple):
    """An approximate butterfly count with concentration-bound error
    bars. ``estimate`` is unbiased for the true global count;
    ``ci95`` is the half-width of the reported 95% interval
    (``estimate ± ci95``). ``p`` is the effective sparsification
    probability (None for the sampling estimator); ``n_samples`` the
    wedge samples drawn (0 for the sparsify methods)."""

    estimate: float
    stddev: float
    ci95: float
    n_samples: int
    method: str = "sample"
    p: Optional[float] = None
    eps: Optional[float] = None
    seed: int = 0
    report: Optional[ExecutionReport] = None

    def describe(self) -> str:
        """One-line estimator-parameter record (stamped onto
        ``ExecutionReport.estimator`` by the frontends)."""
        parts = [f"method={self.method}"]
        if self.p is not None:
            parts.append(f"p={self.p:.4g}")
        if self.eps is not None:
            parts.append(f"eps={self.eps:.4g}")
        if self.n_samples:
            parts.append(f"n={self.n_samples}")
        parts.append(f"seed={self.seed}")
        return f"approx({', '.join(parts)})"

    def covers(self, true_count: float) -> bool:
        return abs(self.estimate - float(true_count)) <= self.ci95


def samples_for_eps(eps: float) -> int:
    """Sample budget for a relative-error target ``eps``:
    ``n = max(64, ceil(8 / eps^2))``. The budget is Chebyshev-flavored
    guidance, not a guarantee — the returned interval is always
    computed from the drawn samples (docs/APPROXIMATION.md §3)."""
    if not (0.0 < float(eps) < 1.0):
        raise ValueError(f"eps must be in (0, 1), got {eps}")
    return max(_MIN_SAMPLES, int(math.ceil(_EPS_C / float(eps) ** 2)))


@dataclasses.dataclass(frozen=True)
class SampleState:
    """Resident sampling state for one graph: both CSR adjacencies
    (neighbor lists ascending, so closure probes are binary searches)
    plus the center-side wedge weights. Build once (O(m log m)),
    sample many — the serving layer keeps one per registered graph."""

    center_side: int  # 0 = centers in U, 1 = centers in V
    w_total: int  # sum of C(deg c, 2) over the center side
    c_indptr: np.ndarray  # center-side CSR offsets
    c_indices: np.ndarray  # center-side neighbors (endpoint ids)
    e_indptr: np.ndarray  # endpoint-side CSR offsets
    e_indices: np.ndarray  # endpoint-side neighbors (center ids)
    c_cumw: np.ndarray  # cumulative C(deg, 2) over centers

    @classmethod
    def build(cls, g: BipartiteGraph) -> "SampleState":
        e = g.edges
        deg_u = np.bincount(e[:, 0], minlength=g.n_u).astype(np.int64)
        deg_v = np.bincount(e[:, 1], minlength=g.n_v).astype(np.int64)
        w_u = int((deg_u * (deg_u - 1) // 2).sum())  # centers in U
        w_v = int((deg_v * (deg_v - 1) // 2).sum())  # centers in V
        # Wang-style priority choice of the retrieval side: centers on
        # the side with the smaller wedge total, so the W multiplier
        # (and with it the absolute variance) is minimized.
        center_side = 0 if w_u <= w_v else 1
        ci, ei = (0, 1) if center_side == 0 else (1, 0)
        n_c = g.n_u if center_side == 0 else g.n_v
        n_e = g.n_v if center_side == 0 else g.n_u
        deg_c = deg_u if center_side == 0 else deg_v
        deg_e = deg_v if center_side == 0 else deg_u

        order_c = np.lexsort((e[:, ei], e[:, ci]))
        c_indices = e[order_c, ei]
        c_indptr = np.zeros(n_c + 1, np.int64)
        np.cumsum(deg_c, out=c_indptr[1:])
        order_e = np.lexsort((e[:, ci], e[:, ei]))
        e_indices = e[order_e, ci]
        e_indptr = np.zeros(n_e + 1, np.int64)
        np.cumsum(deg_e, out=e_indptr[1:])

        wc = deg_c * (deg_c - 1) // 2
        return cls(
            center_side=center_side,
            w_total=int(wc.sum()),
            c_indptr=c_indptr,
            c_indices=c_indices,
            e_indptr=e_indptr,
            e_indices=e_indices,
            c_cumw=np.cumsum(wc),
        )

    def endpoint_degree(self, x: np.ndarray) -> np.ndarray:
        return self.e_indptr[x + 1] - self.e_indptr[x]


def _searchsorted_rows(values: np.ndarray, lo: np.ndarray,
                       hi: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Vectorized per-row ``searchsorted``: for each i, the insertion
    point of ``targets[i]`` in the ascending slice
    ``values[lo[i]:hi[i]]`` (returned as an absolute index). Exploits
    that slices are ascending runs of one global array: bisect on a
    keyed composite is wrong near run boundaries, so do a plain
    per-row bisection vectorized over rows — O(n log maxdeg) numpy."""
    lo = lo.astype(np.int64).copy()
    hi = hi.astype(np.int64).copy()
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        less = np.zeros_like(active)
        less[active] = values[mid[active]] < targets[active]
        lo = np.where(active & less, mid + 1, lo)
        hi = np.where(active & ~less, mid, hi)
    return lo


def sample_count(
    g_or_state,
    *,
    eps: Optional[float] = None,
    n_samples: Optional[int] = None,
    seed: int = 0,
) -> ApproxCount:
    """Sublinear wedge-sampling estimate of the global butterfly count
    (module docstring for the estimator; docs/APPROXIMATION.md for the
    derivation). Accepts a :class:`~repro_torch.core.graph.BipartiteGraph`
    or a prebuilt :class:`SampleState`. ``n_samples`` overrides the
    ``eps``-derived budget. Deterministic per ``seed``."""
    state = (g_or_state if isinstance(g_or_state, SampleState)
             else SampleState.build(g_or_state))
    if n_samples is None:
        n = samples_for_eps(0.1 if eps is None else eps)
    else:
        n = int(n_samples)
        if n < 1:
            raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    if state.w_total == 0:
        # no wedges -> no butterflies, exactly
        return ApproxCount(0.0, 0.0, 0.0, 0, "sample", None, eps, seed)

    rng = np.random.default_rng(seed)
    half_w = state.w_total / 2.0

    # 1. centers ~ C(deg, 2): invert the cumulative weight at a uniform
    #    integer (exact — integer weights, no float rounding)
    r = rng.integers(0, state.w_total, size=n)
    centers = np.searchsorted(state.c_cumw, r, side="right")
    off = state.c_indptr[centers]
    deg = (state.c_indptr[centers + 1] - off).astype(np.int64)

    # 2. uniform unordered neighbor pair of each center: a uniform
    #    ordered distinct pair (a, b) via the shift trick
    a = rng.integers(0, deg)
    b = rng.integers(0, deg - 1)
    b = b + (b >= a)
    x1 = state.c_indices[off + a]
    x2 = state.c_indices[off + b]

    # 3. Wang-style priority probe: from the lower-degree endpoint
    d1 = state.endpoint_degree(x1)
    d2 = state.endpoint_degree(x2)
    swap = d2 < d1
    x_lo = np.where(swap, x2, x1)
    x_hi = np.where(swap, x1, x2)
    deg_lo = np.where(swap, d2, d1)

    # draw c' uniform from N(x_lo) \ {c}; deg_lo >= 1 always (x_lo has
    # the sampled center as a neighbor), deg_lo == 1 -> X = 0
    lo_off = state.e_indptr[x_lo]
    lo_hi = state.e_indptr[x_lo + 1]
    pos_c = _searchsorted_rows(state.e_indices, lo_off, lo_hi, centers)
    span = np.maximum(deg_lo - 1, 1)
    t = rng.integers(0, span)
    t = t + (t >= (pos_c - lo_off))
    c_probe = state.e_indices[np.minimum(lo_off + t, lo_hi - 1)]

    hi_off = state.e_indptr[x_hi]
    hi_hi = state.e_indptr[x_hi + 1]
    ins = _searchsorted_rows(state.e_indices, hi_off, hi_hi, c_probe)
    closed = (ins < hi_hi) & (
        state.e_indices[np.minimum(ins, state.e_indices.shape[0] - 1)]
        == c_probe
    )
    usable = deg_lo > 1
    x = np.where(usable & closed, (deg_lo - 1).astype(np.float64), 0.0)

    mean_x = float(x.mean())
    estimate = half_w * mean_x
    if n > 1:
        se_clt = float(x.std(ddof=1)) / math.sqrt(n)
    else:
        se_clt = float(x[0])  # one sample: the value is its own scale
    stddev = half_w * se_clt
    # few-successes floor (docs/APPROXIMATION.md §3): with k hits the
    # relative uncertainty cannot honestly be below ~1/sqrt(k); with
    # k = 0 the rule-of-three upper bound 3/n on the hit rate applies,
    # scaled by the mean probe range.
    k = int(np.count_nonzero(x))
    if k > 0:
        floor = estimate / math.sqrt(k) / _Z95
    else:
        floor = half_w * (3.0 / n) * float(
            np.maximum(deg_lo - 1, 0).mean()
        ) / _Z95
    ci95 = _Z95 * max(stddev, floor)
    return ApproxCount(
        estimate=estimate,
        stddev=max(stddev, floor),
        ci95=ci95,
        n_samples=n,
        method="sample",
        p=None,
        eps=eps,
        seed=seed,
    )
