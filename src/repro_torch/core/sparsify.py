"""Approximate butterfly counting: the accuracy tier (paper §6).

Three estimators behind one entry point, :func:`approx_count`:

  - ``method="edges"``: edge sparsification (Sanei-Mehri et al. /
    paper §6): keep each edge independently w.p. ``p``; a butterfly
    survives iff its 4 edges do, so ``count(G_p) / p^4`` is unbiased.
  - ``method="colorful"``: colorful sparsification: color every
    vertex uniformly from ``N = round(1/p)`` colors and keep an edge
    iff its endpoints' colors match. A surviving butterfly needs all
    four vertices monochromatic, probability ``(1/N)^3`` given the
    first vertex, so ``count(G_c) * N^3`` is unbiased.
  - ``method="sample"``: the sublinear wedge-sampling estimator
    (:mod:`repro_torch.core.approx`): no counting pass at all.

A port of the reference package's tier: the thinning draws, the
sub-seeds and the host-side float arithmetic of the estimate and its
error bars are the reference's, in the same order, so a seed gives the
same estimate, bit for bit, in both packages. The sparsified graphs are
ordinary :class:`BipartiteGraph` values, so their counting runs through
the port's exact engines (``fused_cuda`` by default: the fused CUDA
kernel on the card, its plain version on a CPU tensor) under the full
resilience ladder (``COUNT_LADDERS``); the unbiasing scale is applied
on the host to the already-reduced integer total, and the returned
:class:`~repro_torch.core.resilience.ExecutionReport` records both the
tile plan and the estimator parameters (``report.estimator``).
Derivations, error-bar construction, and the ``eps`` ->
``p``/``n_samples`` mapping live in docs/APPROXIMATION.md.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from . import pipeline as _pipeline
from . import resilience as _res
from .approx import ApproxCount, SampleState, sample_count, samples_for_eps
from .device import resolve_device
from .graph import BipartiteGraph

__all__ = [
    "METHODS",
    "sparsify_edges",
    "sparsify_colorful",
    "approx_count",
    "approx_validator",
]

METHODS = ("edges", "colorful", "sample")
# historical spellings accepted by the pre-stub seed API
_METHOD_ALIASES = {"edge": "edges", "color": "colorful",
                   "colourful": "colorful", "sampling": "sample"}

_MIN_P = 0.05
_DEFAULT_REPS = 5
# two-sided 97.5% Student-t quantiles, indexed by degrees of freedom:
# the sparsify interval is an *empirical* t-interval over `reps`
# independent sub-seeded sparsifications, because the analytic
# independent-butterfly variance badly understates reality (butterfly
# co-survival through shared edges/wedges is strongly positively
# correlated — docs/APPROXIMATION.md §2.3)
_T975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571,
         6: 2.447, 7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228}


def _t975(dof: int) -> float:
    if dof <= 0:
        return float("inf")
    return _T975.get(dof, 1.96 + 2.0 / dof)


def _check_p(p: float) -> float:
    p = float(p)
    if not (0.0 < p <= 1.0):
        raise ValueError(f"sparsification p must be in (0, 1], got {p}")
    return p


def sparsify_edges(g: BipartiteGraph, p: float,
                   seed: int = 0) -> BipartiteGraph:
    """Edge sparsification: keep each edge independently w.p. ``p``
    (seeded, deterministic). ``p=1`` returns the graph's edge set
    unchanged. The result is a plain :class:`BipartiteGraph` (edges are
    a subset, hence already unique) ready for any exact engine."""
    p = _check_p(p)
    keep = np.random.default_rng(seed).random(g.m) < p
    return BipartiteGraph(
        g.n_u, g.n_v, g.edges[keep], on_duplicate="assume_unique"
    )


def colorful_classes(p: float) -> int:
    """Number of color classes for ``sparsify_colorful``:
    ``N = round(1/p)`` clamped to >= 1. The *effective* keep
    probability is ``1/N`` (recorded on :class:`ApproxCount` — e.g.
    ``p=0.3`` runs at ``1/3``)."""
    return max(1, int(round(1.0 / _check_p(p))))


def sparsify_colorful(g: BipartiteGraph, p: float,
                      seed: int = 0) -> BipartiteGraph:
    """Colorful sparsification: color U and V vertices uniformly from
    ``N = round(1/p)`` colors, keep an edge iff its endpoints match
    (seeded, deterministic). Butterfly survival probability is
    ``(1/N)^3``, not ``(1/N)^4`` — the match constraint ties the four
    edges together, which is exactly why colorful sparsification keeps
    more butterflies per retained edge than independent edge dropping
    (docs/APPROXIMATION.md §2.2)."""
    n_colors = colorful_classes(p)
    if n_colors == 1:
        return BipartiteGraph(
            g.n_u, g.n_v, g.edges.copy(), on_duplicate="assume_unique"
        )
    rng = np.random.default_rng(seed)
    color_u = rng.integers(0, n_colors, g.n_u)
    color_v = rng.integers(0, n_colors, g.n_v)
    keep = color_u[g.edges[:, 0]] == color_v[g.edges[:, 1]]
    return BipartiteGraph(
        g.n_u, g.n_v, g.edges[keep], on_duplicate="assume_unique"
    )


def _survival(method: str, p: float) -> float:
    """Butterfly survival probability q under the sparsifier."""
    return p ** 4 if method == "edges" else p ** 3


def _derive_p(g: BipartiteGraph, eps: float, method: str,
              seed: int) -> float:
    """``eps`` -> ``p``: pick p so the predicted relative standard
    error ``sqrt((1/q - 1) / B)`` of the scaled estimate is ~``eps``,
    using a cheap pilot sample estimate of B (docs/APPROXIMATION.md
    §4). Clamped to [0.05, 1]."""
    if not (0.0 < float(eps) < 1.0):
        raise ValueError(f"eps must be in (0, 1), got {eps}")
    pilot = sample_count(g, n_samples=512, seed=seed).estimate
    q_target = 1.0 / (1.0 + float(eps) ** 2 * max(pilot, 1.0))
    exponent = 4.0 if method == "edges" else 3.0
    return min(1.0, max(_MIN_P, q_target ** (1.0 / exponent)))


def approx_validator(g: BipartiteGraph):
    """Ladder validator for the sampling rung: the estimate must be a
    finite non-negative number no larger than the C(min(w_u, w_v), 2)
    bound any exact count also obeys."""
    w_u, w_v = g.wedge_totals()
    w = min(w_u, w_v)
    ub = float(w * (w - 1) // 2)

    def check(out) -> Optional[str]:
        est = float(out.estimate)
        if not math.isfinite(est) or est < 0:
            return f"non-finite or negative estimate {est}"
        if est > max(ub, 0.0):
            return f"estimate {est} exceeds the C(W, 2) bound {ub}"
        return None

    return check


def approx_count(
    g: BipartiteGraph,
    p: Optional[float] = None,
    method: str = "colorful",
    seed: int = 0,
    order: str = "degree",
    aggregation: str = "sort",
    count_dtype=None,
    *,
    eps: Optional[float] = None,
    n_samples: Optional[int] = None,
    reps: int = _DEFAULT_REPS,
    engine: str = "fused_cuda",
    max_chunk=None,
    resilience=None,
    sample_state: Optional[SampleState] = None,
    device=None,
) -> ApproxCount:
    """Unbiased estimate of the global butterfly count with reported
    error bars — the accuracy tier's entry point.

    ``method`` selects the estimator (``"edges"`` / ``"colorful"`` /
    ``"sample"``; the seed spellings ``"edge"``/``"color"`` still
    resolve). For the sparsify methods ``p`` is the keep probability
    (derived from ``eps`` via a pilot sample when omitted): ``reps``
    independent sub-seeded sparsifications are each counted through
    the exact engine matrix (``fused_cuda`` by default) under the
    resilience ladder, the 1/p^4 or N^3 scale is applied host-side to
    each reduced integer total, and the reported value is their mean
    with an *empirical* Student-t 95% interval (honest under the
    strong butterfly co-survival correlation that breaks the
    independent-butterfly variance formula). For ``method="sample"``
    the sublinear estimator runs as a single zero-cost ladder rung
    (``n_samples`` overrides the ``eps``-derived budget;
    ``sample_state`` reuses a resident
    :class:`~repro_torch.core.approx.SampleState`). ``device`` is
    where the thinned graphs are counted (``None`` means CUDA, and
    raises without a card, for every method; pass ``device="cpu"`` for
    the host).

    Returns :class:`~repro_torch.core.approx.ApproxCount`; ``.report`` is
    the :class:`~repro_torch.core.resilience.ExecutionReport` with
    ``report.estimator`` recording the estimator parameters and (for
    the sparsify methods) ``report.plan`` the tile plan the counting
    rung executed. Deterministic per ``seed``.
    """
    method = _METHOD_ALIASES.get(method, method)
    if method not in METHODS:
        raise ValueError(
            f"method must be one of {METHODS} "
            f"(aliases: {sorted(_METHOD_ALIASES)}), got {method!r}"
        )
    device = resolve_device(device)

    if method == "sample":
        if p is not None:
            raise ValueError(
                "method='sample' takes eps/n_samples, not a keep "
                "probability p (p is for the sparsify methods)"
            )
        policy = _res.resolve_policy(resilience)
        state = (sample_state if sample_state is not None
                 else SampleState.build(g))
        n = (samples_for_eps(0.1 if eps is None else eps)
             if n_samples is None else int(n_samples))

        def run(_shrinks):
            return sample_count(state, eps=eps, n_samples=n, seed=seed)

        rung = _res.Rung("sample", run, shrinkable=False, zero_cost=True)
        out, report = _pipeline.execute_ladder(
            "approx_count", policy, [rung], approx_validator(g),
        )
        report.estimator = out.describe()
        if policy.attach_report:
            out = out._replace(report=report)
        return out

    # sparsify methods
    if p is None:
        p = _derive_p(g, 0.1 if eps is None else eps, method, seed)
    p = _check_p(p)
    if int(reps) < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if method == "edges":
        sparsifier, p_eff = sparsify_edges, p
        scale = 1.0 / _survival("edges", p)
    else:
        n_colors = colorful_classes(p)
        sparsifier, p_eff = sparsify_colorful, 1.0 / n_colors
        scale = float(n_colors) ** 3
    if _survival(method, p_eff) >= 1.0:
        reps = 1  # p = 1 is exact: repetitions are identical

    # exact counting over the thinned graphs: the full rank -> plan ->
    # fused-tile-loop pipeline under the resilience ladder; import here
    # (not at module top) keeps the frontends' import graph acyclic
    from .count import count_butterflies, default_count_dtype

    sub_seeds = np.random.default_rng(seed).integers(
        0, 2 ** 63 - 1, size=int(reps)
    )
    ests = []
    report = None
    kept_m = 0
    for s in sub_seeds:
        gs = sparsifier(g, p, seed=int(s))
        kept_m = gs.m
        if gs.m < 4:
            ests.append(0.0)  # a butterfly needs 4 edges
            continue
        res = count_butterflies(
            gs,
            order=order,
            aggregation=aggregation,
            mode="global",
            count_dtype=count_dtype or default_count_dtype(),
            engine=engine,
            max_chunk=max_chunk,
            resilience=resilience,
            device=device,
        )
        ests.append(float(int(np.asarray(res.total))) * scale)
        if res.report is not None:
            report = res.report  # last rep's audit trail
    n_reps = len(ests)
    estimate = float(np.mean(ests))
    if _survival(method, p_eff) >= 1.0:
        stddev = 0.0  # exact: p = 1 keeps every butterfly
    elif n_reps > 1:
        stderr = float(np.std(ests, ddof=1)) / math.sqrt(n_reps)
        # floor at one estimator quantum: `reps` identical sub-counts
        # do not prove zero variance on a discrete scale-valued lattice
        stddev = max(stderr, scale / n_reps)
    else:
        # single repetition: no empirical spread — fall back to the
        # independent-butterfly approximation (documented as a lower
        # bound on the real variance; prefer reps >= 2)
        q = _survival(method, p_eff)
        stddev = math.sqrt(max(estimate, 1.0) * (1.0 - q) / q)
    ci95 = _t975(n_reps - 1) * stddev if stddev > 0 else 0.0
    if n_reps == 1:
        ci95 = 1.96 * stddev
    out = ApproxCount(
        estimate=estimate,
        stddev=stddev,
        ci95=ci95,
        n_samples=0,
        method=method,
        p=p_eff,
        eps=eps,
        seed=seed,
        report=report,
    )
    if report is not None:
        report.estimator = (
            out.describe()
            + f", scale={'1/p^4' if method == 'edges' else 'N^3'}"
            + f"={scale:.6g}, reps={n_reps}, kept_m={kept_m}/{g.m}"
        )
    return out
