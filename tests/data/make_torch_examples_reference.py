"""Regenerate ``tests/data/torch_examples_reference.json``.

The pin that the port's three examples (``examples/torch_quickstart.py``,
``examples/torch_peeling_decomposition.py`` and
``examples/torch_end_to_end_analytics.py``) are held against, on the card
by ``chip_smoke.py`` and on the CPU by ``tests/test_torch_examples.py``.
It runs the JAX package's *library* on the CPU with each example's
graphs and arguments (int64 counts with ``jax_enable_x64`` set in this
process only, as the reference examples set it), not the reference
scripts: two of those stop at their approximate line, which formats the
``ApproxCount`` that ``approx_count`` returns as a number.

Each entry holds the example's command-line arguments, the ``values``
its ``main`` returns, and the ``lines`` it prints, with every bracketed
span (a stage's clock time, a step's seconds) removed. The lines are
rendered here from the reference's values with the port examples' own
formats, so every printed number is pinned:

  - ``quickstart``: the six global totals (two rankings x three
    aggregations), the largest per-vertex and per-edge counts, the
    brute-force ``global_count`` and the colorful estimates with their
    ``ci95`` at p = 0.25 and 0.5;
  - ``peeling_decomposition``: the tip and wing decompositions' rounds
    and full histograms;
  - ``end_to_end_analytics``: at its defaults (1,000,000 edges, a
    30,000-edge peel) and at ``--edges 20000 --peel-edges 3000``, the
    size the CPU test runs.

Run from the repository root, with JAX on the CPU (several minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_examples_reference.py
"""
import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import count_butterflies  # noqa: E402
from repro.core.oracle import global_count  # noqa: E402
from repro.core.peel import peel_tips, peel_wings  # noqa: E402
from repro.core.sparsify import approx_count  # noqa: E402
from repro.data.graphs import powerlaw_bipartite  # noqa: E402

COMMAND = ("JAX_PLATFORMS=cpu PYTHONPATH=src python "
           "tests/data/make_torch_examples_reference.py")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_examples_reference.json")
END_TO_END_SIZES = ((20_000, 3_000), (1_000_000, 30_000))


def quickstart() -> dict:
    g = powerlaw_bipartite(n_u=3000, n_v=2500, m=20000, seed=42)
    lines = [f"graph: |U|={g.n_u} |V|={g.n_v} m={g.m}"]
    totals = {}
    for order in ("side", "degree"):
        for agg in ("sort", "hash", "batch"):
            r = count_butterflies(g, order=order, aggregation=agg)
            totals[f"{order}/{agg}"] = int(r.total)
            lines.append(f"  {order:8s}/{agg:6s}: {int(r.total):,} butterflies")
    rv = count_butterflies(g, mode="vertex")
    re_ = count_butterflies(g, mode="edge")
    u, v = int(np.max(rv.per_u)), int(np.max(rv.per_v))
    e = int(np.max(re_.per_edge))
    lines.append(f"  max per-vertex: U={u:,} V={v:,}")
    lines.append(f"  max per-edge:   {e:,}")
    exact = global_count(g)
    colorful = {}
    for p in (0.25, 0.5):
        est = approx_count(g, p, method="colorful", seed=0)
        colorful[str(p)] = {"estimate": est.estimate, "ci95": est.ci95}
        lines.append(
            f"  colorful p={p}: est={est.estimate:,.0f} ± {est.ci95:,.0f} "
            f"(exact {exact:,}, err {abs(est.estimate - exact) / exact:.1%})")
    values = {"n_u": g.n_u, "n_v": g.n_v, "m": g.m, "totals": totals,
              "max_per_u": u, "max_per_v": v, "max_per_edge": e,
              "global_count": exact, "colorful": colorful}
    return {"argv": [], "values": values, "lines": lines}


def histogram(numbers) -> list:
    ks, counts = np.unique(np.asarray(numbers), return_counts=True)
    return [[int(k), int(c)] for k, c in zip(ks, counts)]


def peeling_decomposition() -> dict:
    g = powerlaw_bipartite(n_u=1200, n_v=1000, m=8000, seed=7)
    lines = [f"graph: |U|={g.n_u} |V|={g.n_v} m={g.m}"]
    tips = peel_tips(g)
    side = "U" if tips.side == 0 else "V"
    lines.append(f"tip decomposition over {side}: ρ_v={tips.rounds} rounds")
    th = histogram(tips.numbers)
    for k, c in th[-5:]:
        lines.append(f"  {c:5d} vertices with tip number {k}")
    k, c = th[-1]
    lines.append(f"  densest k-tip: k={k} "
                 f"({c} vertices mutually in ≥{k} butterflies)")
    wings = peel_wings(g)
    lines.append(f"wing decomposition: ρ_e={wings.rounds} rounds")
    wh = histogram(wings.numbers)
    lines.append(f"  max wing number: {wh[-1][0]} ({wh[-1][1]} edges)")
    values = {"n_u": g.n_u, "n_v": g.n_v, "m": g.m, "tip_side": int(tips.side),
              "tip_rounds": int(tips.rounds), "tip_histogram": th,
              "wing_rounds": int(wings.rounds), "wing_histogram": wh}
    return {"argv": [], "values": values, "lines": lines}


def end_to_end_analytics(edges: int, peel_edges: int) -> dict:
    lines = [f" generating power-law graph with {edges:,} edges"]
    g = powerlaw_bipartite(edges // 8, edges // 10, edges, seed=0)
    lines.append(f"  |U|={g.n_u:,} |V|={g.n_v:,} m={g.m:,}")
    lines.append(" global count (degree order, sort aggregation)")
    r = count_butterflies(g, order="degree", aggregation="sort",
                          count_dtype=jnp.int64)
    total = int(r.total)
    lines.append(f"  {total:,} butterflies")
    lines.append(" per-vertex counts")
    rv = count_butterflies(g, mode="vertex", count_dtype=jnp.int64)
    mv = int(max(np.max(rv.per_u), np.max(rv.per_v)))
    lines.append(f"  max per-vertex {mv:,}")
    lines.append(" per-edge counts")
    re_ = count_butterflies(g, mode="edge", count_dtype=jnp.int64)
    me = int(np.max(re_.per_edge))
    lines.append(f"  max per-edge {me:,}")
    lines.append(" approximate count (colorful, p=0.2)")
    est = approx_count(g, 0.2, method="colorful", count_dtype=jnp.int64)
    err = abs(est.estimate - total) / max(total, 1)
    lines.append(f"  est {est.estimate:,.0f} ± {est.ci95:,.0f} (err {err:.1%})")
    lines.append(f" tip decomposition on a {peel_edges:,}-edge subgraph")
    gp = powerlaw_bipartite(peel_edges // 6, peel_edges // 8, peel_edges,
                            seed=1)
    tips = peel_tips(gp)
    max_tip = int(np.max(tips.numbers))
    lines.append(f"  ρ_v={tips.rounds} rounds, max tip {max_tip:,}")
    lines.append(" done")
    values = {"n_u": g.n_u, "n_v": g.n_v, "m": g.m, "total": total,
              "max_per_vertex": mv, "max_per_edge": me,
              "colorful": {"estimate": est.estimate, "ci95": est.ci95},
              "peel_m": gp.m, "tip_rounds": int(tips.rounds),
              "max_tip": max_tip}
    return {"argv": ["--edges", str(edges), "--peel-edges", str(peel_edges)],
            "values": values, "lines": lines}


def timed(fn, *args) -> dict:
    t0 = time.perf_counter()
    out = fn(*args)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    out = {
        "how": COMMAND,
        "quickstart": timed(quickstart),
        "peeling_decomposition": timed(peeling_decomposition),
        "end_to_end_analytics": [timed(end_to_end_analytics, e, p)
                                 for e, p in END_TO_END_SIZES],
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True, ensure_ascii=False)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
