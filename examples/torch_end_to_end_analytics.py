"""End-to-end example: the full graph-analytics pipeline on a
million-edge bipartite graph — generate, rank, count (global/vertex/
edge), approximate, and peel — with wall-clock reporting, with the
PyTorch/CUDA port.

The counterpart of ``examples/end_to_end_analytics.py``: the same graphs,
calls, knobs and lines, on the card by default. The approximate line
prints the estimate and the half-width ``ci95`` of its 95% interval.

    PYTHONPATH=src python examples/torch_end_to_end_analytics.py [--edges N]
    PYTHONPATH=src python examples/torch_end_to_end_analytics.py --device cpu \\
        --edges 20000 --peel-edges 3000
"""
import argparse
import time

import torch

from repro_torch.core import count_butterflies
from repro_torch.core.peel import peel_tips
from repro_torch.core.device import resolve_device
from repro_torch.core.sparsify import approx_count
from repro_torch.data.graphs import powerlaw_bipartite


def stage(name):
    print(f"[{time.strftime('%H:%M:%S')}] {name}", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", type=int, default=1_000_000)
    ap.add_argument("--peel-edges", type=int, default=30_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # no CPU fallback: raises without a card

    stage(f"generating power-law graph with {args.edges:,} edges")
    g = powerlaw_bipartite(
        args.edges // 8, args.edges // 10, args.edges, seed=0
    )
    print(f"  |U|={g.n_u:,} |V|={g.n_v:,} m={g.m:,}")

    stage("global count (degree order, sort aggregation)")
    t0 = time.perf_counter()
    r = count_butterflies(
        g, order="degree", aggregation="sort", count_dtype=torch.int64,
        device=dev,
    )
    total = int(r.total)
    print(f"  {total:,} butterflies  [{time.perf_counter()-t0:.2f}s]")

    stage("per-vertex counts")
    t0 = time.perf_counter()
    rv = count_butterflies(g, mode="vertex", count_dtype=torch.int64,
                           device=dev)
    mv = int(max(rv.per_u.max(), rv.per_v.max()))
    print(f"  max per-vertex {mv:,}  [{time.perf_counter()-t0:.2f}s]")

    stage("per-edge counts")
    t0 = time.perf_counter()
    re_ = count_butterflies(g, mode="edge", count_dtype=torch.int64,
                            device=dev)
    me = int(re_.per_edge.max())
    print(f"  max per-edge {me:,}  [{time.perf_counter()-t0:.2f}s]")

    stage("approximate count (colorful, p=0.2)")
    t0 = time.perf_counter()
    est = approx_count(g, 0.2, method="colorful", count_dtype=torch.int64,
                       device=dev)
    err = abs(est.estimate - total) / max(total, 1)
    print(f"  est {est.estimate:,.0f} ± {est.ci95:,.0f} (err {err:.1%})  "
          f"[{time.perf_counter()-t0:.2f}s]")

    stage(f"tip decomposition on a {args.peel_edges:,}-edge subgraph")
    gp = powerlaw_bipartite(
        args.peel_edges // 6, args.peel_edges // 8, args.peel_edges, seed=1
    )
    t0 = time.perf_counter()
    tips = peel_tips(gp, device=dev)
    max_tip = int(tips.numbers.max())
    print(f"  ρ_v={tips.rounds} rounds, max tip {max_tip:,}"
          f"  [{time.perf_counter()-t0:.2f}s]")
    stage("done")
    return {"n_u": g.n_u, "n_v": g.n_v, "m": g.m, "total": total,
            "max_per_vertex": mv, "max_per_edge": me,
            "colorful": {"estimate": est.estimate, "ci95": est.ci95},
            "peel_m": gp.m, "tip_rounds": int(tips.rounds),
            "max_tip": max_tip}


if __name__ == "__main__":
    main()
