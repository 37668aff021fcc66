"""Quickstart: butterfly counting on a bipartite graph, with the
PyTorch/CUDA port.

The counterpart of ``examples/quickstart.py``: the same graph, calls and
lines, on the card by default. Each colorful estimate prints its
``estimate`` and the half-width ``ci95`` of its 95% interval.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import count_butterflies
from repro_torch.core.oracle import global_count
from repro_torch.core.device import resolve_device
from repro_torch.core.sparsify import approx_count
from repro_torch.data.graphs import powerlaw_bipartite


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # no CPU fallback: raises without a card

    g = powerlaw_bipartite(n_u=3000, n_v=2500, m=20000, seed=42)
    print(f"graph: |U|={g.n_u} |V|={g.n_v} m={g.m}")

    # global count, three strategies, two rankings
    totals = {}
    for order in ("side", "degree"):
        for agg in ("sort", "hash", "batch"):
            r = count_butterflies(g, order=order, aggregation=agg, device=dev)
            totals[f"{order}/{agg}"] = int(r.total)
            print(f"  {order:8s}/{agg:6s}: {int(r.total):,} butterflies")

    # per-vertex / per-edge
    rv = count_butterflies(g, mode="vertex", device=dev)
    re_ = count_butterflies(g, mode="edge", device=dev)
    u, v, e = int(rv.per_u.max()), int(rv.per_v.max()), int(re_.per_edge.max())
    print(f"  max per-vertex: U={u:,} V={v:,}")
    print(f"  max per-edge:   {e:,}")

    # approximate counting via sparsification (paper §4.4)
    exact = global_count(g)
    colorful = {}
    for p in (0.25, 0.5):
        est = approx_count(g, p, method="colorful", seed=0, device=dev)
        colorful[str(p)] = {"estimate": est.estimate, "ci95": est.ci95}
        print(f"  colorful p={p}: est={est.estimate:,.0f} ± {est.ci95:,.0f} "
              f"(exact {exact:,}, "
              f"err {abs(est.estimate - exact) / exact:.1%})")
    return {"n_u": g.n_u, "n_v": g.n_v, "m": g.m, "totals": totals,
            "max_per_u": u, "max_per_v": v, "max_per_edge": e,
            "global_count": int(exact), "colorful": colorful}


if __name__ == "__main__":
    main()
