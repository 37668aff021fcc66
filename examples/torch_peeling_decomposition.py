"""Dense-subgraph discovery via tip/wing decomposition (paper §3.2),
with the PyTorch/CUDA port.

The counterpart of ``examples/peeling_decomposition.py``: the same graph,
calls and lines, on the card by default.

    PYTHONPATH=src python examples/torch_peeling_decomposition.py
    PYTHONPATH=src python examples/torch_peeling_decomposition.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.device import resolve_device
from repro_torch.core.peel import peel_tips, peel_wings
from repro_torch.data.graphs import powerlaw_bipartite


def histogram(numbers) -> list:
    ks, counts = np.unique(numbers, return_counts=True)
    return [[int(k), int(c)] for k, c in zip(ks, counts)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # no CPU fallback: raises without a card

    g = powerlaw_bipartite(n_u=1200, n_v=1000, m=8000, seed=7)
    print(f"graph: |U|={g.n_u} |V|={g.n_v} m={g.m}")

    tips = peel_tips(g, device=dev)
    side = "U" if tips.side == 0 else "V"
    print(f"tip decomposition over {side}: ρ_v={tips.rounds} rounds")
    th = histogram(tips.numbers)
    for k, c in th[-5:]:
        print(f"  {c:5d} vertices with tip number {k}")
    k, c = th[-1]
    print(f"  densest k-tip: k={k} "
          f"({c} vertices mutually in ≥{k} butterflies)")

    wings = peel_wings(g, device=dev)
    print(f"wing decomposition: ρ_e={wings.rounds} rounds")
    wh = histogram(wings.numbers)
    print(f"  max wing number: {wh[-1][0]} ({wh[-1][1]} edges)")
    return {"n_u": g.n_u, "n_v": g.n_v, "m": g.m, "tip_side": int(tips.side),
            "tip_rounds": int(tips.rounds), "tip_histogram": th,
            "wing_rounds": int(wings.rounds), "wing_histogram": wh}


if __name__ == "__main__":
    main()
