"""Controls of the correctness check: answers that must come out wrong.

The plain reference is put in the program's place and computed one step
below what the configuration states, and its answers are judged by the
same comparison as a run's (``compare.py``) against the int64 reference:

* ``int32``: every count accumulated in int32, which wraps;
* ``float32``: every count accumulated in float32, which rounds;
* ``bucketed`` (tip cells): each round peels every live vertex whose
  count is below twice the least one, as an approximate decomposition
  that skips re-settling would, and gives them all the least count.

For a count cell the control answers one count of the cell's mode; for
a tip cell one decomposition. Run on the card, from the root of a
checkout::

    python3 perfbench/control.py --workload graph500-s17.count-all \
        --seeds 11 12 13 --controls int32 float32

Each line printed is one seed and control with the numbers compared.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402

from perfbench.compare import count_diffs, value_diffs  # noqa: E402
from perfbench.generator import cell_graph  # noqa: E402
from perfbench.harness import load_json  # noqa: E402
from perfbench.reference.counting import count_all, ranges  # noqa: E402
from perfbench.reference.tips import (  # noqa: E402
    peel_side, side_csr, tip_numbers)

DTYPES = {"int32": torch.int32, "float32": torch.float32}


def bucketed_tips(n_u, n_v, edges, side, counts, device):
    """Tip numbers from rounds that peel ``[least, 2 * least)`` at once
    with no re-settling: an approximation, not the decomposition."""
    e = torch.as_tensor(edges, dtype=torch.int64, device=device)
    s, o = (e[:, 0], e[:, 1]) if side == 0 else (e[:, 1], e[:, 0])
    n_s, n_o = (n_u, n_v) if side == 0 else (n_v, n_u)
    s_off, s_nbr = side_csr(n_s, s, o)
    o_off, o_nbr = side_csr(n_o, o, s)
    cnt = torch.as_tensor(counts, device=device).clone()
    live = torch.ones(n_s, dtype=torch.bool, device=device)
    numbers = torch.zeros(n_s, dtype=torch.int64, device=device)
    level = torch.zeros((), dtype=torch.int64, device=device)
    big = torch.iinfo(torch.int64).max
    while bool(live.any()):
        low = torch.where(live, cnt, big).min()
        level = torch.maximum(level, low)
        peel = torch.nonzero(live & (cnt < 2 * low + 1)).squeeze(1)
        numbers[peel] = level
        live[peel] = False
        d1 = s_off[peel + 1] - s_off[peel]
        pos1 = ranges(s_off[peel], d1)
        u = torch.repeat_interleave(peel, d1, output_size=pos1.numel())
        v = s_nbr[pos1]
        d2 = o_off[v + 1] - o_off[v]
        pos2 = ranges(o_off[v], d2)
        u = torch.repeat_interleave(u, d2, output_size=pos2.numel())
        w = o_nbr[pos2]
        keep = live[w]
        pair, c = torch.unique(u[keep] * n_s + w[keep], return_counts=True)
        cnt.index_add_(0, pair % n_s, -(c * (c - 1) // 2))
    return numbers.cpu()


def readings(workload, seed, control, device):
    cell = load_json("workloads", workload)
    cfg = load_json("configs", cell["config"])
    mix = load_json("traffic", cell["traffic"])
    n_u, n_v, edges = cell_graph(cfg, seed)
    judge = count_all(n_u, n_v, edges, device=device)
    if mix["kind"] == "closed_peel":
        side = peel_side(n_u, n_v, edges)
        want = tip_numbers(n_u, n_v, edges, side,
                           judge.per_u if side == 0 else judge.per_v,
                           device=device).numbers.numpy()
        if control == "bucketed":
            got = bucketed_tips(n_u, n_v, edges, side,
                                judge.per_u if side == 0 else judge.per_v,
                                device)
        else:
            low = count_all(n_u, n_v, edges, dtype=DTYPES[control],
                            device=device)
            got = tip_numbers(n_u, n_v, edges, side,
                              low.per_u if side == 0 else low.per_v,
                              dtype=DTYPES[control], device=device).numbers
        return {"tip_diff": value_diffs(got.numpy(), want),
                "max_side_count": int((judge.per_u if side == 0
                                       else judge.per_v).max())}
    low = count_all(n_u, n_v, edges, dtype=DTYPES[control], device=device)
    out = count_diffs(low, judge, mix["call"]["mode"])
    out["total"] = judge.total
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="+", default=["int32"],
                   choices=sorted(DTYPES) + ["bucketed"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for control in args.controls:
            t = time.perf_counter()
            r = readings(args.workload, seed, control, "cuda")
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": control, "readings": r,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
