#!/usr/bin/env python3
"""Where ``fused_count_tiles`` spends its device time at the smoke shape.

Runs on one CUDA card, from the repository root:

    python3 scripts/torch_fused_probe.py [--direction low|high] \
        [--mode all|global|vertex|edge] [--l2-mib 24 12 48] \
        [--in-flight 32 8]

It builds the smoke graph of ``chip_smoke.py`` (``powerlaw_bipartite(
200_000, 150_000, 2_000_000, seed=7)``, degree order), plans the
``fused_cuda`` tiles at the auto budget, holds the kernel against its
plain version once, bit for bit, and then, for each heavy-counter budget
in ``--l2-mib`` (``kernels/cuda.FUSED_L2_BYTES``, MiB) and each cap in
``--in-flight`` (``FUSED_MAX_IN_FLIGHT``), prints the work list's shape,
the card ms per call (CUDA events), the device ms of each of its two
kernels (``torch.profiler``) and the host µs per call. The card's name
and power limit lead the output.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.graph import preprocess  # noqa: E402
from repro_torch.core.pipeline import fused_host_inputs, plan_count  # noqa: E402
from repro_torch.core.ranking import make_order  # noqa: E402
from repro_torch.core.wedges import (  # noqa: E402
    auto_chunk_budget, device_graph, host_wedge_counts,
)
from repro_torch.data.graphs import powerlaw_bipartite  # noqa: E402
from repro_torch.kernels import cuda as kcuda  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--direction", default="low", choices=("low", "high"))
    ap.add_argument("--mode", default="all",
                    choices=("all", "global", "vertex", "edge"))
    ap.add_argument("--l2-mib", type=int, nargs="+",
                    default=[kcuda.FUSED_L2_BYTES >> 20])
    ap.add_argument("--in-flight", type=int, nargs="+",
                    default=[kcuda.FUSED_MAX_IN_FLIGHT])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    g = powerlaw_bipartite(cs.GRAPH["n_u"], cs.GRAPH["n_v"], cs.GRAPH["m"],
                           seed=cs.GRAPH["seed"])
    rg = preprocess(g, make_order(g, "degree"), order_name="degree")
    dg = device_graph(rg, dev)
    wv = host_wedge_counts(rg, a.direction)
    plan = plan_count(rg, mode="all", direction=a.direction,
                      aggregation="sort", budget=auto_chunk_budget(dev),
                      dtype="int64", engine="fused_cuda", wv_slots=wv)
    tb, w_off_h = fused_host_inputs(plan, rg.offsets, wv)
    w_off = torch.as_tensor(w_off_h, device=dev)
    args = (tb, dg.offsets, dg.neighbors, dg.edge_src, dg.undirected_id,
            w_off)
    kw = dict(n_pad=dg.n_pad, m=dg.m, direction=a.direction, mode=a.mode)
    want = ref.fused_count_tiles_ref(torch.as_tensor(tb), *args[1:], **kw)
    defaults = kcuda.FUSED_L2_BYTES, kcuda.FUSED_MAX_IN_FLIGHT
    for mib, cap in [(x, y) for x in a.l2_mib for y in a.in_flight]:
        kcuda.FUSED_L2_BYTES = mib << 20
        kcuda.FUSED_MAX_IN_FLIGHT = cap
        t0 = time.perf_counter()
        work = ops.fused_work(tb, rg.offsets, w_off_h, dev)
        plan_ms = (time.perf_counter() - t0) * 1e3

        def fused():
            return ops.fused_count_tiles(*args, tile_cap=plan.chunk_cap,
                                         work=work, **kw)

        got = fused()
        torch.cuda.synchronize()
        if cs.max_abs_err(got, want) != 0:
            print(f"FAIL: differs from the plain version at {mib} MiB",
                  file=sys.stderr)
            return 1
        per_kernel = {}
        for key, _count, us in cs.device_rows(fused, 3):
            for sym in cs.KERNEL_SYMBOLS["fused_count_tiles"]:
                if sym in key:
                    per_kernel[sym.strip(":")] = us / 1e3 / 3
        print(f"{a.direction} {a.mode}, l2 {mib} MiB, in flight <= {cap}: "
              f"light batches {work.light.shape[0]}, heavy chunks "
              f"{work.heavy.shape[0]} in {work.rounds.shape[0] - 1} rounds "
              f"of {work.in_flight}, plan {plan_ms:.1f} ms; card "
              f"{cs.time_ms(fused, iters=5):.3f} ms, device "
              f"{ {k: round(v, 4) for k, v in per_kernel.items()} } ms, "
              f"host {cs.host_us(fused, 5):.0f} us", flush=True)
    kcuda.FUSED_L2_BYTES, kcuda.FUSED_MAX_IN_FLIGHT = defaults
    return 0


if __name__ == "__main__":
    sys.exit(main())
