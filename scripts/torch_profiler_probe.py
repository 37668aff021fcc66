#!/usr/bin/env python3
"""How often ``torch.profiler`` misses device records of short traces.

Runs on one CUDA card, from the repository root:

    python3 scripts/torch_profiler_probe.py [--reps 200]

It traces ``ops.bucket_update`` on inputs of the peeling path's median
shape (45,000 int64 counts, a batch of 31,955 lanes) with
``chip_smoke.device_rows``, the helper behind the smoke test's
one-operation check, and prints how many traces held how many of the
kernel's launches and how many other device operations: traces of one
call, and of 20 calls. A one-call trace of a plain ``add_`` is the
control. A trace that loses records reads as fewer launches than calls.
"""
import argparse
import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    n, k = 45_000, 31_955
    counts = torch.randint(0, 1 << 20, (n,), generator=g).to(dev)
    alive = (torch.rand(n, generator=g) < 0.7).to(dev)
    idx = torch.randint(0, n, (k,), generator=g).to(dev)
    dec = torch.randint(0, 5, (k,), generator=g).to(dev)
    sym = cs.KERNEL_SYMBOLS["bucket_update"][0]
    print(f"card: {cs.card_line()}", flush=True)

    def tally(label, fn, calls, mine=lambda key: sym in key):
        seen = collections.Counter()
        t0 = time.perf_counter()
        for _ in range(a.reps):
            rows = cs.device_rows(fn, calls)
            seen[(sum(c for key, c, _t in rows if mine(key)),
                  sum(c for key, c, _t in rows if not mine(key)))] += 1
        print(f"{label}, {calls} call(s) a trace, {a.reps} traces: "
              f"(launches, other operations) -> traces "
              f"{dict(sorted(seen.items()))} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def update():
        return ops.bucket_update(counts, alive, idx, dec)

    tally("bucket_update", update, 1)
    tally("bucket_update", update, 20)
    tally("control add_", lambda: counts.add_(0), 1, mine=lambda key: True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
