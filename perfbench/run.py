"""Run one cell of the benchmark of ``repro_torch`` on the CUDA card.

From the root of a checkout::

    python3 perfbench/run.py --workload graph500-s17.count-all --seed 1 \
        --seconds 51 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last); the numbers the correctness check
compared are also the last lines of standard error. Without a CUDA card,
or without the program beside this folder, the run exits non-zero and
prints no result.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# One process with few threads: the program's host work is numpy on one
# core, and idle thread pools of OpenMP, MKL and OpenBLAS only contend
# with it for the machine's cores. Set before numpy or torch is loaded.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from perfbench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
