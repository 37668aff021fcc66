"""Regenerate ``tests/data/torch_approx_reference.json``.

The pinned full-size approximate-tier reference that ``chip_smoke.py``
holds the PyTorch/CUDA port against, computed by the JAX package on the
smoke graph ``powerlaw_bipartite(200_000, 150_000, 2_000_000, seed=7)``
(int64 counts with ``jax_enable_x64`` set in this process only):

  - ``approx_count`` with ``method="edges"`` and ``method="colorful"``,
    each at a fixed keep probability ``p`` and ``reps`` repetitions,
    counted by the reference's ``fused`` engine;
  - ``approx_count(method="sample", eps=0.1)``;
  - ``service_sample``: the call the query service makes for an
    ``accuracy="approx"`` query, ``sample_count`` on the graph's resident
    ``SampleState`` with ``eps=0.1`` and ``seed=0``.

Every call uses ``seed=0`` and records ``estimate``, ``stddev``,
``ci95``, ``p``, ``n_samples``, the sparsified edge count ``kept_m`` of
the last repetition (from ``report.estimator``), and its seconds.

Run from the repository root, with JAX on the CPU (about a minute):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_approx_reference.py
"""
import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

from repro.core.approx import SampleState, sample_count  # noqa: E402
from repro.core.sparsify import approx_count  # noqa: E402
from repro.data.graphs import powerlaw_bipartite  # noqa: E402

GRAPH = dict(n_u=200_000, n_v=150_000, m=2_000_000, seed=7)
# Keep probabilities and repetitions: each thinned graph keeps about
# 1/16 of the smoke graph's wedges, so the reference counts every
# repetition on a CPU in seconds.
CALLS = {
    "edges": dict(method="edges", p=0.25, reps=3),
    "colorful": dict(method="colorful", p=0.25, reps=3),
    "sample": dict(method="sample", eps=0.1),
}
SEED = 0
COMMAND = ("JAX_PLATFORMS=cpu PYTHONPATH=src python "
           "tests/data/make_torch_approx_reference.py")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_approx_reference.json")


def describe(r, seconds: float) -> dict:
    est = r.report.estimator if r.report is not None else ""
    kept = est.split("kept_m=")[1].split("/")[0] if "kept_m=" in est else None
    return {
        "estimate": r.estimate,
        "stddev": r.stddev,
        "ci95": r.ci95,
        "p": r.p,
        "n_samples": int(r.n_samples),
        "kept_m": None if kept is None else int(kept),
        "estimator": est,
        "seconds": round(seconds, 1),
    }


def main() -> int:
    g = powerlaw_bipartite(GRAPH["n_u"], GRAPH["n_v"], GRAPH["m"],
                           seed=GRAPH["seed"])
    out = {
        "how": COMMAND,
        "graph": "powerlaw_bipartite(200_000, 150_000, 2_000_000, seed=7)",
        "generator": GRAPH,
        "m": g.m,
        "content_hash": g.content_hash(),
        "seed": SEED,
        "reference_engine": "fused",
        "calls": {},
    }
    for name, kw in CALLS.items():
        t0 = time.perf_counter()
        r = approx_count(g, seed=SEED, **kw)
        out["calls"][name] = dict(kwargs=kw, **describe(
            r, time.perf_counter() - t0))
        print(json.dumps({name: out["calls"][name]}), flush=True)
    t0 = time.perf_counter()
    r = sample_count(SampleState.build(g), eps=0.1, seed=SEED)
    out["service_sample"] = dict(kwargs=dict(eps=0.1), **describe(
        r, time.perf_counter() - t0))
    print(json.dumps({"service_sample": out["service_sample"]}), flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
