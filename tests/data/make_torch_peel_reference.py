"""Regenerate ``tests/data/torch_peel_reference.json``.

The pinned full-size peeling reference that ``chip_smoke.py`` holds the
PyTorch/CUDA port against, computed by the JAX package's host engines
(int64 counts with ``jax_enable_x64`` set in this process only):

  - ``PEEL_TIPS`` = ``powerlaw_bipartite(60_000, 45_000, 600_000,
    seed=7)``: tip decomposition in exact and in range mode (side,
    sha256 of the int64 tip numbers, ``rounds``, ``sub_rounds``);
  - ``PEEL_WINGS`` = ``powerlaw_bipartite(20_000, 15_000, 200_000,
    seed=7)`` and ``PEEL_WINGS_HOST`` = ``powerlaw_bipartite(5_000,
    4_000, 40_000, seed=7)``: wing decomposition in exact mode (sha256
    of the int64 wing numbers, ``rounds``).

Every graph also records its edge count ``m`` and content hash, which a
CPU test holds against the port's own generator.

Run from the repository root, with JAX on the CPU (several minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_peel_reference.py
"""
import hashlib
import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from repro.core.peel import peel_tips, peel_wings  # noqa: E402
from repro.data.graphs import powerlaw_bipartite  # noqa: E402

GRAPHS = {
    "PEEL_TIPS": dict(n_u=60_000, n_v=45_000, m=600_000, seed=7),
    "PEEL_WINGS": dict(n_u=20_000, n_v=15_000, m=200_000, seed=7),
    "PEEL_WINGS_HOST": dict(n_u=5_000, n_v=4_000, m=40_000, seed=7),
}
COMMAND = ("JAX_PLATFORMS=cpu PYTHONPATH=src python "
           "tests/data/make_torch_peel_reference.py")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_peel_reference.json")


def digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a), dtype=np.int64)
    return hashlib.sha256(a.tobytes()).hexdigest()


def describe(res) -> dict:
    nums = np.asarray(res.numbers, np.int64)
    return {
        "sha256_int64": digest(nums),
        "rounds": int(res.rounds),
        "sub_rounds": int(res.sub_rounds),
        "round_sizes_sha256_int64": digest(res.round_sizes),
        "max": int(nums.max(initial=0)),
        "sum": int(nums.sum()),
    }


def main() -> int:
    out = {"how": COMMAND, "engine": "host", "count_dtype": "int64"}
    for name, spec in GRAPHS.items():
        g = powerlaw_bipartite(spec["n_u"], spec["n_v"], spec["m"],
                               seed=spec["seed"])
        entry = {
            "graph": (f"powerlaw_bipartite({spec['n_u']}, {spec['n_v']}, "
                      f"{spec['m']}, seed={spec['seed']})"),
            "generator": spec,
            "m": g.m,
            "content_hash": g.content_hash(),
        }
        t0 = time.perf_counter()
        if name == "PEEL_TIPS":
            ex = peel_tips(g)
            rg = peel_tips(g, peel_mode="range")
            assert np.array_equal(ex.numbers, rg.numbers)
            assert rg.sub_rounds == ex.rounds
            entry["side"] = int(ex.side)
            entry["exact"] = describe(ex)
            entry["range"] = describe(rg)
        else:
            entry["exact"] = describe(peel_wings(g))
        out[name] = entry
        print(json.dumps({name: entry,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
