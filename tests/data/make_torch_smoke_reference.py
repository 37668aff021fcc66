"""Regenerate ``tests/data/torch_smoke_reference.json``.

The pinned full-size reference that ``chip_smoke.py`` holds the
PyTorch/CUDA port against: exact butterfly counts of the smoke graph
``powerlaw_bipartite(200_000, 150_000, 2_000_000, seed=7)`` computed by
the JAX package (``engine="fused"``, ``mode="all"``, ``order="degree"``,
int64 counts with ``jax_enable_x64`` set in this process only).

Run from the repository root, with JAX on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/data/make_torch_smoke_reference.py
"""
import hashlib
import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import count_butterflies  # noqa: E402
from repro.data.graphs import powerlaw_bipartite  # noqa: E402

GRAPH = dict(n_u=200_000, n_v=150_000, m=2_000_000, seed=7)
COMMAND = ("JAX_PLATFORMS=cpu PYTHONPATH=src python "
           "tests/data/make_torch_smoke_reference.py")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_smoke_reference.json")


def digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a), dtype=np.int64)
    return hashlib.sha256(a.tobytes()).hexdigest()


def main() -> int:
    g = powerlaw_bipartite(GRAPH["n_u"], GRAPH["n_v"], GRAPH["m"],
                           seed=GRAPH["seed"])
    w_u, w_v = g.wedge_totals()
    t0 = time.perf_counter()
    r = count_butterflies(g, mode="all", order="degree", engine="fused",
                          count_dtype=jnp.int64)
    secs = time.perf_counter() - t0
    plan = r.report.plan or ""
    wedges = int(plan.split("wedges=")[1].split()[0])
    total = int(r.total)
    per_u = np.asarray(r.per_u, np.int64)
    per_v = np.asarray(r.per_v, np.int64)
    per_edge = np.asarray(r.per_edge, np.int64)
    assert int(per_u.sum()) + int(per_v.sum()) == 4 * total
    assert int(per_edge.sum()) == 4 * total
    ref = {
        "graph": "powerlaw_bipartite(200_000, 150_000, 2_000_000, seed=7)",
        "generator": GRAPH,
        "m": g.m,
        "content_hash": g.content_hash(),
        "wedge_totals": [w_u, w_v],
        "wedges": wedges,
        "order": "degree",
        "mode": "all",
        "reference_engine": "fused",
        "count_dtype": "int64",
        "total": total,
        "sha256_int64": {
            "per_u": digest(per_u),
            "per_v": digest(per_v),
            "per_edge": digest(per_edge),
        },
        "sums": {
            "per_u": int(per_u.sum()),
            "per_v": int(per_v.sum()),
            "per_edge": int(per_edge.sum()),
        },
        "how": COMMAND,
    }
    with open(OUT, "w") as f:
        json.dump(ref, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({"total": total, "wedges": wedges,
                      "seconds": round(secs, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
