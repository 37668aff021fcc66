#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

  1. require a CUDA card and print its name and power limit;
  2. build the hand-written CUDA kernels from ``src/repro_torch``;
  3. generate the smoke graph ``powerlaw_bipartite(200_000, 150_000,
     2_000_000, seed=7)`` and check it against the pinned reference
     ``tests/data/torch_smoke_reference.json`` (m, content hash, wedges);
  4. hold every kernel against its plain PyTorch version on the card, at
     the shapes the counting path gives it, bit for bit, and time both
     (and ``torch.bincount`` beside the histogram, as a yardstick only);
  5. drive the main path, ``count_butterflies(g, mode="all",
     order="degree", count_dtype=torch.int64)``, through ``fused_cuda``,
     ``cuda`` with hash aggregation, and the plain ``fused`` engine, with
     the kernels' launch counts zeroed just before each run and read just
     after; the three must agree bit for bit, satisfy the 4B identities,
     and match the pinned reference computed by the JAX package;
  6. profile one more ``fused_cuda`` call (``torch.profiler``) and print
     the device's busy time (kernels and copies) and its idle share of the
     unprofiled ``fused_cuda`` wall of phase 5, with the top device rows;
  7. print one ``{"kernels": [...]}`` line, the card line, and the final
     ``{"ok": true, "device": {...}}`` line.

Bounds use the H100 SXM's published rates: 3.35 TB/s of HBM bandwidth,
and 16.7e12 int32 operations/s (64 INT32 lanes per SM x 132 SMs x
1.98 GHz, Hopper architecture white paper).
"""
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

REFERENCE = os.path.join(ROOT, "tests", "data", "torch_smoke_reference.json")
GRAPH = dict(n_u=200_000, n_v=150_000, m=2_000_000, seed=7)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
KERNEL_SOURCES = {
    "fused_count_tiles": ("src/repro_torch/kernels/csrc/fused_count_tiles.cu",
                          "src/repro/kernels/wedge_fused.py:226"),
    "wedge_histogram": ("src/repro_torch/kernels/csrc/wedge_histogram.cu",
                        "src/repro/kernels/wedge_count.py:64"),
    "butterfly_combine": ("src/repro_torch/kernels/csrc/butterfly_combine.cu",
                          "src/repro/kernels/butterfly_combine.py:87"),
}
MAIN_PATH = (
    ("fused_cuda", "sort"),
    ("cuda", "hash"),
    ("fused", "sort"),
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 1, iters: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def max_abs_err(a, b) -> float:
    """Largest absolute difference over paired integer tensors."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"shape/dtype mismatch {x.shape}/{x.dtype} vs "
                 f"{y.shape}/{y.dtype}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return float(err)


def digest(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a, dtype=np.int64)
    return hashlib.sha256(a.tobytes()).hexdigest()


def check_kernels(g, rg, ref, dev):
    """Phase 4: each kernel against its plain version at the main path's
    shapes. Returns {name: row} without ``launches``."""
    from repro_torch.core.aggregate import hash_resolve, table_bits_for
    from repro_torch.core.pipeline import fused_tile_inputs, plan_count
    from repro_torch.core.wedges import (
        auto_chunk_budget, device_graph, gather_wedges, host_wedge_counts,
        slot_wedge_counts,
    )
    from repro_torch.kernels import ops, ref as plain

    rows = {}
    dg = device_graph(rg, dev)
    wv_slots = host_wedge_counts(rg, "low")
    W = int(wv_slots.sum())

    # fused_count_tiles at the fused_cuda rung's plan (auto budget)
    plan = plan_count(rg, mode="all", aggregation="sort",
                      budget=auto_chunk_budget(dev), dtype="int64",
                      engine="fused_cuda", wv_slots=wv_slots)
    tb, w_off = fused_tile_inputs(plan, rg.offsets, wv_slots, dev)
    args = (tb, dg.offsets, dg.neighbors, dg.edge_src, dg.undirected_id,
            w_off)
    kw = dict(n_pad=dg.n_pad, m=dg.m, direction="low", mode="all")
    got = ops.fused_count_tiles(*args, tile_cap=plan.chunk_cap, **kw)
    want = plain.fused_count_tiles_ref(torch.as_tensor(tb), *args[1:], **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0 or int(got[0]) != ref["total"]:
        fail(f"fused_count_tiles differs from its plain version "
             f"(max |err| {err}, total {int(got[0])} vs {ref['total']})")
    e_pad = dg.e_pad
    nbytes = (4 * (dg.n_pad + 1) + 3 * 4 * e_pad + 8 * (e_pad + 1)
              + 16 * tb.shape[0] + 8 * (1 + dg.n_pad + dg.m))
    ops_n = W * int(np.ceil(np.log2(e_pad + 1)))
    b_ms, b_by = bound(nbytes, ops_n)
    rows["fused_count_tiles"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.fused_count_tiles(
            *args, tile_cap=plan.chunk_cap, **kw)),
        plain_ms=time_ms(lambda: plain.fused_count_tiles_ref(
            torch.as_tensor(tb), *args[1:], **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"W={W} tiles={plan.n_tiles} tile_cap={plan.chunk_cap}",
    )
    print(f"kernel fused_count_tiles: bitwise equal to plain "
          f"({rows['fused_count_tiles']['shape']})", flush=True)
    del got, want

    # wedge_histogram and butterfly_combine at the cuda+hash rung's
    # shapes: the whole wedge array into a 2^table_bits-slot table
    w_cap = max(128, ((W + 127) // 128) * 128)
    w = gather_wedges(dg, slot_wedge_counts(dg, "low"), w_cap, "low")
    bits = table_bits_for(w_cap)
    owner, slot, resolved = hash_resolve(w, bits)
    keys = slot.to(torch.int32)
    live = w.valid & resolved
    B = 1 << bits
    got = ops.wedge_histogram(keys, live, B)
    want = plain.wedge_histogram_ref(keys, live, B)
    k_live = keys[live]
    lib = torch.bincount(k_live, minlength=B).to(torch.int32)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    if err != 0 or not torch.equal(got, lib):
        fail(f"wedge_histogram differs from its plain version "
             f"(max |err| {err})")
    n_live = int(live.sum())
    b_ms, b_by = bound(5 * keys.numel() + 4 * B, n_live)
    rows["wedge_histogram"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.wedge_histogram(keys, live, B)),
        plain_ms=time_ms(lambda: plain.wedge_histogram_ref(keys, live, B)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.bincount(k_live, minlength=B)),
        shape=f"keys={keys.numel()} buckets={B}",
    )
    print(f"kernel wedge_histogram: bitwise equal to plain "
          f"({rows['wedge_histogram']['shape']})", flush=True)

    counts = got
    gvalid = owner != np.iinfo(np.int32).max
    d_w = torch.where(w.valid, counts[slot], torch.zeros_like(counts[:1]))
    calls = (
        (counts, torch.ones_like(gvalid), gvalid),  # group_choose2
        (d_w, torch.zeros_like(w.valid), w.valid),  # wedge_dm1
    )
    err = 0.0
    for d, rep, valid in calls:
        err = max(err, max_abs_err(ops.butterfly_combine(d, rep, valid),
                                   plain.butterfly_combine_ref(d, rep, valid)))
    if err != 0:
        fail(f"butterfly_combine differs from its plain version "
             f"(max |err| {err})")
    n_all = sum(c[0].numel() for c in calls)
    b_ms, b_by = bound(18 * n_all, 2 * n_all)
    rows["butterfly_combine"] = dict(
        max_abs_err=err,
        ms=sum(time_ms(lambda c=c: ops.butterfly_combine(*c)) for c in calls),
        plain_ms=sum(time_ms(lambda c=c: plain.butterfly_combine_ref(*c))
                     for c in calls),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"groups={counts.numel()} + wedges={d_w.numel()}",
    )
    print(f"kernel butterfly_combine: bitwise equal to plain "
          f"({rows['butterfly_combine']['shape']})", flush=True)
    return rows


def profile_call(g, dev, wall_s: float) -> None:
    """Trace one more fused_cuda call with torch.profiler and print the
    device's busy time (the device-side rows: kernels, copies, fills)
    beside ``wall_s``, the same call's unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import count_butterflies

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        count_butterflies(g, mode="all", order="degree", engine="fused_cuda",
                          count_dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.key)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    if not rows:
        print("profile: the trace shows no device time (not measured)",
              flush=True)
        return
    busy_ms = sum(ms for ms, _ in rows)
    print(f"profile fused_cuda: device busy {busy_ms:.3f} ms of the "
          f"{wall_s * 1e3:.1f} ms unprofiled wall, idle share "
          f"{1 - busy_ms / (wall_s * 1e3):.4f}", flush=True)
    for ms, key in sorted(rows, reverse=True)[:6]:
        print(f"  {ms:10.3f} ms  {key[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from repro_torch.core import count_butterflies
    from repro_torch.core.graph import preprocess
    from repro_torch.core.ranking import make_order
    from repro_torch.core.wedges import host_wedge_counts
    from repro_torch.data.graphs import powerlaw_bipartite
    from repro_torch.kernels import ops

    # -- 2. build ------------------------------------------------------
    ops.build()
    info = ops.build_info
    print(f"build: {info['seconds']:.1f} s (compiled={info['compiled']}) "
          f"{info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}", flush=True)

    # -- 3. graph ------------------------------------------------------
    with open(REFERENCE) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    g = powerlaw_bipartite(GRAPH["n_u"], GRAPH["n_v"], GRAPH["m"],
                           seed=GRAPH["seed"])
    t1 = time.perf_counter()
    rg = preprocess(g, make_order(g, "degree", device=dev),
                    order_name="degree")
    t2 = time.perf_counter()
    W = int(host_wedge_counts(rg, "low").sum())
    print(f"graph: m={g.m} content_hash={g.content_hash()} W={W} "
          f"(host: generate {t1 - t0:.3f} s, rank+CSR {t2 - t1:.3f} s, "
          f"wedge counts {time.perf_counter() - t2:.3f} s)", flush=True)
    for key, val in (("m", g.m), ("content_hash", g.content_hash()),
                     ("wedges", W)):
        if ref[key] != val:
            fail(f"graph {key} {val} differs from the pinned {ref[key]}")

    # -- 4. kernels against their plain versions ------------------------
    rows = check_kernels(g, rg, ref, dev)
    torch.cuda.empty_cache()

    # -- 5. the main path ----------------------------------------------
    results = {}
    walls = {}
    launches = {name: 0 for name in ops.LAUNCHES}
    for engine, agg in MAIN_PATH:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        r = count_butterflies(g, mode="all", order="degree", engine=engine,
                              aggregation=agg, count_dtype=torch.int64,
                              device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rep = r.report
        print(f"main path engine={engine} aggregation={agg}: "
              f"wall {wall:.3f} s, peak {peak:.2f} GiB, launches {used}, "
              f"rungs {rep.summary()}", flush=True)
        if rep.final_rung != engine or rep.retries or rep.degraded:
            fail(f"engine {engine} did not finish on its own rung: "
                 f"{rep.summary()}")
        if engine == "fused_cuda" and used["fused_count_tiles"] == 0:
            fail("fused_cuda ran without launching fused_count_tiles")
        if engine == "cuda" and (used["wedge_histogram"] == 0
                                 or used["butterfly_combine"] == 0):
            fail("cuda+hash ran without launching both of its kernels")
        for name, n in used.items():
            launches[name] += n
        results[engine] = r
        walls[engine] = wall

    base = results["fused_cuda"]
    for engine, r in results.items():
        for field in ("total", "per_u", "per_v", "per_edge"):
            a, b = getattr(base, field), getattr(r, field)
            if a.dtype != np.int64 or not np.array_equal(a, b):
                fail(f"{engine} {field} differs from fused_cuda")
    total = int(base.total)
    su, sv, se = (int(base.per_u.sum()), int(base.per_v.sum()),
                  int(base.per_edge.sum()))
    if su + sv != 4 * total or se != 4 * total:
        fail(f"4B identities fail: {su}+{sv}, {se} vs 4*{total}")
    got = {"per_u": digest(base.per_u), "per_v": digest(base.per_v),
           "per_edge": digest(base.per_edge)}
    if total != ref["total"] or got != ref["sha256_int64"]:
        fail(f"counts differ from the pinned JAX reference: total {total} "
             f"vs {ref['total']}, digests {got}")
    print(f"counts: total={total} bitwise equal across "
          f"{[e for e, _ in MAIN_PATH]} and to the pinned JAX reference",
          flush=True)

    # -- 6. where one fused_cuda call spends its time -------------------
    profile_call(g, dev, walls["fused_cuda"])

    # -- 7. report ------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        row = rows[name]
        if launches[name] == 0:
            fail(f"kernel {name} was never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
