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
  4. hold every counting kernel against its plain PyTorch version on the
     card, at the shapes the counting path gives it, bit for bit, and
     time both (and ``torch.bincount`` beside the histogram, as a
     yardstick only); the histogram's row times the int64 hash-slot keys
     the path passes it, and the same keys narrowed to int32 (the keys
     the row timed before the kernel took int64) are held bit for bit
     and timed beside it, with its per-launch device times and its plan;
  5. drive the counting path, ``count_butterflies(g, mode="all",
     order="degree", count_dtype=torch.int64)``, through ``fused_cuda``,
     ``cuda`` with hash aggregation, the plain ``fused`` engine, and the
     ``torch`` engine with the ``batch`` and ``batch_wa`` aggregations
     (blocks issued from a host loop; each call prints its block
     count), with the kernels' launch counts zeroed just before each run
     and read just after; all five must agree bit for bit, satisfy the
     4B identities, and match the pinned reference computed by the JAX
     package;
  6. profile one more ``fused_cuda`` call (``torch.profiler``) and print
     the device's busy time (kernels and copies) and its idle share of the
     unprofiled ``fused_cuda`` wall of phase 5, with the top device rows;
  7. drive the peeling path, each call with the launch counts zeroed just
     before it and read just after: ``peel_tips(engine="device")`` on
     ``PEEL_TIPS`` = ``powerlaw_bipartite(60_000, 45_000, 600_000,
     seed=7)`` with ``decrease_key="bucket"`` in exact and in range mode
     and with ``"scatter"``; ``peel_wings(engine="device")`` with
     ``bucket`` and ``scatter`` on ``PEEL_WINGS`` =
     ``powerlaw_bipartite(20_000, 15_000, 200_000, seed=7)``; and
     ``peel_wings(engine="host")`` on ``PEEL_WINGS_HOST`` =
     ``powerlaw_bipartite(5_000, 4_000, 40_000, seed=7)``. Each call
     computes its own counts through ``fused_cuda``, must finish on the
     rung it asked for and launch its kernel; it prints its wall, host
     syncs and peak memory. All tip numbers must agree bit for bit, all
     wing numbers likewise, and both must match the pinned JAX reference
     ``tests/data/torch_peel_reference.json``;
  8. hold ``bucket_min`` and ``bucket_update`` against their plain
     versions on inputs the peeling path gave them (copies kept during
     phase 7), time both and the ``torch.amin`` yardstick, check that
     each puts exactly one device operation on the stream per call (no
     copy, memset or fill; 20 calls traced), and profile one more tip
     call to set the device's busy time beside its wall and host syncs;
  9. the approximate tier and the query service, on the card at full
     size: ``approx_count`` on the smoke graph with ``method="edges"``
     and ``"colorful"`` (fixed ``p`` and ``reps``; one
     ``fused_count_tiles`` launch per repetition) and ``"sample"``, each
     equal to the pinned JAX reference
     ``tests/data/torch_approx_reference.json``; then a
     ``ButterflyService(device="cuda", workers=2)`` holding the smoke
     graph and ``PEEL_TIPS``, queried serially (a global and an ``all``
     count on ``fused_cuda`` against the pinned counts, the same global
     query again from the cache with no launch, an ``accuracy="approx"``
     query under a 1 us deadline answered by the ``sample`` rung with
     the pinned estimate, the same query again after the refine-behind
     recount with the exact pinned total, and a device tip-peeling query
     against the pinned numbers), each query's launch counts zeroed just
     before it and read just after, then six mixed queries at once on a
     fresh service, each equal to its serial answer; every query prints
     its service report and peak memory, and one more count query prints
     how its wall splits between host steps and device time;
 10. checkpoints and distributed execution, on the card at full size:
     ``distributed_count`` of the smoke graph on a 4-worker mesh of the
     one card (``launch.mesh.make_test_mesh``, int64, ``max_chunk`` set
     so that every worker holds tiles; one ``fused_count_tiles`` launch
     per worker per call) in global, vertex and edge mode against the
     pinned counts; ``peel_tips(devices=4)`` on ``PEEL_TIPS`` over a
     ``CheckpointStore(retain_last=2)`` with one injected device loss
     mid-run, which must end on the distributed rung with one restore,
     3 workers and the pinned numbers and range-mode round data (it
     prints its wall, launches, host syncs, checkpoint seconds and bytes
     per committed round, peak memory, and the device's busy share over
     host reads 2000-3000 from ``torch.profiler``; the largest
     ``bucket_update`` reduction is held against the plain version);
     ``peel_wings`` and ``peel_tips_stored`` with ``devices=2`` on
     ``PEEL_WINGS_HOST`` against the pin's range and tips entries; and a
     supervised tip run whose ``deadline_s`` expires mid-run (a ``slow``
     fault at round 3), which must leave committed rounds that a second
     run resumes and ends on the pin;
 11. print one ``{"kernels": [...]}`` line, the card line, and the final
     ``{"ok": true, "device": {...}}`` line.

Every kernel row has ``ms`` (CUDA events around back-to-back calls,
the host's pace when a call is short), ``device_ms`` (the kernel's own
device time per call, summed over its launches, from ``torch.profiler``)
and ``host_us`` (host microseconds per call to enqueue it, from a host
clock around a run of calls with no synchronize inside; no wrapper
reads a result back). ``fused_count_tiles`` is timed with its host work
list planned beforehand, as the counting path plans it.

Bounds use the H100 SXM's published rates: 3.35 TB/s of HBM bandwidth,
and 16.7e12 int32 operations/s (64 INT32 lanes per SM x 132 SMs x
1.98 GHz, Hopper architecture white paper).
"""
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

REFERENCE = os.path.join(ROOT, "tests", "data", "torch_smoke_reference.json")
PEEL_REFERENCE = os.path.join(ROOT, "tests", "data",
                              "torch_peel_reference.json")
APPROX_REFERENCE = os.path.join(ROOT, "tests", "data",
                                "torch_approx_reference.json")
APPROX_FIELDS = ("estimate", "stddev", "ci95", "p", "n_samples", "kept_m")
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
    "bucket_min": ("src/repro_torch/kernels/csrc/bucket_min.cu",
                   "src/repro/kernels/bucket_min.py:46"),
    "bucket_update": ("src/repro_torch/kernels/csrc/bucket_update.cu",
                      "src/repro/kernels/bucket_update.py:140"),
}
MAIN_PATH = (
    ("fused_cuda", "sort"),
    ("cuda", "hash"),
    ("fused", "sort"),
    ("torch", "batch"),
    ("torch", "batch_wa"),
)
# (decomposition, graph, knobs, the kernel the call must launch)
PEEL_PATH = (
    ("tips", "PEEL_TIPS",
     dict(engine="device", decrease_key="bucket", peel_mode="exact"),
     "bucket_update"),
    ("tips", "PEEL_TIPS",
     dict(engine="device", decrease_key="bucket", peel_mode="range"),
     "bucket_update"),
    ("tips", "PEEL_TIPS",
     dict(engine="device", decrease_key="scatter", peel_mode="exact"),
     "bucket_min"),
    ("wings", "PEEL_WINGS", dict(engine="device", decrease_key="bucket"),
     "bucket_update"),
    ("wings", "PEEL_WINGS", dict(engine="device", decrease_key="scatter"),
     "bucket_min"),
    ("wings", "PEEL_WINGS_HOST", dict(engine="host"), "bucket_min"),
    ("stored", "PEEL_TIPS", dict(engine="device", decrease_key="bucket"),
     "bucket_update"),
    ("tips", "PEEL_TIPS",
     dict(engine="device", subtract="materialize", decrease_key="scatter",
          capacity_schedule="adaptive"),
     "bucket_min"),
    ("wings", "PEEL_WINGS",
     dict(engine="device", subtract="materialize",
          capacity_schedule="adaptive"),
     "bucket_update"),
)
TAPPED = ("bucket_min", "bucket_update")
# Names of each kernel's launches in the profiler's device rows.
KERNEL_SYMBOLS = {
    "fused_count_tiles": ("::fused_light_kernel", "::fused_heavy_kernel"),
    "wedge_histogram": ("::wedge_histogram_",),
    "butterfly_combine": ("::butterfly_combine_kernel",),
    "bucket_min": ("::bucket_min_kernel",),
    "bucket_update": ("::bucket_update_kernel",),
}


T0 = time.perf_counter()


def phase(n: int) -> None:
    print(f"-- phase {n} at {time.perf_counter() - T0:.1f} s", flush=True)


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


def device_rows(fn, calls: int) -> list:
    """``(key, count, device us)`` of every device-side row (kernels,
    copies, memsets) that ``torch.profiler`` records over ``calls``
    calls of ``fn``, after one unprofiled warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.count > 0]


def device_ms(fn, name: str, calls: int):
    """Device ms per call of kernel ``name``'s own launches; None when
    the trace shows none (not measured)."""
    us = sum(t for key, _c, t in device_rows(fn, calls)
             if any(sym in key for sym in KERNEL_SYMBOLS[name]))
    return us / 1e3 / calls if us > 0 else None


def host_us(fn, calls: int) -> float:
    """Host microseconds per call to enqueue ``fn``: a host clock around
    ``calls`` calls with no synchronize inside, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def timings(name: str, fn, calls: int) -> dict:
    """``host_us`` and ``device_ms`` of one kernel row (the host clock
    first: launches right after a profiler session run slower)."""
    host = host_us(fn, calls)
    return dict(device_ms=device_ms(fn, name, calls), host_us=host)


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
    from repro_torch.core.pipeline import fused_host_inputs, plan_count
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
    tb, w_off_h = fused_host_inputs(plan, rg.offsets, wv_slots)
    t0 = time.perf_counter()
    work = ops.fused_work(tb, rg.offsets, w_off_h, dev)
    plan_s = time.perf_counter() - t0
    w_off = torch.as_tensor(w_off_h, device=dev)
    args = (tb, dg.offsets, dg.neighbors, dg.edge_src, dg.undirected_id,
            w_off)
    kw = dict(n_pad=dg.n_pad, m=dg.m, direction="low", mode="all")

    def fused():
        return ops.fused_count_tiles(*args, tile_cap=plan.chunk_cap,
                                     work=work, **kw)

    got = fused()
    want = plain.fused_count_tiles_ref(torch.as_tensor(tb), *args[1:], **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0 or int(got[0]) != ref["total"]:
        fail(f"fused_count_tiles differs from its plain version "
             f"(max |err| {err}, total {int(got[0])} vs {ref['total']})")
    e_pad = dg.e_pad
    nbytes = (4 * (dg.n_pad + 1) + 3 * 4 * e_pad + 8 * (e_pad + 1)
              + 16 * tb.shape[0] + 8 * (1 + dg.n_pad + dg.m))
    # one grouping update per wedge is the work the inputs need
    b_ms, b_by = bound(nbytes, W)
    rows["fused_count_tiles"] = dict(
        max_abs_err=err,
        ms=time_ms(fused),
        plain_ms=time_ms(lambda: plain.fused_count_tiles_ref(
            torch.as_tensor(tb), *args[1:], **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=(f"W={W} tiles={plan.n_tiles} tile_cap={plan.chunk_cap}; "
               f"light batches {work.light.shape[0]}, heavy chunks "
               f"{work.heavy.shape[0]} in {work.rounds.shape[0] - 1} rounds "
               f"of {work.in_flight} in flight"),
        **timings("fused_count_tiles", fused, 3),
    )
    print(f"kernel fused_count_tiles: bitwise equal to plain "
          f"({rows['fused_count_tiles']['shape']}; host work list "
          f"{plan_s * 1e3:.1f} ms, {work.table.nbytes} B, scratch "
          f"{work.scratch_bytes} B)", flush=True)
    for key, count, us in sorted(device_rows(fused, 1), key=lambda r: -r[2]):
        print(f"  {us / 1e3:10.4f} ms {count}x {key[:80]}", flush=True)
    del got, want

    # wedge_histogram and butterfly_combine at the cuda+hash rung's
    # shapes: the whole wedge array into a 2^table_bits-slot table
    w_cap = max(128, ((W + 127) // 128) * 128)
    w = gather_wedges(dg, slot_wedge_counts(dg, "low"), w_cap, "low")
    bits = table_bits_for(w_cap)
    owner, slot, resolved = hash_resolve(w, bits)
    live = w.valid & resolved
    B = 1 << bits
    # The row times the int64 slots the path passes (no narrowing copy).
    # The rows before the kernel took int64 timed the slots narrowed to
    # int32, and torch.bincount over those: both stay as a comparison.
    keys = slot.to(torch.int32)
    got = ops.wedge_histogram(slot, live, B)
    want = plain.wedge_histogram_ref(slot, live, B)
    k_live = keys[live]
    lib = torch.bincount(k_live, minlength=B).to(torch.int32)
    torch.cuda.synchronize()
    err = max_abs_err([got], [want])
    if err != 0 or not torch.equal(got, lib):
        fail(f"wedge_histogram differs from its plain version "
             f"(max |err| {err})")
    if not torch.equal(ops.wedge_histogram(keys, live, B), want):
        fail("wedge_histogram on int32 keys differs from its plain version")
    n_live = int(live.sum())
    # each int64 key and its valid byte read once, each bucket written once
    b_ms, b_by = bound(9 * slot.numel() + 4 * B, n_live)
    rows["wedge_histogram"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.wedge_histogram(slot, live, B)),
        plain_ms=time_ms(lambda: plain.wedge_histogram_ref(slot, live, B)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.bincount(k_live, minlength=B)),
        shape=f"keys={slot.numel()} (int64) buckets={B}",
        **timings("wedge_histogram",
                  lambda: ops.wedge_histogram(slot, live, B), 3),
    )
    print(f"kernel wedge_histogram: bitwise equal to plain "
          f"({rows['wedge_histogram']['shape']})", flush=True)
    for key, count, us in sorted(device_rows(
            lambda: ops.wedge_histogram(slot, live, B), 1), key=lambda r: -r[2]):
        print(f"  {us / 1e3:10.4f} ms {count}x {key[:80]}", flush=True)
    plan = ops.histogram_plan(
        B, slot.numel(), torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"kernel wedge_histogram: bitwise equal on the same keys narrowed "
          f"to int32, {time_ms(lambda: ops.wedge_histogram(keys, live, B)):.4f}"
          f" ms; plan {plan}", flush=True)

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
        **timings("butterfly_combine",
                  lambda: [ops.butterfly_combine(*c) for c in calls], 3),
    )
    print(f"kernel butterfly_combine: bitwise equal to plain "
          f"({rows['butterfly_combine']['shape']})", flush=True)
    return rows


def batch_blocks(rg) -> dict:
    """The blocks the batch aggregations cut on the smoke graph (their
    host planner, run once more outside the timed calls): all blocks,
    those holding wedges (the host loop's iterations), the largest."""
    from repro_torch.core.count import _batch_bounds
    from repro_torch.core.wedges import host_wedge_counts

    wv_slots = host_wedge_counts(rg, "low")
    wv = np.zeros(rg.n_pad, dtype=np.int64)
    np.add.at(wv, rg.edge_src[: 2 * rg.m].astype(np.int64),
              wv_slots[: 2 * rg.m])
    voff = np.concatenate([[0], np.cumsum(wv)])
    out = {}
    for agg in ("batch", "batch_wa"):
        bounds, most = _batch_bounds(wv, rg.n_pad, agg == "batch_wa", 8,
                                     1 << 14)
        held = np.diff(voff[bounds])
        out[agg] = (f"blocks {held.size} ({int((held > 0).sum())} with "
                    f"wedges, largest {most} wedges), ")
    return out


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


class KernelTap:
    """Wraps ``ops.bucket_min`` and ``ops.bucket_update`` while the
    peeling path runs: records the batch size of every call and keeps
    copies of a few calls' inputs (the largest batch so far and every
    ``every``-th call) for phase 8. The wrapped functions still launch
    and count as before."""

    def __init__(self, ops, every: int = 1000):
        self.ops = ops
        self.every = every
        self.calls = {name: 0 for name in TAPPED}
        self.sizes = {name: [] for name in TAPPED}
        self.samples = {name: [] for name in TAPPED}
        self.largest = {name: -1 for name in TAPPED}
        self.orig = {}

    def __enter__(self):
        for name in TAPPED:
            orig = getattr(self.ops, name)
            self.orig[name] = orig

            def tapped(*args, _name=name, _orig=orig):
                self._record(_name, args)
                return _orig(*args)

            setattr(self.ops, name, tapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self.orig.items():
            setattr(self.ops, name, orig)

    def _record(self, name, args):
        k = int(args[2].numel()) if name == "bucket_update" else 0
        if k > self.largest[name] or self.calls[name] % self.every == 0:
            self.samples[name].append(tuple(a.clone() for a in args))
        self.largest[name] = max(self.largest[name], k)
        self.sizes[name].append(k)
        self.calls[name] += 1


def rss_gib() -> tuple:
    """(current, peak) resident memory of this process in GiB."""
    with open("/proc/self/status") as f:
        cur = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return cur / 2**20, peak / 2**20


class CsrTap:
    """Times ``peel._stored_wedge_csr`` (the stored-wedge CSR that
    ``peel_tips_stored`` builds with host numpy) while the peeling path
    runs, and prints its seconds, the bytes of its two arrays and the
    process's resident memory around it."""

    def __init__(self, peel):
        self.peel = peel
        self.orig = peel._stored_wedge_csr

    def __enter__(self):
        def tapped(g, side, *args, **kw):
            before = rss_gib()
            t0 = time.perf_counter()
            woff, w_u2 = self.orig(g, side, *args, **kw)
            secs = time.perf_counter() - t0
            after = rss_gib()
            print(f"stored-wedge CSR (host): {secs:.3f} s, W={int(woff[-1])} "
                  f"wedges, woff {woff.nbytes} B ({woff.dtype}) + w_u2 "
                  f"{w_u2.nbytes} B ({w_u2.dtype}); RSS {before[0]:.2f} -> "
                  f"{after[0]:.2f} GiB, peak RSS {before[1]:.2f} -> "
                  f"{after[1]:.2f} GiB", flush=True)
            return woff, w_u2

        self.peel._stored_wedge_csr = tapped
        return self

    def __exit__(self, *exc):
        self.peel._stored_wedge_csr = self.orig


def peel_phase(dev, launches):
    """Phase 7: the peeling path. Returns the kernel tap and the
    PEEL_TIPS graph."""
    from repro_torch.core import peel, peel_tips, peel_tips_stored, peel_wings
    from repro_torch.data.graphs import powerlaw_bipartite
    from repro_torch.kernels import ops

    entry = {"tips": peel_tips, "stored": peel_tips_stored,
             "wings": peel_wings}

    with open(PEEL_REFERENCE) as f:
        ref = json.load(f)
    graphs = {}
    for name in ("PEEL_TIPS", "PEEL_WINGS", "PEEL_WINGS_HOST"):
        spec = ref[name]["generator"]
        g = powerlaw_bipartite(spec["n_u"], spec["n_v"], spec["m"],
                               seed=spec["seed"])
        for key, val in (("m", g.m), ("content_hash", g.content_hash())):
            if ref[name][key] != val:
                fail(f"{name} {key} {val} differs from the pinned "
                     f"{ref[name][key]}")
        graphs[name] = g
        print(f"peel graph {name}: {ref[name]['graph']} m={g.m} "
              f"content_hash matches the pin", flush=True)

    results = []
    with KernelTap(ops) as tap, CsrTap(peel):
        for kind, gname, knobs, kernel in PEEL_PATH:
            fn = entry[kind]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            r = fn(graphs[gname], count_kwargs={"engine": "fused_cuda"},
                   device=dev, **knobs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            rep = r.report
            label = f"{kind} {gname} " + " ".join(
                f"{k}={v}" for k, v in knobs.items())
            print(f"peel {label}: wall {wall:.3f} s, host syncs "
                  f"{rep.host_syncs}, segments {rep.segments}, largest "
                  f"frontier {rep.frontier_lanes} lanes, peak {peak:.3f} "
                  f"GiB, rounds {r.rounds}, sub_rounds {r.sub_rounds}, "
                  f"launches {used}, rungs "
                  f"{rep.summary().split(' | ')[0]}", flush=True)
            if rep.final_rung != knobs["engine"] or rep.degraded:
                fail(f"peel {label} did not finish on its own rung: "
                     f"{rep.summary()}")
            if used[kernel] == 0:
                fail(f"peel {label} ran without launching {kernel}")
            if used["fused_count_tiles"] == 0:
                fail(f"peel {label} counted without fused_count_tiles")
            adaptive = knobs.get("capacity_schedule") == "adaptive"
            if knobs["engine"] == "device" and (
                    rep.segments <= 1 if adaptive else rep.segments != 1):
                fail(f"peel {label} ran {rep.segments} capacity segments")
            for name, n in used.items():
                launches[name] += n
            results.append((kind, gname, knobs, r))

    for kind, gname, knobs, r in results:
        want = ref[gname][knobs.get("peel_mode", "exact")]
        if r.numbers.dtype != np.int64 or digest(r.numbers) != want["sha256_int64"]:
            fail(f"{kind} {gname} {knobs}: numbers differ from the pinned "
                 f"JAX reference")
        if digest(r.round_sizes) != want["round_sizes_sha256_int64"]:
            fail(f"{kind} {gname} {knobs}: round sizes differ from the "
                 f"pinned JAX reference")
        if (r.rounds, r.sub_rounds) != (want["rounds"], want["sub_rounds"]):
            fail(f"{kind} {gname} {knobs}: rounds/sub_rounds "
                 f"{r.rounds}/{r.sub_rounds} differ from the pinned "
                 f"{want['rounds']}/{want['sub_rounds']}")
        if kind != "wings" and r.side != ref[gname]["side"]:
            fail(f"{kind} peeled side {r.side}, pinned "
                 f"{ref[gname]['side']}")
    tips = [r for kind, _g, _k, r in results if kind != "wings"]
    ex = [r for kind, _g, k, r in results
          if kind != "wings" and k.get("peel_mode", "exact") == "exact"]
    rg = [r for kind, _g, k, r in results
          if kind != "wings" and k.get("peel_mode") == "range"]
    if not all(np.array_equal(t.numbers, tips[0].numbers) for t in tips):
        fail("tip numbers differ between the tip calls")
    if any(r.sub_rounds != ex[0].rounds for r in rg):
        fail("range-mode sub_rounds differ from exact-mode rounds")
    wings = [r for kind, g_, _k, r in results
             if kind == "wings" and g_ == "PEEL_WINGS"]
    if not all(np.array_equal(w.numbers, wings[0].numbers) for w in wings):
        fail("wing numbers differ between the device wing calls")
    if any(r.rounds != ex[0].rounds for r in ex):
        fail("exact-mode tip rounds differ between the tip calls")
    print("peel: tip (PEEL-V and WPEEL-V) and wing numbers bitwise equal "
          "across calls and to the pinned JAX reference; exact rounds == "
          "range sub_rounds", flush=True)
    return tap, graphs["PEEL_TIPS"]


def peel_kernel_rows(tap):
    """Phase 8: the two peeling kernels against their plain versions on
    inputs copied from the peeling path, timed beside their yardstick."""
    from repro_torch.kernels import ops, ref as plain

    rows = {}
    for name in TAPPED:
        samples = tap.samples[name]
        if not samples:
            fail(f"the peeling path gave {name} no inputs")
        fn = getattr(ops, name)
        plain_fn = getattr(plain, name + "_ref")
        err = 0.0
        for args in samples:
            got, want = fn(*args), plain_fn(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, want))
        if err != 0:
            fail(f"{name} differs from its plain version (max |err| {err})")
        sizes = sorted(tap.sizes[name])
        median = sizes[len(sizes) // 2]
        args = min(samples, key=lambda a: abs(
            (a[2].numel() if name == "bucket_update" else 0) - median))
        counts, alive = args[0], args[1]
        n = counts.numel()
        nbytes = (counts.element_size() + 1) * n + 4
        library_ms = None
        if name == "bucket_update":
            k = args[2].numel()
            nbytes += (8 + counts.element_size()) * k
            nbytes += counts.element_size() * n + 4 * 32
            shape = (f"n={n} {counts.dtype} batch={k} (median of "
                     f"{len(sizes)} calls; largest {sizes[-1]})")
        else:
            i32 = torch.iinfo(torch.int32).max
            shape = f"n={n} {counts.dtype} ({len(sizes)} calls)"
            library_ms = time_ms(lambda: torch.amin(torch.where(
                alive, torch.clamp(counts, max=i32), i32)), iters=20)
        b_ms, b_by = bound(nbytes, 0)
        rows[name] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: fn(*args), iters=20),
            plain_ms=time_ms(lambda: plain_fn(*args), iters=20),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            shape=f"{shape}; {len(samples)} path inputs checked",
            **timings(name, lambda: fn(*args), 20),
        )
        print(f"kernel {name}: bitwise equal to plain on "
              f"{len(samples)} inputs from the peeling path "
              f"({rows[name]['shape']})", flush=True)
        one_operation(name, fn, args)

    return rows


def one_operation(name, fn, args, calls: int = 20, tries: int = 3) -> None:
    """Phase 8: ``bucket_min`` and ``bucket_update`` on path inputs must
    each put exactly one device operation on the stream per call, their
    own kernel: no copy, memset or fill beside it. One trace holds
    ``calls`` calls, since a trace of one call can lose its only device
    record (``scripts/torch_profiler_probe.py`` counts how often). A
    device operation of any other kind, or more launches than calls,
    fails at once; a trace with fewer launches and nothing else (records
    dropped) is taken again, up to ``tries`` traces in all."""
    sym = KERNEL_SYMBOLS[name][0]
    for attempt in range(1, tries + 1):
        rows = device_rows(lambda: fn(*args), calls)
        print(f"{name}: device operations of {calls} calls "
              f"(trace {attempt}): "
              f"{[(key[:60], count) for key, count, _t in rows]}", flush=True)
        other = [(key, count) for key, count, _t in rows if sym not in key]
        launched = sum(count for key, count, _t in rows if sym in key)
        if other or launched > calls:
            fail(f"{calls} {name} calls put {launched} launches of its "
                 f"kernel and {sum(c for _k, c in other)} other device "
                 f"operations on the stream, not one kernel each")
        if launched == calls:
            return
    fail(f"{tries} traces of {calls} {name} calls each showed fewer "
         f"launches of its kernel than calls (last: {launched})")


def profile_peel_window(g_tips, dev, lo: int = 2000, hi: int = 3000):
    """Phase 8, continued: one more ``peel_tips(engine="device")`` call
    with ``torch.profiler`` recording only its rounds ``lo`` to ``hi``
    (a profiler step at each round's host sync, so the trace stays
    small); prints the device's busy time beside the host wall of the
    same rounds, per host sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core import peel_tips, pipeline

    fetch = pipeline.fetch
    marks = {}
    rounds = 0

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=lo - 1, warmup=1, active=hi - lo,
                                   repeat=1)) as prof:
        def stepped(st, values):
            nonlocal rounds
            rounds += 1
            if rounds in (lo, hi):
                torch.cuda.synchronize()
                marks[rounds] = time.perf_counter()
            prof.step()
            return fetch(st, values)

        pipeline.fetch = stepped
        try:
            r = peel_tips(g_tips, engine="device",
                          count_kwargs={"engine": "fused_cuda"}, device=dev)
        finally:
            pipeline.fetch = fetch
        torch.cuda.synchronize()
    if len(marks) < 2:
        print(f"profile: the call ran {r.report.host_syncs} syncs, fewer "
              f"than {hi} (not measured)", flush=True)
        return
    busy = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    if not busy:
        print("profile: the trace shows no device time (not measured)",
              flush=True)
        return
    busy_ms = sum(ms for ms, _k, _c in busy)
    wall_ms = (marks[hi] - marks[lo]) * 1e3
    n = hi - lo
    print(f"profile tips device bucket exact, rounds {lo}-{hi}: device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; per round (one host sync each): "
          f"{wall_ms / n:.4f} ms wall, {busy_ms / n:.4f} ms device", flush=True)
    for ms, key, count in sorted(busy, reverse=True)[:8]:
        print(f"  {ms:10.3f} ms  {count:8d}x  {key[:80]}", flush=True)


def approx_phase(g, dev, launches) -> None:
    """Phase 9, first part: the approximate tier on the smoke graph,
    each call against the pinned JAX reference."""
    from repro_torch.core import approx_count
    from repro_torch.kernels import ops

    with open(APPROX_REFERENCE) as f:
        ref = json.load(f)
    if (ref["m"], ref["content_hash"]) != (g.m, g.content_hash()):
        fail("the approximate-tier pin is for another graph")
    for name, want in ref["calls"].items():
        kw = want["kwargs"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        r = approx_count(g, seed=ref["seed"], device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        est = r.report.estimator
        got = dict(estimate=r.estimate, stddev=r.stddev, ci95=r.ci95, p=r.p,
                   n_samples=r.n_samples,
                   kept_m=(int(est.split("kept_m=")[1].split("/")[0])
                           if "kept_m=" in est else None))
        print(f"approx {name} {kw}: wall {wall:.3f} s, peak {peak:.3f} GiB, "
              f"launches {used}, {got}, rungs {r.report.summary()}",
              flush=True)
        for field in APPROX_FIELDS:
            if got[field] != want[field]:
                fail(f"approx {name}: {field} {got[field]!r} differs from "
                     f"the pinned {want[field]!r}")
        reps = kw.get("reps", 0)
        if used["fused_count_tiles"] != reps:
            fail(f"approx {name}: {used['fused_count_tiles']} fused_count_tiles"
                 f" launches for {reps} repetitions")
        rung = "sample" if kw["method"] == "sample" else "fused_cuda"
        if r.report.final_rung != rung or r.report.degraded:
            fail(f"approx {name} did not finish on {rung}: "
                 f"{r.report.summary()}")
        for key, n in used.items():
            launches[key] += n
    print("approx: every estimate, stddev, ci95, p, n_samples and kept_m "
          "equal to the pinned JAX reference", flush=True)


def report_line(label: str, r, peak=None) -> None:
    s = r.service
    mem = "" if peak is None else f", peak {peak:.3f} GiB"
    print(f"serve {label}: total {s.total_wall_s:.3f} s, queue wait "
          f"{s.queue_wait_s:.3f} s, exec {s.exec_wall_s:.3f} s, cache "
          f"{s.cache}, rungs {s.rungs_tried}{mem}"
          + (f", {s.estimator}" if s.approximate else ""), flush=True)


class HostTap:
    """Sums the host seconds of named module functions while it is
    entered (the functions still run as before)."""

    def __init__(self, targets):
        self.targets = targets
        self.secs = {}
        self.orig = []

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.secs[_name] = (self.secs.get(_name, 0.0)
                                        + time.perf_counter() - t0)

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)


def service_split(svc, query) -> None:
    """One more count query (a key not yet served) with its host steps
    timed and the device's work traced: how its wall splits between the
    host and the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import count as count_mod, pipeline
    from repro_torch.kernels import ops

    targets = [(count_mod, "device_graph"), (count_mod, "host_wedge_counts"),
               (pipeline, "plan_count"), (ops, "fused_work")]
    torch.cuda.synchronize()
    with HostTap(targets) as tap, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        r = svc.query(query)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / 1e6
    wall = r.service.exec_wall_s
    steps = ", ".join(f"{k} {v:.3f} s" for k, v in tap.secs.items())
    print(f"serve split {query.mode} count: exec {wall:.3f} s, device busy "
          f"{busy:.4f} s (idle share {1 - busy / wall:.4f}); host steps: "
          f"{steps}", flush=True)


def wait_refined(svc, timeout_s: float = 300.0) -> None:
    """Wait for the service's refine-behind recounts to finish."""
    stop = time.monotonic() + timeout_s
    while time.monotonic() < stop:
        with svc._lock:
            if not svc._refining:
                return
        time.sleep(0.05)
    fail("the refine-behind recount did not finish")


def service_phase(g, g_tips, dev, launches) -> None:
    """Phase 9, second part: the query service on the card."""
    from repro_torch.core.wedges import auto_chunk_budget
    from repro_torch.kernels import ops
    from repro_torch.serve import ButterflyService, Query

    with open(REFERENCE) as f:
        ref = json.load(f)
    with open(PEEL_REFERENCE) as f:
        peel_ref = json.load(f)["PEEL_TIPS"]
    with open(APPROX_REFERENCE) as f:
        sample_ref = json.load(f)["service_sample"]

    def check_counts(label, res, mode):
        if mode in ("global", "all") and int(res.total) != ref["total"]:
            fail(f"serve {label}: total {int(res.total)} differs from the "
                 f"pinned {ref['total']}")
        fields = {"vertex": ("per_u", "per_v"), "edge": ("per_edge",),
                  "all": ("per_u", "per_v", "per_edge")}.get(mode, ())
        for field in fields:
            arr = getattr(res, field)
            if arr.dtype != np.int64 or digest(arr) != ref["sha256_int64"][field]:
                fail(f"serve {label}: {field} differs from the pinned counts")

    def check_peel(label, res):
        want = peel_ref["exact"]
        if (digest(res.numbers) != want["sha256_int64"]
                or (res.rounds, res.sub_rounds) != (want["rounds"],
                                                    want["sub_rounds"])):
            fail(f"serve {label}: tip numbers or rounds differ from the pin")

    def serial(svc, label, q, expect_rung=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        r = svc.query(q)
        torch.cuda.synchronize()
        used = dict(ops.LAUNCHES)
        report_line(label, r, torch.cuda.max_memory_allocated() / 2**30)
        print(f"  launches {used}", flush=True)
        if expect_rung is not None and (r.service.final_rung != expect_rung
                                        or r.service.degraded):
            fail(f"serve {label} did not finish on {expect_rung}: "
                 f"{r.service.summary()}")
        for name, n in used.items():
            launches[name] += n
        return r, used

    with ButterflyService(device=dev, workers=2) as svc:
        for key, graph in (("smoke", g), ("tips", g_tips)):
            t0 = time.perf_counter()
            svc.register(key, graph)
            print(f"serve register {key}: {time.perf_counter() - t0:.3f} s "
                  f"on the host (m={graph.m})", flush=True)
        q = Query(graph="smoke", kind="count", mode="global")
        r, used = serial(svc, "count global", q, "fused_cuda")
        if used["fused_count_tiles"] != 1:
            fail("the service's global count did not launch fused_count_tiles")
        check_counts("count global", r.result, "global")
        print(f"serve: the plans used auto_chunk_budget {auto_chunk_budget(dev)}"
              f" wedges", flush=True)
        r, used = serial(svc, "count all", Query(graph="smoke", mode="all"),
                         "fused_cuda")
        check_counts("count all", r.result, "all")
        r, used = serial(svc, "count global again", q)
        if r.service.cache != "hit" or sum(used.values()):
            fail(f"the repeated global query was not a cache hit without "
                 f"launches: {r.service.summary()}, {used}")
        # the global query left the exact answer in the cache; without
        # it the approximate query cannot be upgraded before it samples
        svc.cache.invalidate_version(svc.registered()["smoke"])
        qa = Query(graph="smoke", kind="count", mode="global",
                   accuracy="approx", eps=0.1, deadline_s=1e-6,
                   allow_stale=False)
        torch.cuda.synchronize()
        ops.reset_launches()
        r = svc.query(qa)
        report_line("count approx, 1 us deadline", r)
        if (not r.service.approximate or r.service.final_rung != "sample"
                or not r.service.refining):
            fail(f"the approximate query was not answered by the sample "
                 f"rung with a refine behind it: {r.service.summary()}")
        for field in ("estimate", "stddev", "ci95", "n_samples"):
            if getattr(r.result, field) != sample_ref[field]:
                fail(f"serve approx: {field} {getattr(r.result, field)!r} "
                     f"differs from the pinned {sample_ref[field]!r}")
        t0 = time.perf_counter()
        wait_refined(svc)
        torch.cuda.synchronize()
        used = dict(ops.LAUNCHES)
        print(f"serve refine-behind: done {time.perf_counter() - t0:.3f} s "
              f"after the approximate answer; launches {used}", flush=True)
        for name, n in used.items():
            launches[name] += n
        r, used = serial(svc, "count approx again", qa)
        if r.service.cache != "hit" or r.service.approximate:
            fail(f"the approximate query was not upgraded to the exact "
                 f"answer: {r.service.summary()}")
        check_counts("count approx again", r.result, "global")
        r, used = serial(svc, "peel_tips device",
                         Query(graph="tips", kind="peel_tips",
                               engine="device"), "device/exact")
        if used["bucket_update"] == 0 or used["fused_count_tiles"] != 1:
            fail(f"the service's peel query launched {used}")
        check_peel("peel_tips device", r.result)
        serial_peel = r.result
        service_split(svc, Query(graph="smoke", kind="count", mode="vertex"))

    # six mixed queries at once on a fresh service: each equals its
    # serial answer (launch counts are shared by the worker threads, so
    # only the batch's total is read)
    mix = [Query(graph="smoke", mode="global"),
           Query(graph="smoke", mode="vertex"),
           Query(graph="smoke", mode="edge"),
           Query(graph="smoke", mode="all"),
           Query(graph="smoke", accuracy="approx"),
           Query(graph="tips", kind="peel_tips", engine="device")]
    with ButterflyService(device=dev, workers=2) as svc:
        svc.register("smoke", g)
        svc.register("tips", g_tips)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        futs = [svc.submit(q) for q in mix]
        rs = [f.result() for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = dict(ops.LAUNCHES)
        for q, r in zip(mix, rs):
            report_line(f"concurrent {q.kind} {q.mode} {q.accuracy}", r)
            if q.kind == "count":
                if r.service.approximate:
                    fail("an approximate query without a deadline came "
                         "back approximate")
                check_counts(f"concurrent {q.mode}", r.result, q.mode)
            elif not np.array_equal(r.result.numbers, serial_peel.numbers):
                fail("the concurrent peel query differs from the serial one")
        print(f"serve concurrent: {len(mix)} queries on 2 workers in "
              f"{wall:.3f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
              f" GiB, launches {used}; every answer equal to its serial "
              f"answer", flush=True)
        for name, n in used.items():
            launches[name] += n


class SupervisorTap:
    """While a supervised peeling run goes: times each committed round's
    checkpoint (``PeelSupervisor._capture``: the support fetch, the
    capture and the file write) and its file's bytes; steps a profiler
    at each of the supervisor's host reads (``_fetch``) and marks the
    host clock at reads ``lo`` and ``hi``; and keeps a copy of the
    inputs of the largest ``bucket_update`` reduction."""

    def __init__(self, dist, ops, prof=None, lo=0, hi=0):
        self.dist, self.ops, self.prof = dist, ops, prof
        self.lo, self.hi = lo, hi
        self.saves, self.marks, self.fetches = [], {}, 0
        self.largest = None

    def __enter__(self):
        sup = self.dist.PeelSupervisor
        self.orig = (sup._capture, sup._fetch, self.ops.bucket_update)
        capture, fetch, update = self.orig
        tap = self

        def timed_capture(this, st, support=None):
            t0 = time.perf_counter()
            capture(this, st, support)
            secs = time.perf_counter() - t0
            d = this.store.directory
            path = os.path.join(d, f"checkpoint_round_{st.rounds:06d}.json")
            tap.saves.append((st.rounds, secs,
                              os.path.getsize(path) if d else 0))

        def stepped_fetch(this, t):
            tap.fetches += 1
            if tap.prof is not None:
                if tap.fetches in (tap.lo, tap.hi):
                    torch.cuda.synchronize()
                    tap.marks[tap.fetches] = time.perf_counter()
                tap.prof.step()
            return fetch(this, t)

        def kept_update(counts, alive, idx, dec):
            if tap.largest is None or idx.numel() > tap.largest[2].numel():
                tap.largest = tuple(a.clone() for a in
                                    (counts, alive, idx, dec))
            return update(counts, alive, idx, dec)

        sup._capture, sup._fetch = timed_capture, stepped_fetch
        self.ops.bucket_update = kept_update
        return self

    def __exit__(self, *exc):
        sup = self.dist.PeelSupervisor
        sup._capture, sup._fetch, self.ops.bucket_update = self.orig


def distributed_phase(g, wedges, dev, launches) -> None:
    """Phase 10: checkpoints and distributed execution on the card, each
    call with the launch counts zeroed just before it and read just
    after, each against the pinned JAX references. ``wedges`` is the
    smoke graph's wedge count, which sizes the mesh's tiles."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core import (
        CheckpointStore, peel_tips, peel_tips_stored, peel_wings,
    )
    from repro_torch.core import distributed as dist
    from repro_torch.data.graphs import powerlaw_bipartite
    from repro_torch.kernels import ops, ref as plain
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.testing import faults

    with open(REFERENCE) as f:
        ref = json.load(f)
    with open(PEEL_REFERENCE) as f:
        peel_ref = json.load(f)

    def run(label, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name, n in used.items():
            launches[name] += n
        print(f"{label}: wall {wall:.3f} s, peak {peak:.3f} GiB, launches "
              f"{used}", flush=True)
        return out, used, wall

    def check_peel(label, r, want, rung="distributed"):
        rep = r.report
        if rep.final_rung != rung or rep.retries:
            fail(f"{label} finished on {rep.final_rung}, not {rung}, or "
                 f"re-dispatched a worker no fault delayed: "
                 f"{rep.summary()}")
        if r.numbers.dtype != np.int64 or digest(r.numbers) != want[
                "sha256_int64"]:
            fail(f"{label}: numbers differ from the pinned JAX reference")
        if (digest(r.round_sizes) != want["round_sizes_sha256_int64"]
                or (r.rounds, r.sub_rounds) != (want["rounds"],
                                                want["sub_rounds"])):
            fail(f"{label}: round data {r.rounds}/{r.sub_rounds} differ "
                 f"from the pinned {want['rounds']}/{want['sub_rounds']}")
        print(f"{label}: numbers, rounds {r.rounds}, sub_rounds "
              f"{r.sub_rounds} and round sizes equal the pin; host syncs "
              f"{rep.host_syncs}, largest frontier {rep.frontier_lanes} "
              f"items, restores {rep.checkpoint_restores}, re-dispatches "
              f"{rep.retries}", flush=True)
        for child in rep.children:
            print(f"  {child.summary()}", flush=True)

    # 1. mesh-partitioned counting on the smoke graph, 4 workers on 1 card
    mesh = make_test_mesh((4,), ("data",), device=dev)
    # a power of two near a 16th of the wedges, so every worker holds
    # tiles (the default budget cuts the smoke graph into 5 tiles)
    max_chunk = 1 << max(int(wedges // 16).bit_length() - 1, 7)
    cards = sorted(set(map(str, mesh.workers())))
    print(f"distributed count: 4 workers on {cards}, max_chunk {max_chunk} "
          f"wedges", flush=True)
    holders = None
    for mode in ("global", "vertex", "edge"):
        (out, rg), used, _ = run(
            f"distributed_count mode={mode}",
            lambda: dist.distributed_count(
                g, mesh, mode=mode, count_dtype=torch.int64,
                engine="fused", max_chunk=max_chunk))
        if holders is None:
            tiles, cap = dist.plan_fused_partition(rg, 4, max_chunk=max_chunk)
            held = (tiles[:, :, 1] > tiles[:, :, 0]).sum(1)
            holders = int((held > 0).sum())
            print(f"distributed count plan: tiles per worker {held.tolist()}, "
                  f"tile_cap {cap}", flush=True)
            if holders != 4:
                fail(f"only {holders} of 4 workers hold tiles")
        if used["fused_count_tiles"] != holders:
            fail(f"distributed_count mode={mode} launched fused_count_tiles "
                 f"{used['fused_count_tiles']} times, not once per worker")
        out = out.cpu().numpy()
        if mode == "global":
            if int(out) != ref["total"]:
                fail(f"distributed total {int(out)} != pinned {ref['total']}")
        elif mode == "vertex":
            for field, idx in (("per_u", rg.rank_of_u),
                               ("per_v", rg.rank_of_v)):
                if digest(out[idx]) != ref["sha256_int64"][field]:
                    fail(f"distributed {field} differs from the pin")
        elif digest(out) != ref["sha256_int64"]["per_edge"]:
            fail("distributed per_edge differs from the pin")
    print("distributed count: total, per-vertex and per-edge equal the pin",
          flush=True)

    graphs = {}
    for name in ("PEEL_TIPS", "PEEL_WINGS_HOST"):
        spec = peel_ref[name]["generator"]
        graphs[name] = powerlaw_bipartite(spec["n_u"], spec["n_v"], spec["m"],
                                          seed=spec["seed"])
        if graphs[name].content_hash() != peel_ref[name]["content_hash"]:
            fail(f"{name} differs from the pinned graph")

    # 2. distributed tips at full size: 4 workers, one lost mid-run
    tips_ref = peel_ref["PEEL_TIPS"]
    lost_round = tips_ref["range"]["rounds"] // 2
    lo, hi = 2000, 3000
    with tempfile.TemporaryDirectory() as d:
        store = CheckpointStore(directory=d, retain_last=2)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=lo - 1, warmup=1, active=hi - lo,
                                       repeat=1)) as prof, \
                SupervisorTap(dist, ops, prof, lo, hi) as tap, \
                faults.inject("device_loss", site=f"round{lost_round}.",
                              times=1, device=1) as lost:
            r, used, wall = run(
                "distributed peel_tips PEEL_TIPS devices=4",
                lambda: peel_tips(graphs["PEEL_TIPS"], devices=4,
                                  checkpoint=store,
                                  count_kwargs={"engine": "fused_cuda"},
                                  device=dev))
        files = sorted(os.listdir(d))
    check_peel("distributed tips", r, {**tips_ref["range"],
                                       "sha256_int64":
                                       tips_ref["exact"]["sha256_int64"]})
    rep = r.report
    final = sum(c.final_rung is not None for c in rep.children)
    print(f"distributed tips: device loss at round {lost_round} fired "
          f"{lost.fired}x ({lost.hits}); restores {rep.checkpoint_restores}, "
          f"workers {len(rep.children)} -> {final}; {len(files)} checkpoint "
          f"files left ({files}); sub-rounds {r.sub_rounds}", flush=True)
    if (lost.fired != 1 or rep.checkpoint_restores != 1 or final != 3
            or len(files) > 2):
        fail("distributed tips: expected one loss, one restore, 3 workers "
             "left and at most 2 files")
    for name in ("bucket_update", "bucket_min", "fused_count_tiles"):
        if used[name] == 0:
            fail(f"distributed tips ran without launching {name}")
    secs = [s for _r, s, _b in tap.saves]
    nbytes = [b for _r, _s, b in tap.saves]
    print(f"distributed tips checkpoints: {len(tap.saves)} saves, "
          f"{sum(secs):.3f} s in all, per committed round "
          f"{np.mean(secs):.4f} s mean / {max(secs):.4f} s max, "
          f"{int(np.mean(nbytes))} B mean / {max(nbytes)} B max", flush=True)
    print(f"distributed tips: {rep.host_syncs} host syncs for "
          f"{r.sub_rounds} sub-rounds, {wall / r.sub_rounds * 1e3:.4f} ms of "
          f"wall per sub-round (the profiled window included)", flush=True)
    busy = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    if len(tap.marks) == 2 and busy:
        busy_ms = sum(ms for ms, _k, _c in busy)
        win_ms = (tap.marks[hi] - tap.marks[lo]) * 1e3
        print(f"profile distributed tips, host reads {lo}-{hi}: device busy "
              f"{busy_ms:.3f} ms of {win_ms:.3f} ms wall, idle share "
              f"{1 - busy_ms / win_ms:.4f}; per read {win_ms / (hi - lo):.4f}"
              f" ms wall, {busy_ms / (hi - lo):.4f} ms device", flush=True)
        for ms, key, count in sorted(busy, reverse=True)[:8]:
            print(f"  {ms:10.3f} ms  {count:8d}x  {key[:80]}", flush=True)
    else:
        print("profile distributed tips: no device time in the window "
              "(not measured)", flush=True)
    # the largest reduction of the run, against its plain version
    args = tap.largest
    got, want = ops.bucket_update(*args), plain.bucket_update_ref(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        fail(f"bucket_update differs from its plain version on the "
             f"supervisor's largest reduction (max |err| {err})")
    print(f"bucket_update: bitwise equal to plain on the supervisor's "
          f"largest reduction (n={args[0].numel()}, batch "
          f"{args[2].numel()})", flush=True)
    del tap, args, got, want

    # 3. wings and stored tips through the supervisor, 2 workers
    host_ref = peel_ref["PEEL_WINGS_HOST"]
    gw = graphs["PEEL_WINGS_HOST"]
    r, used, _ = run("distributed peel_wings PEEL_WINGS_HOST devices=2",
                     lambda: peel_wings(gw, devices=2,
                                        count_kwargs={"engine": "fused_cuda"},
                                        device=dev))
    check_peel("distributed wings", r, {**host_ref["range"], "sha256_int64":
                                        host_ref["exact"]["sha256_int64"]})
    r, used, _ = run("distributed peel_tips_stored PEEL_WINGS_HOST devices=2",
                     lambda: peel_tips_stored(
                         gw, devices=2, count_kwargs={"engine": "fused_cuda"},
                         device=dev))
    tref = host_ref["tips"]
    if r.side != tref["side"]:
        fail(f"stored tips peeled side {r.side}, pinned {tref['side']}")
    check_peel("distributed stored tips", r, {
        **tref["range"], "sha256_int64": tref["exact"]["sha256_int64"]})
    for name in ("bucket_update", "fused_count_tiles"):
        if used[name] == 0:
            fail(f"distributed stored tips ran without launching {name}")

    # 4. resume: a run budget that expires mid-run, then a run without one
    with tempfile.TemporaryDirectory() as d:
        with faults.inject("slow", site="round3.", times=None, delay=4.0):
            r, used, _ = run(
                "distributed peel_tips PEEL_WINGS_HOST devices=2 deadline_s=2",
                lambda: peel_tips(gw, devices=2, checkpoint=d, deadline_s=2.0,
                                  count_kwargs={"engine": "fused_cuda"},
                                  device=dev))
        first = r.report.attempts[0]
        committed = max(int(f[len("checkpoint_round_"):-5])
                        for f in os.listdir(d))
        print(f"resume: the supervised run ended {first.outcome} "
              f"({first.detail[:120]}), {committed} rounds committed; the "
              f"ladder finished on {r.report.final_rung}", flush=True)
        if first.outcome != "deadline-exceeded" or committed < 1:
            fail("the deadline did not stop the supervised run after a "
                 "committed round")
        r, used, _ = run("distributed peel_tips PEEL_WINGS_HOST resumed",
                         lambda: peel_tips(
                             gw, devices=2, checkpoint=d,
                             count_kwargs={"engine": "fused_cuda"},
                             device=dev))
    if r.report.resumed_from_round != committed:
        fail(f"the second run resumed from round "
             f"{r.report.resumed_from_round}, not {committed}")
    check_peel("resumed tips", r, {**tref["range"], "sha256_int64":
                                   tref["exact"]["sha256_int64"]})


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
    phase(2)
    ops.build()
    info = ops.build_info
    print(f"build: {info['seconds']:.1f} s (compiled={info['compiled']}) "
          f"{info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}", flush=True)

    # -- 3. graph ------------------------------------------------------
    phase(3)
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
    phase(4)
    rows = check_kernels(g, rg, ref, dev)
    torch.cuda.empty_cache()

    # -- 5. the main path ----------------------------------------------
    phase(5)
    results = {}
    walls = {}
    launches = {name: 0 for name in ops.LAUNCHES}
    blocks = batch_blocks(rg)
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
              f"{blocks.get(agg, '')}rungs {rep.summary()}", flush=True)
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
        results[engine, agg] = r
        walls[engine, agg] = wall

    base = results["fused_cuda", "sort"]
    for key, r in results.items():
        for field in ("total", "per_u", "per_v", "per_edge"):
            a, b = getattr(base, field), getattr(r, field)
            if a.dtype != np.int64 or not np.array_equal(a, b):
                fail(f"{key} {field} differs from fused_cuda")
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
    print(f"counts: total={total} bitwise equal across {list(MAIN_PATH)} "
          f"and to the pinned JAX reference", flush=True)

    # -- 6. where one fused_cuda call spends its time -------------------
    phase(6)
    profile_call(g, dev, walls["fused_cuda", "sort"])
    del rg, results, base
    torch.cuda.empty_cache()

    # -- 7. the peeling path ---------------------------------------------
    phase(7)
    tap, g_tips = peel_phase(dev, launches)

    # -- 8. the peeling kernels against their plain versions -------------
    phase(8)
    rows.update(peel_kernel_rows(tap))
    del tap
    profile_peel_window(g_tips, dev)

    # -- 9. the approximate tier and the query service --------------------
    phase(9)
    approx_phase(g, dev, launches)
    service_phase(g, g_tips, dev, launches)

    # -- 10. checkpoints and distributed execution -----------------------
    phase(10)
    distributed_phase(g, W, dev, launches)

    # -- 11. report -----------------------------------------------------
    phase(11)
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
            "device_ms": row["device_ms"], "host_us": row["host_us"],
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
