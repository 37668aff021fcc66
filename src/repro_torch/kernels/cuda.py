"""Build and bind the hand-written CUDA kernels (Hopper, ``sm_90a``).

The sources under ``csrc/`` are compiled at first use, never at import:
one ``nvcc -c`` per source, all started together, then one link into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``_build/`` beside this file under a name that hashes
the sources and flags, so an edited source is rebuilt, and concurrent
builds (several test workers) never load a half-written file.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with torch, launches on the current stream of the
tensors' device, and raises if the launch reported a CUDA error. Only
``kernels/ops.py`` imports this module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "MAX_TILE_CAP",
    "FUSED_LIGHT_SLOTS",
    "FUSED_LIGHT_CAP",
    "FUSED_L2_BYTES",
    "FUSED_MAX_IN_FLIGHT",
    "HIST_PART_BITS",
    "HIST_MAX_COARSE",
    "HistogramPlan",
    "histogram_plan",
    "FusedWork",
    "fused_work",
    "upload_work",
    "build",
    "build_info",
    "wedge_histogram",
    "butterfly_combine",
    "fused_count_tiles",
    "bucket_min",
    "bucket_update",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("wedge_histogram.cu", "butterfly_combine.cu", "fused_count_tiles.cu",
           "bucket_min.cu", "bucket_update.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# Largest tile (in wedges) the fused kernel takes. Its scratch no longer
# grows with the tile: light segments (one vertex's wedges in one tile)
# are grouped in shared memory, heavy ones in at most FUSED_L2_BYTES of
# dense per-vertex counters (see fused_work). A segment must stay below
# 2^32 wedges for the counters' 32-bit halves, which every tile under
# this cap is. The value stays 2^26 so that no plan, and no descent of
# the ladder to ``fused``, changes.
MAX_TILE_CAP = 1 << 26

# fused_count_tiles: a light block's shared-memory hash table holds
# FUSED_LIGHT_SLOTS 4-byte keys and 4-byte counts (224 KiB of the 227 KB
# a block may take); a segment owns 2 slots per wedge, so segments of at
# most FUSED_LIGHT_CAP wedges are light and a light batch holds at most
# that many. On the smoke graph (low) this leaves 611 heavy vertices
# carrying 88% of the wedges. A heavy segment's dense counter can touch
# at most one 32-byte sector per wedge and no more than its 8 B x n_pad
# array; the counters in flight in one round may reach at most
# FUSED_L2_BYTES that way (about half of the H100's 50 MB L2), and at
# most FUSED_MAX_IN_FLIGHT of them, the counter buffers allocated.
FUSED_LIGHT_SLOTS = 28_672
FUSED_LIGHT_CAP = FUSED_LIGHT_SLOTS // 2
FUSED_L2_BYTES = 24 << 20
FUSED_MAX_IN_FLIGHT = 16
FUSED_SECTOR = 32
FUSED_CHUNK_MIN = 256    # one wedge per thread of a heavy block
FUSED_CHUNK_MAX = 4096
FUSED_BLOCKS_PER_SM = 8  # the heavy kernel's resident blocks

# wedge_histogram: S = 2^HIST_PART_BITS int32 bins of shared memory per
# block (64 KiB; 2^14 measured faster than 2^13 and 2^15 at the hash
# path's 2^28 buckets, see PERF.md). A table of at most S buckets is
# counted in one launch of one block per SM; a larger one is split into
# partitions of S buckets, in at most HIST_MAX_COARSE coarse groups (of
# at most 2^31 / (S * HIST_MAX_COARSE) = 512 partitions, the kernel's
# limit), and its keys are bucketed by coarse group, then by partition
# (histogram_plan).
HIST_PART_BITS = 14
HIST_MAX_COARSE = 256

_lock = threading.Lock()
_lib = None
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "bf_wedge_histogram": (_P, _I, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "bf_butterfly_combine": (_P, _P, _P, _L, _P, _P, _P),
    "bf_fused_count_tiles": (
        _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
        _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P,
    ),
    "bf_bucket_min": (_P, _I, _P, _L, _P, _I, _P, _P),
    "bf_bucket_update": (_P, _I, _P, _L, _P, _P, _L, _P, _P, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(lib_path: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    place atomically. Returns the compilers' combined output."""
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                   str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for name, _obj, p in procs:
            out, _ = p.communicate()
            log.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        so_tmp = tmp / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so_tmp),
             *(str(obj) for _n, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}")
        os.replace(so_tmp, lib_path)
        return "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent.
    ``build_info`` records the library path, whether this call compiled
    it, the seconds taken, and the compilers' output (``-Xptxas -v``:
    registers, shared memory and spills per kernel)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"libbf_kernels_{_digest()}.so"
        compiled = not lib_path.exists()
        log = _compile(lib_path) if compiled else ""
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.bf_error_string.argtypes = [ctypes.c_int]
        lib.bf_error_string.restype = ctypes.c_char_p
        build_info.update(path=str(lib_path), compiled=compiled,
                          seconds=time.perf_counter() - t0, log=log)
        _lib = lib
        return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(lib, code: int, name: str) -> None:
    if code != 0:
        msg = lib.bf_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype,
             device: torch.device, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _mask(valid: torch.Tensor) -> torch.Tensor:
    """A bool (stored as one byte per entry) contiguous mask."""
    if valid.dtype == torch.bool and valid.is_contiguous():
        return valid.view(-1)
    v = valid.reshape(-1)
    if v.dtype != torch.bool:
        v = v > 0
    return v.contiguous()


class HistogramPlan(NamedTuple):
    """How ``wedge_histogram`` splits a table of ``num_buckets``.
    ``regime`` "shared": one launch, one private table per block.
    "partitioned": ``parts`` partitions of ``part_bins`` buckets (the
    last holds ``last_bins``) in ``coarse`` groups of ``2^coarse_bits``;
    ``blocks`` blocks count and scatter the keys. ``scratch_bytes`` is
    what the wrapper allocates besides the output: 6 B per key (a
    4-byte and a 2-byte copy) and ``offsets`` int64 entries."""

    regime: str
    parts: int
    part_bins: int
    last_bins: int
    coarse: int
    coarse_bits: int
    blocks: int
    offsets: int
    scratch_bytes: int


def histogram_plan(num_buckets: int, n_keys: int, sms: int) -> HistogramPlan:
    """The regime, partitions and scratch of one ``wedge_histogram``
    call over ``n_keys`` keys on a card with ``sms`` SMs (pure Python)."""
    if not 0 < num_buckets < 2**31:
        raise ValueError(f"num_buckets must be in [1, 2^31), got {num_buckets}")
    bins = 1 << HIST_PART_BITS
    sms = max(int(sms), 1)
    if num_buckets <= bins:
        return HistogramPlan("shared", 1, num_buckets, num_buckets, 1, 0,
                             sms, 0, 0)
    blocks = 2 * sms  # two key chunks per SM (the count pass runs both at once)
    parts = -(-num_buckets // bins)
    coarse_bits = 0
    while parts > HIST_MAX_COARSE << coarse_bits:
        coarse_bits += 1
    coarse = -(-parts // (1 << coarse_bits))
    offsets = blocks * coarse + coarse + 1 + parts + 1
    return HistogramPlan(
        "partitioned", parts, bins, num_buckets - (parts - 1) * bins, coarse,
        coarse_bits, blocks, offsets, 6 * int(n_keys) + 8 * offsets,
    )


def _launch(lib, name: str, dev: torch.device, *args) -> None:
    """Call ``bf_<name>`` on the current stream of ``dev``, entering the
    device only when it is not already current; raise on a CUDA error."""
    fn = getattr(lib, "bf_" + name)
    if dev.index == torch.cuda.current_device():
        code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, code, name)


def wedge_histogram(keys: torch.Tensor, valid: torch.Tensor,
                    num_buckets: int) -> torch.Tensor:
    """int32 (num_buckets,) histogram of the valid int32 or int64 keys
    in ``[0, num_buckets)``; keys of other integer types are widened."""
    lib = build()
    dev = keys.device
    keys = keys.reshape(-1)
    if keys.dtype not in (torch.int32, torch.int64):
        keys = keys.long()
    keys = keys.contiguous()
    valid = _mask(valid)
    _require(valid, "valid", torch.bool, dev, keys.shape)
    n = keys.numel()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = histogram_plan(int(num_buckets), n, sms)
    if plan.regime == "shared":
        counts = torch.zeros(num_buckets, dtype=torch.int32, device=dev)
        offsets = wide = slots = counts[:0]
    else:
        counts = torch.empty(num_buckets, dtype=torch.int32, device=dev)
        offsets = torch.empty(plan.offsets, dtype=torch.int64, device=dev)
        wide = torch.empty(n, dtype=torch.int32, device=dev)
        slots = torch.empty(n, dtype=torch.int16, device=dev)
    _launch(lib, "wedge_histogram", dev, _ptr(keys),
            int(keys.dtype == torch.int64), _ptr(valid), n, int(num_buckets),
            HIST_PART_BITS, plan.coarse_bits, plan.blocks, _ptr(offsets),
            _ptr(wide), _ptr(slots), _ptr(counts))
    return counts


def butterfly_combine(d: torch.Tensor, rep: torch.Tensor,
                      valid: torch.Tensor):
    """``(dm1 int32 (n,), c2 int64 (n,))``; see the kernel source."""
    lib = build()
    dev = d.device
    d = d.reshape(-1).to(torch.int32).contiguous()
    rep = _mask(rep)
    valid = _mask(valid)
    _require(rep, "rep", torch.bool, dev, d.shape)
    _require(valid, "valid", torch.bool, dev, d.shape)
    dm1 = torch.empty_like(d)
    c2 = torch.empty(d.shape, dtype=torch.int64, device=dev)
    _launch(lib, "butterfly_combine", dev, _ptr(d), _ptr(rep), _ptr(valid),
            d.numel(), _ptr(dm1), _ptr(c2))
    return dm1, c2


class FusedWork(NamedTuple):
    """The fused kernel's work list, from :func:`fused_work`. ``light``
    (n_batches, 4) rows ``(t0, t1, e_lo, e_hi)``: one block's flat wedge
    range and the slot range whose wedge prefix covers it. ``heavy``
    (n_chunks, 5) rows ``(t0, t1, e_lo, e_hi, buffer)``, grouped by round
    through ``rounds`` (n_rounds + 1,) chunk offsets. All three are views
    of ``table``, the one int64 array the kernel reads; ``device`` is
    its copy on the card once :func:`upload_work` made it.
    ``in_flight`` counter buffers of ``n_pad`` uint64 (``scratch_bytes``)
    serve one round's heavy segments."""

    table: np.ndarray
    light: np.ndarray
    heavy: np.ndarray
    rounds: np.ndarray
    in_flight: int
    scratch_bytes: int
    device: "torch.Tensor | None" = None


def _segments(tile_bounds: np.ndarray, vstart: np.ndarray):
    """``(start, end)`` of each vertex's wedges inside each tile, per
    tile in order, empty ones dropped."""
    out = []
    for ws, we in tile_bounds.tolist():
        if we <= ws:
            continue
        lo = int(np.searchsorted(vstart, ws, side="right")) - 1
        hi = int(np.searchsorted(vstart, we, side="left"))
        s = np.maximum(vstart[lo:hi], ws)
        e = np.minimum(vstart[lo + 1:hi + 1], we)
        keep = e > s
        out.append((s[keep], e[keep]))
    return out


def _light_batches(s: np.ndarray, e: np.ndarray, cap: int) -> list:
    """Greedy packing of one tile's segments: consecutive light segments
    (at most ``cap`` wedges, not split by a heavy one) into batches of at
    most ``cap`` wedges."""
    heavy = (e - s) > cap
    light = np.flatnonzero(~heavy)
    ls, le = s[light], e[light]
    run = np.cumsum(heavy)[light]  # heavy segments before: one run each
    out = []
    i, n = 0, light.size
    while i < n:
        j = int(np.searchsorted(le, ls[i] + cap, side="right"))
        j = max(i + 1, min(j, int(np.searchsorted(run, run[i], side="right"))))
        out.append((int(ls[i]), int(le[j - 1])))
        i = j
    return out


def fused_work(tile_bounds: np.ndarray, offsets: np.ndarray,
               w_off: np.ndarray, sms: int) -> FusedWork:
    """The fused kernel's work list for tiles ``[ws, we)`` of flat wedge
    ids (pure numpy, host arrays only): ``offsets`` the (n_pad + 1,) CSR
    offsets, ``w_off`` the (e_pad + 1,) wedge prefix, ``sms`` the card's
    SM count.

    A segment is one vertex's wedges inside one tile. Segments of at most
    ``FUSED_LIGHT_CAP`` wedges are light: consecutive ones are packed
    into batches of at most that many wedges, one block each. Heavier
    ones go, largest first, in rounds: a round takes segments while the
    sectors their counters can touch, ``min(8 x n_pad, FUSED_SECTOR x
    wedges)`` bytes each, stay within ``FUSED_L2_BYTES`` and there are
    at most ``FUSED_MAX_IN_FLIGHT`` of them (a lone segment always
    fits). Each segment is cut into chunks of ``ceil(round wedges /
    (FUSED_BLOCKS_PER_SM x sms))`` wedges, clipped to [FUSED_CHUNK_MIN,
    FUSED_CHUNK_MAX]. Every wedge of every tile is in exactly one batch
    or chunk."""
    tb = np.asarray(tile_bounds, np.int64).reshape(-1, 2)
    w_off = np.asarray(w_off, np.int64)
    n_pad = int(np.asarray(offsets).shape[0]) - 1
    total = int(w_off[-1])
    if tb.size and (int(tb.min()) < 0 or int(tb.max()) > total):
        raise ValueError(f"tile bounds must lie in [0, {total}]")
    vstart = w_off[np.asarray(offsets, np.int64)]
    light, heavy = [], []
    cap = FUSED_LIGHT_CAP
    for s, e in _segments(tb, vstart):
        light += _light_batches(s, e, cap)
        big = (e - s) > cap
        heavy += zip(s[big].tolist(), e[big].tolist())
    heavy.sort(key=lambda se: se[0] - se[1])  # largest first (stable)
    groups, used = [], 0
    for s, e in heavy:
        reach = min(8 * n_pad, FUSED_SECTOR * (e - s))
        if not groups or (groups[-1] and (
                used + reach > FUSED_L2_BYTES
                or len(groups[-1]) == FUSED_MAX_IN_FLIGHT)):
            groups.append([])
            used = 0
        groups[-1].append((s, e))
        used += reach
    k = max((len(segs) for segs in groups), default=0)
    chunks, rounds = [], [0]
    for segs in groups:
        width = -(-sum(e - s for s, e in segs) // (FUSED_BLOCKS_PER_SM * sms))
        width = min(max(width, FUSED_CHUNK_MIN), FUSED_CHUNK_MAX)
        for buf, (s, e) in enumerate(segs):
            starts = np.arange(s, e, width, dtype=np.int64)
            chunks.append(np.stack([starts, np.minimum(starts + width, e),
                                    np.full_like(starts, buf)], axis=1))
        rounds.append(rounds[-1] + sum(-(-(e - s) // width) for s, e in segs))
    lt = np.asarray(light, np.int64).reshape(-1, 2)
    hv = (np.concatenate(chunks) if chunks
          else np.zeros((0, 3), np.int64))

    def with_slots(rows):  # (t0, t1) -> (t0, t1, e_lo, e_hi)
        e_lo = np.searchsorted(w_off, rows[:, 0], side="right") - 1
        e_hi = np.searchsorted(w_off, rows[:, 1] - 1, side="right")
        return np.stack([rows[:, 0], rows[:, 1], e_lo, e_hi], axis=1)

    table = np.concatenate([
        with_slots(lt).ravel(),
        np.concatenate([with_slots(hv[:, :2]), hv[:, 2:]], axis=1).ravel(),
        np.asarray(rounds, np.int64),
    ]).astype(np.int64)
    n_l, n_h = 4 * lt.shape[0], 5 * hv.shape[0]
    return FusedWork(
        table, table[:n_l].reshape(-1, 4), table[n_l:n_l + n_h].reshape(-1, 5),
        table[n_l + n_h:], k, 8 * k * n_pad,
    )


def upload_work(work: FusedWork, dev: torch.device) -> FusedWork:
    """``work`` with its table on ``dev``: copied from pinned host
    memory without blocking the host; the light batches are checked
    against the kernel's shared-memory table first."""
    light = work.light
    if light.size and int((light[:, 1] - light[:, 0]).max()) > FUSED_LIGHT_CAP:
        raise ValueError("fused_count_tiles: a light batch is wider than "
                         f"{FUSED_LIGHT_CAP} wedges")
    pinned = torch.from_numpy(work.table).pin_memory()
    return work._replace(device=pinned.to(dev, non_blocking=True))


def fused_count_tiles(
    tile_bounds: np.ndarray,
    offsets: torch.Tensor,
    neighbors: torch.Tensor,
    edge_src: torch.Tensor,
    undirected_id: torch.Tensor,
    w_off: torch.Tensor,
    *,
    n_pad: int,
    m: int,
    direction: str,
    mode: str,
    work: "FusedWork | None" = None,
):
    """Exact int64 ``(total (), vertex (n_pad,), edge (m,))`` over the
    host tile bounds. ``work`` is :func:`fused_work` of the same tiles
    and graph, best already on the card (:func:`upload_work`); without
    it the wrapper plans from host copies of ``offsets`` and ``w_off``
    (a device-to-host fetch). The call only enqueues: nothing is read
    back."""
    lib = build()
    dev = neighbors.device
    e_pad = int(neighbors.shape[0])
    _require(offsets, "offsets", torch.int32, dev, (n_pad + 1,))
    _require(neighbors, "neighbors", torch.int32, dev)
    _require(edge_src, "edge_src", torch.int32, dev, (e_pad,))
    _require(undirected_id, "undirected_id", torch.int32, dev, (e_pad,))
    _require(w_off, "w_off", torch.int64, dev, (e_pad + 1,))
    if work is None:
        work = fused_work(tile_bounds, offsets.cpu().numpy(),
                          w_off.cpu().numpy(),
                          torch.cuda.get_device_properties(dev)
                          .multi_processor_count)
    if work.device is None or work.device.device != dev:
        work = upload_work(work, dev)
    # one zeroed buffer: vertex, edge (from an even entry, so 16-byte
    # aligned), then total
    at_edge = n_pad + (n_pad & 1)
    out = torch.zeros(at_edge + m + 1, dtype=torch.int64, device=dev)
    vertex, edge, total = out[:n_pad], out[at_edge:at_edge + m], out[-1]
    n_light = work.light.shape[0]
    n_rounds = work.rounds.shape[0] - 1
    if not n_light and not n_rounds:
        return total, vertex, edge
    heavy_at = work.device.data_ptr() + 8 * work.light.size
    rounds_at = heavy_at + 8 * work.heavy.size
    counters = torch.zeros(max(work.in_flight * n_pad, 1), dtype=torch.int64,
                           device=dev)
    _launch(lib, "fused_count_tiles", dev,
            _ptr(offsets), _ptr(neighbors), _ptr(edge_src),
            _ptr(undirected_id), _ptr(w_off), e_pad, int(n_pad),
            int(direction == "high"), int(mode in ("global", "all")),
            int(mode in ("vertex", "all")), int(mode in ("edge", "all")),
            FUSED_LIGHT_SLOTS, _ptr(work.device), n_light, heavy_at,
            rounds_at, n_rounds, _ptr(counters),
            _ptr(total), _ptr(vertex), _ptr(edge))
    return total, vertex, edge


_COUNT_DTYPES = (torch.int32, torch.int64)


def _counts(counts: torch.Tensor, name: str) -> torch.Tensor:
    counts = counts.reshape(-1)
    if counts.dtype not in _COUNT_DTYPES:
        raise ValueError(f"{name}: counts must be int32 or int64, got "
                         f"{counts.dtype}")
    if not counts.is_contiguous():
        raise ValueError(f"{name}: counts must be contiguous")
    return counts


_min_scratch: dict = {}


def _bucket_min_scratch(dev: torch.device) -> torch.Tensor:
    """Per-device scratch of ``bucket_min``: one int32 partial minimum
    per block (at most one block per SM) and the last-block ticket,
    zeroed once; the kernel leaves the ticket at 0 after every call."""
    buf = _min_scratch.get(dev.index)
    if buf is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        buf = torch.zeros(sms + 1, dtype=torch.int32, device=dev)
        _min_scratch[dev.index] = buf
    return buf


def bucket_min(counts: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """() int32 masked min of int32/int64 ``counts`` (clamped to
    INT32_MAX) over ``alive``; INT32_MAX when nothing is alive. One
    launch, which writes the output itself."""
    lib = build()
    dev = counts.device
    counts = _counts(counts, "bucket_min")
    alive = _mask(alive)
    _require(alive, "alive", torch.bool, dev, counts.shape)
    scratch = _bucket_min_scratch(dev)
    out = torch.empty((), dtype=torch.int32, device=dev)
    _launch(lib, "bucket_min", dev, _ptr(counts),
            int(counts.dtype == torch.int64), _ptr(alive), counts.numel(),
            _ptr(scratch), scratch.shape[0] - 1, _ptr(out))
    return out


def bucket_update(counts: torch.Tensor, alive: torch.Tensor,
                  idx: torch.Tensor, dec: torch.Tensor):
    """``(new_counts, min, hist)``: ``counts - scatter_add(idx, dec)``
    in the counts dtype (int32 or int64), its () int32 masked min and
    its (32,) int32 bit-length occupancy over ``alive``, from one
    cooperative launch that seeds its own outputs. ``idx`` is cast to
    int64 and ``dec`` to the counts dtype when they differ."""
    lib = build()
    dev = counts.device
    counts = _counts(counts, "bucket_update")
    alive = _mask(alive)
    _require(alive, "alive", torch.bool, dev, counts.shape)
    idx = idx.reshape(-1).to(torch.int64).contiguous()
    dec = dec.reshape(-1).to(counts.dtype).contiguous()
    _require(idx, "idx", torch.int64, dev)
    _require(dec, "dec", counts.dtype, dev, idx.shape)
    new = torch.empty_like(counts)
    out = torch.empty(33, dtype=torch.int32, device=dev)  # min, then 32 bins
    _launch(lib, "bucket_update", dev, _ptr(counts),
            int(counts.dtype == torch.int64), _ptr(alive), counts.numel(),
            _ptr(idx), _ptr(dec), idx.numel(), _ptr(new), _ptr(out))
    return new, out[0], out[1:]
