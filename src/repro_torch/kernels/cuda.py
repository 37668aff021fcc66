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

import numpy as np
import torch

__all__ = [
    "MAX_TILE_CAP",
    "build",
    "build_info",
    "wedge_histogram",
    "butterfly_combine",
    "fused_count_tiles",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("wedge_histogram.cu", "butterfly_combine.cu", "fused_count_tiles.cu")
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

# Largest tile (in wedges) the fused kernel takes. Its scratch is a hash
# table of the next power of two >= 2 x tile_cap slots (8 B key + 4 B
# count) plus 4 B per wedge: 2^26 wedges need 1.75 GiB, and the slot
# index must stay below 2^31 (its top bit marks the group's
# representative). Above the cap the ladder descends to ``fused``.
MAX_TILE_CAP = 1 << 26

_lock = threading.Lock()
_lib = None
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "bf_wedge_histogram": (_P, _P, _L, _I, _P, _P),
    "bf_butterfly_combine": (_P, _P, _P, _L, _P, _P, _P),
    "bf_fused_count_tiles": (
        _P, _I, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
        _P, _P, _L, _P, _P, _P, _P, _P, _P,
    ),
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
    v = valid.reshape(-1)
    if v.dtype != torch.bool:
        v = v > 0
    return v.contiguous()


def wedge_histogram(keys: torch.Tensor, valid: torch.Tensor,
                    num_buckets: int) -> torch.Tensor:
    """int32 (num_buckets,) histogram of the valid in-range int32 keys."""
    lib = build()
    dev = keys.device
    keys = keys.reshape(-1).to(torch.int32).contiguous()
    valid = _mask(valid)
    _require(valid, "valid", torch.bool, dev, keys.shape)
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.bf_wedge_histogram(
            _ptr(keys), _ptr(valid), keys.numel(), int(num_buckets),
            _ptr(counts), torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, code, "wedge_histogram")
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
    with torch.cuda.device(dev):
        code = lib.bf_butterfly_combine(
            _ptr(d), _ptr(rep), _ptr(valid), d.numel(), _ptr(dm1),
            _ptr(c2), torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, code, "butterfly_combine")
    return dm1, c2


def _batches(tile_bounds: np.ndarray, cap: int) -> np.ndarray:
    """Merge adjacent non-empty tiles into passes of at most ``cap``
    wedges (groups never span a tile, so they never span a pass)."""
    out: list = []
    for ws, we in tile_bounds.tolist():
        if we <= ws:
            continue
        if out and out[-1][1] == ws and we - out[-1][0] <= cap:
            out[-1][1] = we
        else:
            out.append([ws, we])
    return np.ascontiguousarray(np.asarray(out, np.int64).reshape(-1, 2))


def fused_count_tiles(
    tile_bounds: np.ndarray,
    offsets: torch.Tensor,
    neighbors: torch.Tensor,
    edge_src: torch.Tensor,
    undirected_id: torch.Tensor,
    w_off: torch.Tensor,
    *,
    tile_cap: int,
    n_pad: int,
    m: int,
    direction: str,
    mode: str,
):
    """Exact int64 ``(total (), vertex (n_pad,), edge (m,))`` over the
    host tile bounds; tiles must hold at most ``tile_cap`` wedges."""
    lib = build()
    dev = neighbors.device
    e_pad = int(neighbors.shape[0])
    _require(offsets, "offsets", torch.int32, dev, (n_pad + 1,))
    _require(neighbors, "neighbors", torch.int32, dev)
    _require(edge_src, "edge_src", torch.int32, dev, (e_pad,))
    _require(undirected_id, "undirected_id", torch.int32, dev, (e_pad,))
    _require(w_off, "w_off", torch.int64, dev, (e_pad + 1,))
    cap = max(int(tile_cap), 1)
    slots = 1 << (2 * cap - 1).bit_length()  # power of two >= 2 * cap
    batches = _batches(tile_bounds, cap)
    table_keys = torch.full((slots,), -1, dtype=torch.int64, device=dev)
    table_counts = torch.zeros(slots, dtype=torch.int32, device=dev)
    slot_of = torch.empty(cap, dtype=torch.int32, device=dev)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    vertex = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    edge = torch.zeros(m, dtype=torch.int64, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.bf_fused_count_tiles(
            batches.ctypes.data_as(ctypes.c_void_p), batches.shape[0],
            _ptr(offsets), _ptr(neighbors), _ptr(edge_src),
            _ptr(undirected_id), _ptr(w_off), e_pad, int(n_pad),
            int(direction == "high"), int(mode in ("global", "all")),
            int(mode in ("vertex", "all")), int(mode in ("edge", "all")),
            _ptr(table_keys), _ptr(table_counts), slots, _ptr(slot_of),
            _ptr(total), _ptr(vertex), _ptr(edge), _ptr(overflow),
            torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, code, "fused_count_tiles")
    if int(overflow) != 0:
        raise RuntimeError(
            "fused_count_tiles: a hash probe walked the whole table; the "
            "scratch was sized below 2 x the largest pass"
        )
    return total[0], vertex, edge
