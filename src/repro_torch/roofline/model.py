"""Roofline terms from dry-run artifacts, at the H100's rates.

The port's counterpart of the reference's ``repro.roofline.model``, over
the same dry-run record format. The reference charges a TPU v5e chip;
this module charges one NVIDIA H100 SXM5 card, at the published figures
of NVIDIA's Hopper architecture white paper (rates a card can reach, not
measurements):

  PEAK_FLOPS = 989.4e12  dense BF16 tensor-core FLOP/s
  HBM_BW     = 3.35e12   B/s of HBM3
  NVLINK_BW  = 450e9     B/s per direction per GPU over NVLink 4 (18
                         links); every collective wire byte is charged
                         against it, as the reference charges all of
                         them against one ICI link
  INT32_OPS  = 64 * 132 * 1.98e9  int32 operations/s (64 INT32 lanes
                         per SM x 132 SMs x the 1.98 GHz boost clock)

The butterfly branch (``_butterfly_roofline``) divides its operation
count by ``INT32_OPS``: the graph engine's work is integer gathers,
sorts, scans and atomics that no tensor core runs. The LM branch keeps
``PEAK_FLOPS``, the rate of the bf16 matrix products that dominate it.
``chip_smoke.py`` reads ``HBM_BW`` and ``INT32_OPS`` for its kernels'
bounds.

Trip-count correction: XLA cost_analysis counts scan bodies once, so
per-cell totals are reconstructed from depth-1/depth-2 *unrolled*
lowerings:

    total(L) = c(d1) + (G - 1) · (c(d2) - c(d1)),   G = L / L_d1

which is exact for homogeneous stacks (dense/moe/ssm/vlm/audio) and a
group-level fit for the zamba2 hybrid (one shared-attn application per
``attn_every`` mamba layers = one group). All quantities are per-device
post-SPMD.

MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active params.
The "useful fraction" MODEL_FLOPS / HLO_FLOPS exposes remat/dispatch
waste; the roofline fraction is useful-compute-time / max(term).

Roofline rows are those of the TPU dry-run format: single-pod records of
the ``16x16`` mesh, 256 devices.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

import numpy as np

from ..configs import SHAPE_CELLS, get_config

PEAK_FLOPS = 989.4e12  # H100 SXM5 dense BF16, Hopper white paper
HBM_BW = 3.35e12  # H100 SXM5 HBM3, Hopper white paper
NVLINK_BW = 450e9  # NVLink 4, per direction per GPU, Hopper white paper
INT32_OPS = 64 * 132 * 1.98e9  # INT32 lanes x SMs x boost clock, same

__all__ = ["cell_roofline", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "INT32_OPS"]


def _extrapolate(rec: Dict[str, Any], key_path) -> Optional[float]:
    def get(d, *ks):
        for k in ks:
            if d is None:
                return None
            d = d.get(k)
        return d

    d1 = get(rec, "depth1", *key_path)
    d2 = get(rec, "depth2", *key_path)
    if d1 is None or d2 is None:
        return None
    cfg = get_config(rec["arch"])
    l_d1 = rec["depth1"].get("n_layers", 1)
    groups = cfg.n_layers / max(l_d1, 1)
    return float(d1) + (groups - 1.0) * (float(d2) - float(d1))


def _model_flops_per_device(rec: Dict[str, Any], n_chips: int) -> float:
    cfg = get_config(rec["arch"])
    n_active = cfg.active_param_count()
    cell_kind = rec.get("kind", "train")
    # tokens processed per step (global)
    cell = next(c for c in SHAPE_CELLS if c.name == rec["cell"])
    if cell_kind == "train":
        tokens = cell.global_batch * cell.seq_len
        per_tok = 6 * n_active
    elif cell_kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        per_tok = 2 * n_active
    else:  # decode: one token per sequence
        tokens = cell.global_batch
        per_tok = 2 * n_active
    return per_tok * tokens / n_chips


def _leaves(tree, is_leaf) -> list:
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t, is_leaf)]
    return [] if tree is None else [tree]


def _useful_bytes_per_device(rec: Dict[str, Any], n_chips: int) -> float:
    """Decode steps are memory-bound by construction: the minimal HBM
    traffic is (params touched + KV/state cache read+written) once.

    The cache sizes come from the LM model definitions'
    ``decode_state_specs``, which live in ``contrib/models/`` outside
    both packages, so a decode record raises ``ModuleNotFoundError``
    here as it does in the reference."""
    cfg = get_config(rec["arch"])
    package = __package__.rsplit(".", 1)[0]
    try:
        models = importlib.import_module(f"{package}.models.model")
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            f"decode rooflines need {package}.models.model "
            "(decode_state_specs), the LM model definitions that live in "
            "contrib/models/ and are not importable from the installed "
            "package (see contrib/README.md)",
            name=f"{package}.models",
        ) from e

    cell = next(c for c in SHAPE_CELLS if c.name == rec["cell"])
    param_bytes = cfg.param_count() * 2  # bf16 weights resident
    state = models.decode_state_specs(cfg, cell.global_batch, cell.seq_len)
    cache_bytes = 0
    for shape, dtype in _leaves(state, models._is_spec_leaf):
        n = int(np.prod(shape)) if shape else 1
        try:
            isz = np.dtype(dtype).itemsize
        except TypeError:
            isz = 2  # bfloat16
        cache_bytes += n * isz
    return (param_bytes + cache_bytes) / n_chips


def _butterfly_roofline(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The graph engine has no layer scan — the compiled program IS the
    whole step, so no extrapolation is needed. Useful work = one pass
    over the per-device wedge slice (integer ops run on no tensor core,
    so the compute term is charged at ``INT32_OPS``; the engine is
    memory/sort-bound by construction, like all graph analytics — the
    interesting number is the collective share)."""
    full = rec["full"]
    flops = full["cost"]["flops"]
    byts = full["cost"]["bytes_accessed"]
    wire = full["collectives"]["wire_bytes"]
    t_comp = flops / INT32_OPS
    t_mem = byts / HBM_BW
    t_coll = wire / NVLINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    # useful bytes: each wedge materialization reads ~4 int32 gathers +
    # sort traffic lower bound of one read+write of the slice
    w_cap = 2_097_152
    useful_bytes = w_cap * 4 * 6
    t_useful = useful_bytes / HBM_BW
    return {
        "arch": rec["arch"],
        "cell": rec["cell"],
        "mesh": rec["mesh"],
        "kind": rec.get("kind"),
        "basis": "whole-program (no scan)",
        "flops_dev": flops,
        "bytes_dev": byts,
        "wire_dev": wire,
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": max(terms, key=terms.get),
        "model_flops_dev": 0.0,
        "useful_flops_frac": useful_bytes / byts if byts else 0.0,
        "roofline_frac": t_useful / max(terms.values())
        if max(terms.values()) > 0
        else 0.0,
        "temp_gib": full["memory"]["temp_bytes"] / 2**30,
        "args_gib": full["memory"]["argument_bytes"] / 2**30,
    }


def cell_roofline(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Compute the three terms + bottleneck for one dry-run record.

    Roofline rows are single-pod only (the multi-pod pass proves the pod
    axis shards; it carries no depth extrapolation)."""
    if not rec.get("ok") or rec.get("skipped"):
        return None
    if rec["mesh"] != "16x16":
        return None
    if rec["arch"].startswith("parbutterfly"):
        return _butterfly_roofline(rec)
    n_chips = 256
    flops = _extrapolate(rec, ("cost", "flops"))
    byts = _extrapolate(rec, ("cost", "bytes_accessed"))
    wire = _extrapolate(rec, ("collectives", "wire_bytes"))
    basis = "depth-extrapolated"
    if flops is None:
        # fall back to the (undercounted) scanned full program
        flops = rec["full"]["cost"]["flops"]
        byts = rec["full"]["cost"]["bytes_accessed"]
        wire = rec["full"]["collectives"]["wire_bytes"]
        basis = "scan-body-only (UNDERCOUNT)"
    t_comp = flops / PEAK_FLOPS
    t_mem = byts / HBM_BW
    t_coll = wire / NVLINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = _model_flops_per_device(rec, n_chips)
    useful = mf / flops if flops else 0.0
    if rec.get("kind") == "decode":
        # memory-roofline reference for decode
        ub = _useful_bytes_per_device(rec, n_chips)
        t_useful = ub / HBM_BW
        useful = ub / byts if byts else 0.0
    else:
        t_useful = mf / PEAK_FLOPS
    frac = t_useful / max(terms.values()) if max(terms.values()) > 0 else 0.0
    return {
        "arch": rec["arch"],
        "cell": rec["cell"],
        "mesh": rec["mesh"],
        "kind": rec.get("kind"),
        "basis": basis,
        "flops_dev": flops,
        "bytes_dev": byts,
        "wire_dev": wire,
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_dev": mf,
        "useful_flops_frac": useful,
        "roofline_frac": frac,
        "temp_gib": rec["full"]["memory"]["temp_bytes"] / 2**30,
        "args_gib": rec["full"]["memory"]["argument_bytes"] / 2**30,
    }
