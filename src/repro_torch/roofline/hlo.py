"""Parse collective ops (+ operand bytes + group sizes) out of compiled
HLO text: the port's own copy of the reference's ``repro.roofline.hlo``
(text parsing and ring formulas, no framework), over the same dry-run
record format. A cost analysis does not expose collective traffic, so
the roofline's third term comes from here.

``wire_bytes`` charges each collective the per-device bytes of a ring
algorithm, which is also what NCCL's ring all-reduce, all-gather and
reduce-scatter move on a card: 2 (k-1)/k of the payload for an
all-reduce, (k-1)/k for a gather or a scatter.

Important caveat handled by callers: XLA counts ``while``/scan bodies
ONCE in both cost_analysis and the HLO text — trip-count extrapolation
happens in ``repro_torch.roofline.model`` from depth-1/depth-2 unrolled
lowerings.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

__all__ = ["parse_collectives", "collective_summary", "DTYPE_BYTES"]

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLL_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64|pred|c64|c128)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\][^ ]*))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(",
)
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]*)\}")


def _shape_bytes(text: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(text):
        dt, dims = m.group(1), m.group(2)
        numel = 1
        if dims:
            for d in dims.split(","):
                if d:
                    numel *= int(d)
        total += numel * DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> List[Dict]:
    """One record per collective op: kind, result bytes, group size."""
    out = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue  # count start ops once for async pairs
        shape_txt, kind = m.group(1), m.group(2)
        nbytes = _shape_bytes(shape_txt)
        gsz = None
        gm = _GROUPS_IOTA_RE.search(line)
        if gm:
            gsz = int(gm.group(2))
        else:
            gl = _GROUPS_LIST_RE.search(line)
            if gl:
                ids = [x for x in gl.group(1).split(",") if x.strip()]
                gsz = len(ids)
        out.append({"kind": kind, "bytes": nbytes, "group": gsz})
    return out


def wire_bytes(record: Dict) -> float:
    """Per-device bytes on the wire for one collective, ring algorithms.

    all-reduce:     2 (k-1)/k × payload
    all-gather:     (k-1)/k × result
    reduce-scatter: (k-1)/k × input (~result × k × (k-1)/k; HLO result is
                    the scattered shard, so input ≈ result × k)
    all-to-all:     (k-1)/k × payload
    collective-permute: payload
    """
    k = record["group"] or 2
    b = record["bytes"]
    kind = record["kind"]
    if kind == "all-reduce":
        return 2.0 * (k - 1) / k * b
    if kind == "all-gather":
        return (k - 1) / k * b
    if kind == "reduce-scatter":
        return (k - 1) * b  # input = result × k; (k-1)/k × input
    if kind == "all-to-all":
        return (k - 1) / k * b
    return float(b)


def collective_summary(hlo_text: str) -> Dict:
    recs = parse_collectives(hlo_text)
    by_kind: Dict[str, Dict] = {}
    for r in recs:
        d = by_kind.setdefault(r["kind"], {"count": 0, "bytes": 0, "wire": 0.0})
        d["count"] += 1
        d["bytes"] += r["bytes"]
        d["wire"] += wire_bytes(r)
    total_wire = sum(d["wire"] for d in by_kind.values())
    return {"by_kind": by_kind, "wire_bytes": total_wire, "n_ops": len(recs)}
