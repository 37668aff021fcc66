"""Render the roofline table from dry-run artifacts, at the H100's rates
(``repro_torch.roofline.model``).

Usage: python -m repro_torch.roofline.report [--dir experiments/dryrun]
       [--csv out.csv] [--md out.md]

The columns and number formats are the reference's
(``repro.roofline.report``); the advice speaks of the card: tensor
cores where the reference says MXU, NVLink where it says ICI.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

from .model import cell_roofline


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _advice(row) -> str:
    d = row["dominant"]
    if d == "compute":
        if row["useful_flops_frac"] < 0.5:
            return "compute-bound but <50% useful: cut remat recompute / dispatch overhead"
        return "compute-bound: fuse/better tensor-core utilization; already near structural roofline"
    if d == "memory":
        return "HBM-bound: increase arithmetic intensity (fuse, bigger tiles, cache layout)"
    return "NVLink-bound: reshard to cut collective payload or overlap collectives with compute"


def load_rows(d: str) -> List[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("skipped"):
            rows.append(
                {"arch": rec["arch"], "cell": rec["cell"], "mesh": rec["mesh"],
                 "skipped": rec["skipped"]}
            )
            continue
        r = cell_roofline(rec)
        if r:
            r["advice"] = _advice(r)
            rows.append(r)
        elif rec.get("ok") is False:
            rows.append({"arch": rec["arch"], "cell": rec["cell"],
                         "mesh": rec["mesh"], "error": rec.get("error")})
    return rows


def to_markdown(rows: List[dict]) -> str:
    hdr = ("| arch | cell | mesh | compute | memory | collective | "
           "dominant | useful/HLO | roofline frac | per-dev temp |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = [hdr]
    for r in rows:
        if "skipped" in r:
            lines.append(
                f"| {r['arch']} | {r['cell']} | {r['mesh']} | — | — | — | "
                f"skipped: {r['skipped']} | — | — | — |\n"
            )
            continue
        if "error" in r:
            lines.append(
                f"| {r['arch']} | {r['cell']} | {r['mesh']} | — | — | — | "
                f"ERROR | — | — | — |\n"
            )
            continue
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} | "
            f"{_fmt_s(r['t_compute_s'])} | {_fmt_s(r['t_memory_s'])} | "
            f"{_fmt_s(r['t_collective_s'])} | {r['dominant']} | "
            f"{r['useful_flops_frac']*100:.0f}% | "
            f"{r['roofline_frac']*100:.1f}% | {r['temp_gib']:.1f} GiB |\n"
        )
    return "".join(lines)


def to_csv(rows: List[dict]) -> str:
    cols = ["arch", "cell", "mesh", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "useful_flops_frac",
            "roofline_frac", "temp_gib", "flops_dev", "bytes_dev",
            "wire_dev", "model_flops_dev", "basis"]
    out = [",".join(cols)]
    for r in rows:
        if "skipped" in r or "error" in r:
            continue
        out.append(",".join(str(r.get(c, "")) for c in cols))
    return "\n".join(out) + "\n"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--csv", default="experiments/roofline.csv")
    ap.add_argument("--md", default="experiments/roofline.md")
    args = ap.parse_args()
    rows = load_rows(args.dir)
    md = to_markdown(rows)
    print(md)
    if args.md:
        os.makedirs(os.path.dirname(args.md) or ".", exist_ok=True)
        with open(args.md, "w") as f:
            f.write(md)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(to_csv(rows))
    # advice lines (one sentence per cell, per the brief)
    for r in rows:
        if "advice" in r:
            print(f"{r['arch']}/{r['cell']}/{r['mesh']}: {r['advice']}")


if __name__ == "__main__":
    main()
