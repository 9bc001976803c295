"""Render the roofline table from dry-run JSONs (counterpart of
``repro.roofline.report``): the port's dry-run writes the same keys, so the
tables and their strings are the reference's."""
from __future__ import annotations

import glob
import json
import os
from typing import List, Optional


def load_cells(out_dir: str) -> List[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def _fmt_b(x: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}B"


def markdown_table(cells: List[dict], *, multi_pod: Optional[bool] = None
                   ) -> str:
    rows = [c for c in cells if c.get("status") == "ok"
            and (multi_pod is None or c.get("multi_pod") == multi_pod)]
    rows.sort(key=lambda c: (c["arch"], c["shape"], c["multi_pod"]))
    lines = [
        "| arch | shape | mesh | compute | memory | collective | dominant "
        "| 6ND/HLO | HLO FLOPs/dev | HBM B/dev | coll B/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in rows:
        mesh = "2x16x16" if c["multi_pod"] else "16x16"
        lines.append(
            f"| {c['arch']} | {c['shape']} | {mesh} "
            f"| {_fmt_s(c['compute_s'])} | {_fmt_s(c['memory_s'])} "
            f"| {_fmt_s(c['collective_s'])} | **{c['dominant']}** "
            f"| {c['useful_flops_ratio']:.2f} "
            f"| {c['flops_per_device']:.2e} "
            f"| {_fmt_b(c['hbm_bytes_per_device'])} "
            f"| {_fmt_b(c['collective_bytes_per_device'])} |")
    return "\n".join(lines)


def skipped_table(cells: List[dict]) -> str:
    rows = [c for c in cells if c.get("status") == "skipped"]
    seen = set()
    lines = ["| arch | shape | reason |", "|---|---|---|"]
    for c in rows:
        key = (c["arch"], c["shape"])
        if key in seen:
            continue
        seen.add(key)
        lines.append(f"| {c['arch']} | {c['shape']} | {c['reason']} |")
    return "\n".join(lines)


def memory_table(cells: List[dict]) -> str:
    rows = [c for c in cells if c.get("status") == "ok"]
    rows.sort(key=lambda c: (c["arch"], c["shape"], c["multi_pod"]))
    lines = [
        "| arch | shape | mesh | args/dev | temps/dev | output/dev "
        "| compile | probe |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in rows:
        mesh = "2x16x16" if c["multi_pod"] else "16x16"
        m = c.get("memory_analysis", {})
        lines.append(
            f"| {c['arch']} | {c['shape']} | {mesh} "
            f"| {_fmt_b(m.get('argument_size_in_bytes') or 0)} "
            f"| {_fmt_b(m.get('temp_size_in_bytes') or 0)} "
            f"| {_fmt_b(m.get('output_size_in_bytes') or 0)} "
            f"| {c.get('compile_s', 0):.0f}s | {c.get('probe_s', 0):.0f}s |")
    return "\n".join(lines)


def summarize(out_dir: str = "build/dryrun") -> str:
    cells = load_cells(out_dir)
    ok = sum(1 for c in cells if c.get("status") == "ok")
    sk = sum(1 for c in cells if c.get("status") == "skipped")
    er = [c for c in cells if c.get("status") == "error"]
    parts = [f"cells: {ok} ok, {sk} skipped, {len(er)} error"]
    for c in er:
        parts.append(f"  ERROR {c['arch']} x {c['shape']} "
                     f"(mp={c['multi_pod']}): {c.get('error')}")
    return "\n".join(parts)


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun"
    print(summarize(out))
    print()
    print(markdown_table(load_cells(out), multi_pod=False))
