#!/usr/bin/env python3
"""The port's dry-run cells beside the JAX package's, per device.

    PYTHONPATH=src python tools/dryrun_vs_reference.py build/dryrun \\
        --out build/dryrun_ref --timeout 300 --jobs 2

For every ``ok`` cell JSON that ``python -m repro_torch.launch.dryrun``
wrote under the first directory, runs the reference's
``repro.launch.dryrun.run_cell`` for the same arch, shape and mesh in a
subprocess of its own (512 host devices, its production mesh with Auto
axes; killed after ``--timeout`` seconds; ``--single-pod`` for the
single-pod cells only), keeps its result under ``--out`` (a cell already
there is not run again), and prints a markdown table of the port's
counting seconds of every cell, then one of both sides' FLOPs, bytes
and collective bytes per device with their ratios, and the cells the
reference did not finish.  Both sides are counts, not measurements.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# The reference's production mesh with Auto axes: jax 0.9's make_mesh
# makes Explicit ones, on which the reference's with_sharding_constraint
# hints raise (every prefill and train cell).
REFERENCE = r"""
import json, sys
import jax
from repro.launch import dryrun


def make_production_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


dryrun.make_production_mesh = make_production_mesh
arch, shape, mp, out = sys.argv[1:5]
res = dryrun.run_cell(arch, shape, multi_pod=mp == "1", verbose=False)
with open(out, "w") as f:
    json.dump(res, f, indent=2, default=str)
"""


def _tag(cell: dict) -> str:
    return (f"{cell['arch']}__{cell['shape']}__"
            f"{'mp' if cell['multi_pod'] else 'sp'}")


def run_reference(cell: dict, out_dir: str, timeout: float):
    """The reference's result for ``cell``; where it did not finish
    within ``timeout`` seconds or failed, a dict with ``status`` "timeout"
    or "error" (and the error's last line), which is not kept."""
    path = os.path.join(out_dir, _tag(cell) + ".json")
    if not os.path.exists(path):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        try:
            subprocess.run(
                [sys.executable, "-c", REFERENCE, cell["arch"], cell["shape"],
                 "1" if cell["multi_pod"] else "0", path],
                env=env, timeout=timeout, capture_output=True, text=True,
                check=True)
        except subprocess.TimeoutExpired:
            return {"status": "timeout"}
        except subprocess.CalledProcessError as e:
            lines = e.stderr.strip().splitlines()
            return {"status": "error", "error": lines[-1] if lines else ""}
    with open(path) as f:
        return json.load(f)


def _ratio(a: float, b: float) -> str:
    return f"{a / b:.3f}" if b else "-"


def table(pairs) -> str:
    lines = ["| arch | shape | mesh | FLOPs/dev port | reference | ratio "
             "| bytes/dev port | reference | ratio | coll B/dev port "
             "| reference | port s |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for port, ref in pairs:
        mesh = "2x16x16" if port["multi_pod"] else "16x16"
        row = f"| {port['arch']} | {port['shape']} | {mesh} "
        for key in ("flops_per_device", "hbm_bytes_per_device"):
            row += (f"| {port[key]:.4e} | {ref[key]:.4e} "
                    f"| {_ratio(port[key], ref[key])} ")
        key = "collective_bytes_per_device"
        lines.append(row + f"| {port[key]:.4e} | {ref[key]:.4e} "
                     f"| {port['probe_s']} |")
    return "\n".join(lines)


def seconds_table(cells) -> str:
    """The port's counting seconds of each cell: an arch a row, a shape
    and mesh a column."""
    shapes = sorted({c["shape"] for c in cells})
    cols = [(s, mp) for s in shapes for mp in (False, True)]
    lines = ["| arch | " + " | ".join(
        f"{s} {'2x16x16' if mp else '16x16'}" for s, mp in cols) + " |",
        "|---|" + "---|" * len(cols)]
    got = {(c["arch"], c["shape"], c["multi_pod"]): c["probe_s"]
           for c in cells}
    for arch in sorted({c["arch"] for c in cells}):
        lines.append(f"| {arch} | " + " | ".join(
            str(got.get((arch, s, mp), "-")) for s, mp in cols) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("port_dir")
    ap.add_argument("--out", default="build/dryrun_ref")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--single-pod", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    for path in sorted(glob.glob(os.path.join(args.port_dir, "*.json"))):
        with open(path) as f:
            cell = json.load(f)
        if cell.get("status") == "ok":
            cells.append(cell)
    print(seconds_table(cells) + "\n")
    if args.single_pod:
        cells = [c for c in cells if not c["multi_pod"]]
    with ThreadPoolExecutor(args.jobs) as pool:
        refs = list(pool.map(lambda c: run_reference(c, args.out,
                                                     args.timeout), cells))
    pairs = [(c, r) for c, r in zip(cells, refs) if r["status"] == "ok"]
    print(table(pairs))
    for status in ("timeout", "error"):
        left = [f"{_tag(c)}{': ' + r['error'] if status == 'error' else ''}"
                for c, r in zip(cells, refs) if r["status"] == status]
        print(f"\nreference {status} (limit {args.timeout:.0f} s): "
              f"{'; '.join(left) if left else 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
