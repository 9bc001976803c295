"""The products in the reference's dry-run count of one cell: the FLOPs of
the dots in the programs that ``repro.launch.dryrun.probe_costs`` compiles
(one and two periods, unrolled), per device of the single-pod 16 x 16 mesh,
beside XLA's whole ``cost_analysis`` count of the same programs.

The port's dry-run counts products only (torch's FLOP formulas), XLA's
count takes in elementwise work too; this splits the reference's count so
that the two can be held side by side.  A dot counts 2 x its output's
elements x its contracted size; "attention" is every dot with an operand
or output as long as the cell's sequence.  Both sums, and XLA's totals,
are carried to the full depth as ``probe_costs`` carries its totals:
c(P) = c(1) + (P - 1) * (c(2) - c(1)).

Runs the JAX package on this host's CPU, over 256 host devices (the mesh
is built with automatic axes, as ``tests/test_torch_dryrun.py`` builds
its reference's).  Compiles only; nothing is allocated at the cell's size.

    PYTHONPATH=src python reference_dots.py granite-moe-1b-a400m decode_32k
    PYTHONPATH=src python reference_dots.py ARCH SHAPE --dots   # each dot

The last line is one JSON object of the figures.
"""
import argparse
import json
import math
import re

from repro.launch import dryrun  # first: it sets the host device count

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import SHAPES, get_config  # noqa: E402

DEF = re.compile(r"^\s*(?:ROOT )?(%\S+) = (\S+?)(?:\{[^}]*\})? "
                 r"(\w[\w-]*)\((.*)$")


def _dims(shape: str) -> list:
    m = re.search(r"\[([^\]]*)\]", shape)
    return [int(x) for x in m.group(1).split(",") if x]


def dot_flops(hlo: str, seq_len: int, show: bool = False) -> tuple:
    """(attention, other) FLOPs of the dots in the HLO text ``hlo``."""
    shapes, dots = {}, []
    for line in hlo.splitlines():
        m = DEF.match(line)
        if m:
            shapes[m.group(1)] = m.group(2)
            if m.group(3) == "dot":
                dots.append((m, line))
    att = other = 0
    for m, line in dots:
        ops = re.findall(r"%[\w.\-]+", m.group(4).split(")")[0])[:2]
        lhs = _dims(shapes[ops[0]])
        con = re.search(r"lhs_contracting_dims=\{([^}]*)\}", line).group(1)
        flops = 2 * math.prod(_dims(m.group(2))) * math.prod(
            lhs[int(i)] for i in con.split(",") if i)
        seq = any(seq_len in _dims(s)
                  for s in (m.group(2), *(shapes[o] for o in ops)))
        if seq:
            att += flops
        else:
            other += flops
        if show:
            print(f"  {'attention' if seq else 'other':9s} {m.group(2)} <- "
                  f"{[shapes[o] for o in ops]} contracting {con}: {flops}")
    return att, other


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--dots", action="store_true",
                    help="print each dot's per-device shapes")
    args = ap.parse_args(argv)
    cfg, shape = get_config(args.arch), SHAPES[args.shape]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:256]).reshape(16, 16),
                             ("data", "model"))
    per_depth = {}
    for depth in (1, 2):
        compiled = dryrun._compile_cell(dryrun._reduced_depth(cfg, depth),
                                        shape, mesh, unroll=True)
        if args.dots:
            print(f"{depth} period(s):")
        att, other = dot_flops(compiled.as_text(), shape.seq_len, args.dots)
        xla = dryrun._extract_cost(compiled)["flops"]
        per_depth[depth] = (att, other, xla)
        print(f"{depth} period(s): attention dots {att:.6e}, other dots "
              f"{other:.6e}, XLA's count {xla:.6e}")
    P = cfg.n_periods
    full = [a + (P - 1) * (b - a) for a, b in zip(per_depth[1], per_depth[2])]
    out = {"arch": args.arch, "shape": args.shape, "periods": P,
           "attention_dots": full[0], "other_dots": full[1],
           "dots": full[0] + full[1], "xla_flops": full[2],
           "non_dot_share": 1 - (full[0] + full[1]) / full[2],
           "non_dot_1_period": per_depth[1][2] - sum(per_depth[1][:2]),
           "non_dot_2_periods": per_depth[2][2] - sum(per_depth[2][:2])}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
