"""The port's dry-run count of one cell, op by op: the FLOPs a device of
each (op, input shapes) that ``repro_torch.launch.dryrun``'s
``CostCounter`` counts, largest first.  The port's side of
``reference_dots.py``; the two together show which products part them.

    PYTHONPATH=src python dryrun_tally.py granite-moe-1b-a400m decode_32k
    PYTHONPATH=src python dryrun_tally.py ARCH SHAPE --top 20 --multi-pod

CPU only (meta tensors over a fake process group, as the dry-run runs).
The last line is one JSON object: the cell's total and every entry.
"""
import argparse
import collections
import json

import torch

from repro_torch.launch import dryrun


def tally(arch: str, shape: str, multi_pod: bool = False):
    """(the cell's FLOPs a device, {(op, input shapes): FLOPs})."""
    ops = collections.Counter()
    counted = dryrun.CostCounter.__torch_dispatch__

    def dispatch(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = counted(self, func, types, args, kwargs)
        if self.flops != before:
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            ops[(func.__name__, shapes)] += self.flops - before
        return out

    dryrun.CostCounter.__torch_dispatch__ = dispatch
    try:
        res = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                              verbose=False)
    finally:
        dryrun.CostCounter.__torch_dispatch__ = counted
    return res["flops_per_device"], dict(ops)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    total, ops = tally(args.arch, args.shape, args.multi_pod)
    print(f"{args.arch} {args.shape}: {total:.4e} FLOPs a device")
    ranked = sorted(ops.items(), key=lambda kv: -kv[1])
    for (name, shapes), flops in ranked[:args.top]:
        print(f"  {flops:.4e}  {flops / total:7.2%}  {name} {list(shapes)}")
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "flops_per_device": total,
                      "ops": [[name, [list(s) for s in shapes], flops]
                              for (name, shapes), flops in ranked]}))


if __name__ == "__main__":
    main()
