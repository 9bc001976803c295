"""Device overloading (the NPPN mechanism) measured: decode throughput of
the port's ``ServeEngine`` at 1, 2, 4 and 8 concurrent streams, beside the
analytic packing model (the measured view of
``examples/overloading_throughput.py``; its campaign view runs the JAX
package's experiment harness, which the port does not have).

    PYTHONPATH=src python -m repro_torch.examples.overloading_throughput
    PYTHONPATH=src python -m repro_torch.examples.overloading_throughput \
        --device cpu --reduced

Runs llsc-100m on the card by default; ``--device cpu`` runs on the CPU.
Each slot count serves 16 requests of 8-token prompts and 8 new tokens.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.overload import packed_throughput_model
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

# the per-task duty the packing model assumes, as the reference's view
PER_TASK_DUTY = 0.35


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config("llsc-100m")
    if args.reduced:
        cfg = reduced_config(cfg)
    try:
        params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                       device=args.device)
    except RuntimeError as e:       # no card
        print(f"error: {e}", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    base = None
    print(f"{'streams':>8} {'tok/s':>9} {'speedup':>8}   model-predicted "
          f"({cfg.name} on {args.device})")
    for slots in (1, 2, 4, 8):
        eng = ServeEngine(cfg, params, EngineConfig(
            slots=slots, max_seq_len=64, monitor=False, device=args.device))
        for i in range(16):
            eng.submit(Request(i, rng.integers(0, cfg.vocab_size, 8)
                               .astype(np.int32), max_new_tokens=8))
        tps = eng.run()["tokens_per_s"]
        base = base or tps
        pred = (packed_throughput_model(PER_TASK_DUTY, slots)
                / packed_throughput_model(PER_TASK_DUTY, 1))
        print(f"{slots:>8} {tps:>9.1f} {tps / base:>8.2f}   {pred:.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
