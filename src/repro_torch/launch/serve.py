"""Serving launcher CLI of the port (counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llsc-100m \
        --requests 16 --slots 4 --flags flash_kernel

Runs on the card by default; ``--device cpu`` runs on the CPU and then
needs ``--peak-flops`` and ``--mem-total-gb`` for the LLload figures.  The
engine publishes per-step duty cycle into the LLload job registry; at the
end the launcher prints the registry's view of the job and the overload
controller's NPPN verdict.  Exit codes: 0 done, 1 environment (no card,
kernel build failed), 2 usage.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import model as model_lib
from repro_torch.models.perf_flags import PerfFlags, perf_flags
from repro_torch.monitor import JobRegistry
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llsc-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--flags", default="",
                    help="comma-separated PerfFlags, e.g. flash_kernel")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="device peak FLOP/s (default on a card: H100 bf16)")
    ap.add_argument("--mem-total-gb", type=float, default=None,
                    help="device memory in GB (default on a card: read)")
    args = ap.parse_args(argv)

    try:
        flags = PerfFlags.parse(args.flags)
        cfg = get_config(args.arch)
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.device == "cpu" and (args.peak_flops is None
                                 or args.mem_total_gb is None):
        print("error: --device cpu needs --peak-flops and --mem-total-gb",
              file=sys.stderr)
        return 2
    ecfg = EngineConfig(slots=args.slots, max_seq_len=args.max_seq,
                        job_name=f"serve:{cfg.name}", device=args.device,
                        peak_flops=args.peak_flops,
                        mem_total_gb=args.mem_total_gb)
    try:
        params = model_lib.init_params(
            cfg, torch.Generator().manual_seed(args.seed), device=args.device)
        eng = ServeEngine(cfg, params, ecfg)
        rng = np.random.default_rng(args.seed)
        for i in range(args.requests):
            eng.submit(Request(i, rng.integers(0, cfg.vocab_size,
                                               args.prompt_len).astype(np.int32),
                               max_new_tokens=args.max_new))
        with perf_flags(flags):
            stats = eng.run()
    except RuntimeError as e:      # no card, or a kernel failed to build
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"[serve:{cfg.name}] {stats['requests']} requests, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.2f}s "
          f"({stats['tokens_per_s']:.1f} tok/s, {stats['steps']} steps) "
          f"on {args.device}")
    agg = JobRegistry.global_registry().aggregate()
    print(f"LLload view: duty={agg.duty_cycle:.6f} "
          f"step={agg.step_time_s * 1e3:.1f}ms "
          f"mem={agg.hbm_used_gb:.3f}/{agg.hbm_total_gb:.1f}GB")
    d = stats["decision"]
    print(f"Overload controller: slots {args.slots} -> {d.nppn} ({d.reason})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
