"""Training launcher CLI of the port (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llsc-100m \
        --steps 20 --batch 8 --seq 256 --flags flash_kernel \
        [--ckpt-dir DIR [--ckpt-every N] [--crash-at STEP] [--no-resume]]

Runs on the card by default; ``--device cpu`` runs on the CPU and then
needs ``--peak-flops`` and ``--mem-total-gb`` for the LLload figures.  The
trainer publishes each step's duty cycle into the LLload job registry; at
the end the launcher prints every step's loss, the registry's view of the
job and the ``done:`` line, whose ``start_step=`` is the step it resumed
from.  With ``--ckpt-dir`` it checkpoints every ``--ckpt-every`` steps and
at the end, and resumes from the newest complete checkpoint there unless
``--no-resume``; ``--crash-at STEP`` injects a node failure before that
step (the restart demo: run the same command again to resume); 0, the
reference's default of no crash, injects none.  Exit
codes: 0 done; 1 environment (no card, kernel build failed) or an
injected failure (``error: injected node failure at step N``); 2 usage.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.fault import CrashInjector
from repro_torch.models.perf_flags import PerfFlags, perf_flags
from repro_torch.monitor import JobRegistry
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llsc-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU smoke) config of the arch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a failure at this step (restart demo); "
                         "0 injects none, as in the reference")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--flags", default="",
                    help="comma-separated PerfFlags, e.g. flash_kernel")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="device peak FLOP/s (default on a card: the H100 "
                         "peak of the model's dtype)")
    ap.add_argument("--mem-total-gb", type=float, default=None,
                    help="device memory in GB (default on a card: read)")
    args = ap.parse_args(argv)

    try:
        flags = PerfFlags.parse(args.flags)
        cfg = get_config(args.arch)
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.steps < 1 or args.ckpt_every < 1:
        print("error: --steps and --ckpt-every must be at least 1",
              file=sys.stderr)
        return 2
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.device == "cpu" and (args.peak_flops is None
                                 or args.mem_total_gb is None):
        print("error: --device cpu needs --peak-flops and --mem-total-gb",
              file=sys.stderr)
        return 2
    tcfg = TrainerConfig(steps=args.steps, batch_size=args.batch,
                         seq_len=args.seq, seed=args.seed,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         job_name=f"train:{cfg.name}", device=args.device,
                         peak_flops=args.peak_flops,
                         mem_total_gb=args.mem_total_gb)
    crash = CrashInjector(args.crash_at) if args.crash_at else None
    try:
        trainer = Trainer(cfg, tcfg, crash=crash)
        with perf_flags(flags):
            out = trainer.run(resume=not args.no_resume)
    except RuntimeError as e:   # no card, a kernel build, an injected crash
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"[launch.train] losses: "
          f"{' '.join(f'{x:.4f}' for x in out['losses'])}")
    agg = JobRegistry.global_registry().entries().get(tcfg.job_name)
    if agg is not None:     # none when a resume found every step done
        print(f"LLload view: duty={agg.duty_cycle:.6f} "
              f"step={agg.step_time_s * 1e3:.1f}ms "
              f"mem={agg.hbm_used_gb:.3f}/{agg.hbm_total_gb:.1f}GB")
    print(f"[launch.train] done: steps={args.steps} "
          f"final_loss={out['final_loss']:.4f} "
          f"start_step={out['start_step']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
