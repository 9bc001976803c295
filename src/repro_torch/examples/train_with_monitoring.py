"""Train llsc-100m with LLload self-reporting, checkpoint/restart and the
straggler hook (the port's counterpart of
``examples/train_with_monitoring.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_with_monitoring \
        [--steps 240] [--crash-at N] [--ckpt-dir build/llsc100m-ckpt]
    PYTHONPATH=src python -m repro_torch.examples.train_with_monitoring \
        --device cpu --reduced --peak-flops 1e12 --mem-total-gb 16

Runs on the card by default (the full model, 4 x 64 tokens a step);
``--device cpu`` runs on the CPU and then needs ``--peak-flops`` and
``--mem-total-gb`` for the LLload figures.  The trainer checkpoints every
``--ckpt-every`` steps into ``--ckpt-dir`` and starts from the newest
checkpoint there.  With ``--crash-at N`` the run stops with an injected
node failure before step N and exits 1; invoking the script again resumes
from the last checkpoint.  At the end it prints the registry's view of the
job, as LLload sees a user's GPU job.  The reference also prints the
host's load from its ``LocalHostCollector``; the port has no collector,
so that line is left out.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.fault import CrashInjector
from repro_torch.monitor import JobRegistry
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="build/llsc100m-ckpt")
    ap.add_argument("--ckpt-every", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--peak-flops", type=float, default=None)
    ap.add_argument("--mem-total-gb", type=float, default=None)
    args = ap.parse_args(argv)

    if args.device == "cpu" and (args.peak_flops is None
                                 or args.mem_total_gb is None):
        print("error: --device cpu needs --peak-flops and --mem-total-gb",
              file=sys.stderr)
        return 2
    cfg = get_config("llsc-100m")
    if args.reduced:
        cfg = reduced_config(cfg)
    tcfg = TrainerConfig(steps=args.steps, batch_size=args.batch,
                         seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=10,
                         job_name=f"train:{cfg.name}", device=args.device,
                         peak_flops=args.peak_flops,
                         mem_total_gb=args.mem_total_gb)
    crash = CrashInjector(args.crash_at) if args.crash_at is not None \
        else None
    try:
        out = Trainer(cfg, tcfg, crash=crash).run(resume=True)
    except RuntimeError as e:       # no card, or the injected failure
        hint = (f": run this script again to resume from the last checkpoint "
                f"in {args.ckpt_dir}" if crash is not None and crash.fired
                else "")
        print(f"!! {e}{hint}", file=sys.stderr)
        return 1

    print(f"\nfinal loss: {out['final_loss']:.4f} "
          f"(resumed from step {out['start_step']})")
    agg = JobRegistry.global_registry().entries().get(tcfg.job_name)
    if agg is None:
        return 0        # a resume that found every step done publishes none
    print("\nLLload view of this job:")
    print(f"  devices:    {agg.n_devices}")
    print(f"  duty cycle: {agg.duty_cycle:.3f}  (achieved/peak FLOP/s)")
    print(f"  step time:  {agg.step_time_s * 1e3:.0f} ms")
    print(f"  memory:     {agg.hbm_used_gb:.3f} / {agg.hbm_total_gb:.1f} GB")
    if agg.duty_cycle < 0.45:
        print("  -> LLload weekly analysis would flag this job LOW-GPULOAD; "
              "the advisor would suggest overloading (see "
              "repro_torch.examples.overloading_throughput)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
