"""Fault tolerance and elasticity (the port's copy of
``repro.launch.fault``).

  * Checkpoint/restart: atomic step checkpoints (``train/checkpoint.py``);
    ``resume_latest`` picks the newest complete step after a crash or a
    preemption.
  * Straggler detection: per-host step wall-times are recorded; a host
    persistently slower than the fleet median by ``slow_factor`` is
    flagged.  This is the LLload ``-t N`` idea pointed at step time
    instead of CPU load.
  * Failure injection for restart tests: ``CrashInjector`` raises at a
    chosen step, so the restart path runs end to end.
  * Elastic resize: ``ElasticResizePlan`` is the shrink decision for a
    tenant holding most of the fleet while others queue.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerReport:
    host: str
    median_step_s: float
    host_step_s: float
    factor: float


class StragglerDetector:
    """Tracks per-host step times (a real deployment feeds one entry per
    host from its LLload self-report; tests feed synthetic fleets)."""

    def __init__(self, slow_factor: float = 1.5, window: int = 16):
        self.slow_factor = slow_factor
        self.window = window
        self._times: Dict[str, List[float]] = {}

    def record(self, host: str, step_s: float):
        buf = self._times.setdefault(host, [])
        buf.append(step_s)
        if len(buf) > self.window:
            buf.pop(0)

    def stragglers(self) -> List[StragglerReport]:
        if len(self._times) < 2:
            return []
        means = {h: statistics.fmean(v) for h, v in self._times.items()
                 if v}
        med = statistics.median(means.values())
        out = []
        for host, m in means.items():
            if med > 0 and m / med >= self.slow_factor:
                out.append(StragglerReport(host, med, m, m / med))
        return sorted(out, key=lambda r: -r.factor)


@dataclasses.dataclass(frozen=True)
class ElasticResizePlan:
    """A shrink decision for one dominant tenant's jobs.

    ``shrink`` maps a job's current task count to its resized one:
    ``max(min_tasks, int(n_tasks * factor))``, deterministic, so the
    closed loop (insight, resize, resubmit) replays identically.  A plan
    never grows a job (``factor`` is clamped to <= 1.0).
    """
    username: str
    factor: float = 0.5
    min_tasks: int = 1

    def shrink(self, n_tasks: int) -> int:
        """The resized task count for a job of ``n_tasks`` tasks."""
        factor = min(self.factor, 1.0)
        return max(self.min_tasks, int(n_tasks * factor))


class CrashInjector:
    """Deterministic failure injection for restart tests: the first
    ``maybe_crash(crash_at_step)`` raises ``RuntimeError``."""

    def __init__(self, crash_at_step: Optional[int] = None):
        self.crash_at_step = crash_at_step
        self.fired = False

    def maybe_crash(self, step: int):
        if (self.crash_at_step is not None and step == self.crash_at_step
                and not self.fired):
            self.fired = True
            raise RuntimeError(f"injected node failure at step {step}")


def resume_latest(ckpt_dir: str, state_template, shardings=None,
                  device="cuda"):
    """(state on ``device``, its step) from the newest complete checkpoint
    in ``ckpt_dir``, or (None, 0) when there is none; ``shardings`` as
    ``restore_checkpoint`` takes them."""
    # imported here: repro_torch.train imports this module
    from repro_torch.train import checkpoint as ckpt

    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return None, 0
    state, meta = ckpt.restore_checkpoint(ckpt_dir, step, state_template,
                                          shardings, device)
    return state, int(meta["step"])
