"""Overloading (NPPN) controller — the port's copy of
``repro.core.overload`` (with ``recommend_nppn`` from
``repro.insights.rules``), and its analytic packing model.

The paper's §V-B policy: raise the tasks per GPU 1 -> 2 -> 4 -> 8 while the
projected duty cycle and memory stay under their caps; back off when the
device saturates.  The serving engine feeds it one observation per step.
"""
from __future__ import annotations

import dataclasses
from typing import List

NPPN_LEVELS = (1, 2, 4, 8)


def recommend_nppn(gpu_load: float, gpu_mem_used_gb: float,
                   gpu_mem_total_gb: float, *, target_load: float = 0.9,
                   mem_headroom: float = 0.9, max_nppn: int = 8) -> int:
    """Pack tasks per GPU until the summed duty cycle reaches ~target or
    the device memory would overflow; rounded down to an NPPN level."""
    if gpu_load <= 0:
        return 1
    by_load = int(target_load / max(gpu_load, 1e-3))
    per_task_mem = max(gpu_mem_used_gb, 1e-3)
    by_mem = int((gpu_mem_total_gb * mem_headroom) / per_task_mem)
    n = max(1, min(by_load, by_mem, max_nppn))
    for v in (8, 4, 2, 1):
        if n >= v:
            return v
    return 1


def nearest_level(nppn: int, *, max_nppn: int = 8) -> int:
    """Clamp a tasks-per-GPU count onto the LLsub levels: the largest level
    <= ``nppn`` (and <= ``max_nppn``), floor 1."""
    n = min(max(nppn, 1), max(max_nppn, 1))
    for v in reversed(NPPN_LEVELS):
        if v <= n:
            return v
    return NPPN_LEVELS[0]


@dataclasses.dataclass
class DeviceObservation:
    duty_cycle: float          # 0..1 utilization of the device
    mem_used_gb: float         # summed over the co-resident tasks
    mem_total_gb: float


@dataclasses.dataclass
class OverloadDecision:
    nppn: int
    reason: str


class OverloadController:
    """Step controller over NPPN levels: ``observe`` accumulates device
    observations, ``decide`` proposes the next level."""

    def __init__(self, *, target_load: float = 0.9,
                 saturate_load: float = 0.98, mem_headroom: float = 0.9,
                 max_nppn: int = 8):
        self.target_load = target_load
        self.saturate_load = saturate_load
        self.mem_headroom = mem_headroom
        self.max_nppn = max_nppn
        self.history: List[DeviceObservation] = []

    def observe(self, obs: DeviceObservation):
        self.history.append(obs)

    def decide(self, current_nppn: int) -> OverloadDecision:
        level = nearest_level(current_nppn, max_nppn=self.max_nppn)
        if not self.history:
            return OverloadDecision(level, "no observations")
        window = self.history[-8:]
        duty = sum(o.duty_cycle for o in window) / len(window)
        obs = window[-1]
        per_task_duty = duty / max(current_nppn, 1)
        per_task_mem = obs.mem_used_gb / max(current_nppn, 1)

        if duty >= self.saturate_load and level > 1:
            if level < current_nppn:
                nxt = level        # clamping already stepped down (3 -> 2)
            else:
                nxt = NPPN_LEVELS[max(NPPN_LEVELS.index(level) - 1, 0)]
            return OverloadDecision(
                nxt, f"device saturated (duty {duty:.2f}); backing off")

        best = recommend_nppn(per_task_duty, per_task_mem, obs.mem_total_gb,
                              target_load=self.target_load,
                              mem_headroom=self.mem_headroom,
                              max_nppn=self.max_nppn)
        if best > current_nppn:
            # one level at a time (2 -> 4 -> 8), as deployed at LLSC
            idx = NPPN_LEVELS.index(level)
            nxt = NPPN_LEVELS[min(idx + 1, len(NPPN_LEVELS) - 1)]
            return OverloadDecision(
                nxt, f"duty/task {per_task_duty:.2f}, mem/task "
                     f"{per_task_mem:.1f}GB -> headroom for NPPN={best}")
        if best < current_nppn:
            return OverloadDecision(best, "memory or load headroom shrank")
        return OverloadDecision(level, "at recommended level")


def packed_throughput_model(per_task_duty: float, nppn: int,
                            interference: float = 0.03) -> float:
    """Analytic throughput multiple for NPPN tasks sharing one device.

    Tasks time-share: aggregate duty saturates at 1.0; each co-resident
    task adds a small interference tax (context switching / memory
    traffic).  The measured counterpart is
    ``repro_torch.examples.overloading_throughput``.
    """
    raw = min(1.0, per_task_duty * nppn)
    return raw * (1.0 - interference * (nppn - 1))
