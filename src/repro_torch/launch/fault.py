"""Straggler detection (the port's copy of ``StragglerReport`` and
``StragglerDetector`` of ``repro.launch.fault``, the pieces that
``Trainer.run`` calls).

Per-host step wall-times are recorded; a host persistently slower than the
fleet median by ``slow_factor`` is flagged.  This is the LLload ``-t N``
idea pointed at step time instead of CPU load.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List


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
