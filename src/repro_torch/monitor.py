"""Job-side LLload publishing (the port's copy of the job registry of
``repro.core.collector`` and of ``repro.monitor.bus.publish_step_utilization``).

A serving or training job publishes each timed step's achieved utilization
into an in-process registry, keyed by job name; LLload's collectors read
the registry instead of probing the device.  The port keeps its own copy so
that it imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

from repro_torch.models.transformer import model_dtype
from repro_torch.roofline import hw


@dataclasses.dataclass
class DeviceUtilization:
    """What a job knows about its own devices."""
    n_devices: int = 0
    n_active: int = 0
    duty_cycle: float = 0.0     # achieved FLOP/s / peak FLOP/s (MFU proxy)
    hbm_total_gb: float = 0.0
    hbm_used_gb: float = 0.0
    step_time_s: float = 0.0
    achieved_flops: float = 0.0


class JobRegistry:
    """In-process registry jobs publish to (``JaxJobRegistry`` in the
    reference); thread-safe, keyed by job name."""

    _global = None
    _global_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, DeviceUtilization] = {}  # guarded-by: _lock

    @classmethod
    def global_registry(cls) -> "JobRegistry":
        with cls._global_lock:
            if cls._global is None:
                cls._global = cls()
            return cls._global

    def publish(self, job_name: str, util: DeviceUtilization):
        with self._lock:
            self._entries[job_name] = util

    def remove(self, job_name: str):
        with self._lock:
            self._entries.pop(job_name, None)

    def entries(self) -> Dict[str, DeviceUtilization]:
        with self._lock:
            return dict(self._entries)

    def aggregate(self) -> DeviceUtilization:
        """Combine all co-resident jobs into one per-device view: duty
        cycles add per device (jobs in one process share the devices),
        capped at the number of jobs."""
        with self._lock:
            entries = list(self._entries.values())
        if not entries:
            return DeviceUtilization()
        n = max(e.n_devices for e in entries)
        weighted = sum(e.duty_cycle * max(e.n_devices, 1)
                       for e in entries) / max(n, 1)
        return DeviceUtilization(
            n_devices=n,
            n_active=max(e.n_active for e in entries),
            duty_cycle=min(float(len(entries)), weighted),
            hbm_total_gb=max(e.hbm_total_gb for e in entries),
            hbm_used_gb=sum(e.hbm_used_gb for e in entries),
            step_time_s=max(e.step_time_s for e in entries),
            achieved_flops=sum(e.achieved_flops for e in entries),
        )


def publish_step_utilization(job_name: str, *, model_flops_per_step: float,
                             step_time_s: float, peak_flops: float,
                             n_devices: int = 1, hbm_used_gb: float = 0.0,
                             hbm_total_gb: float = 0.0, registry=None):
    """Publish one timed step's achieved utilization into ``registry``
    (default: the process-wide registry)."""
    duty = 0.0
    if step_time_s > 0 and peak_flops > 0:
        duty = model_flops_per_step / step_time_s / (peak_flops * n_devices)
    reg = registry or JobRegistry.global_registry()
    reg.publish(job_name, DeviceUtilization(
        n_devices=n_devices, n_active=n_devices, duty_cycle=duty,
        hbm_total_gb=hbm_total_gb, hbm_used_gb=hbm_used_gb,
        step_time_s=step_time_s,
        achieved_flops=model_flops_per_step / max(step_time_s, 1e-9)))


def default_peak_flops(cfg) -> float:
    """The H100 peak the duty cycle is measured against on a card: that of
    the model's compute dtype (bf16 on the tensor cores, fp32 outside)."""
    return hw.peak_flops(model_dtype(cfg))


def device_figures(device, cfg, peak_flops: Optional[float],
                   mem_total_gb: Optional[float], *, monitored: bool,
                   job: str) -> Tuple[Optional[float], Optional[float]]:
    """The peak FLOP/s and the memory (GB) a job's duty cycle is measured
    against.  On a card each one not given defaults to
    ``default_peak_flops(cfg)`` and the card's memory; on the CPU there is
    no device figure, so a monitored ``job`` must be given both."""
    if device.type == "cuda":
        if peak_flops is None:
            peak_flops = default_peak_flops(cfg)
        if mem_total_gb is None:
            mem_total_gb = hw.device_memory_bytes(device) / 1e9
    elif monitored and (peak_flops is None or mem_total_gb is None):
        raise ValueError(f"a monitored {job} on the CPU needs "
                         "peak_flops and mem_total_gb")
    return peak_flops, mem_total_gb
