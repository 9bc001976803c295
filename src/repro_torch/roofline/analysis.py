"""Three-term roofline of one H100 (counterpart of
``repro.roofline.analysis``), from per-device counts; no card is needed.

    compute    = FLOPs / peak_FLOP/s             (per device)
    memory     = bytes / HBM_bw                  (per device)
    collective = collective_bytes / link bw      (per device)

The port's dry-run (``launch/dryrun.py``) counts FLOPs, bytes and
collective bytes on each device's own shards, so the per-device rates of
``hw`` apply directly (the global form is FLOPs_total / (devices x peak)).

Collective bytes are what each device moves over the link, in the ring
convention: all-reduce 2x its payload, all-gather / reduce-scatter ~1x,
all-to-all and collective-permute 1x (``_COST_FACTOR``).
``parse_collective_bytes`` reads them from XLA HLO text, as the
reference does; the port's dry-run counts them from the collectives it
sees instead and passes the breakdown to :func:`roofline`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

from repro_torch.roofline import hw

_COLLECTIVE_RE = re.compile(
    r"=\s+(?:\()?([a-z0-9]+)\[([0-9,]*)\][^\s]*\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")

_TUPLE_COLLECTIVE_RE = re.compile(
    r"=\s+\((.*?)\)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * hw.DTYPE_BYTES.get(dtype, 4)


_COST_FACTOR = {
    "all-reduce": 2.0,          # ring: 2(n-1)/n ~= 2
    "all-gather": 1.0,          # receives (n-1)/n of output ~= output
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def parse_collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-device bytes moved per collective kind, summed over ops."""
    out: Dict[str, float] = {k: 0.0 for k in _COST_FACTOR}
    counts: Dict[str, int] = {k: 0 for k in _COST_FACTOR}
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.search(line)
        if m:
            dtype, dims, kind = m.group(1), m.group(2), m.group(3)
            size = _shape_bytes(dtype, dims)
        else:
            mt = _TUPLE_COLLECTIVE_RE.search(line)
            if not mt:
                continue
            kind = mt.group(2)
            size = sum(_shape_bytes(d, s)
                       for d, s in _SHAPE_RE.findall(mt.group(1)))
        out[kind] += size * _COST_FACTOR[kind]
        counts[kind] += 1
    out["_op_counts"] = counts  # type: ignore
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    collective_bytes: float      # per-device link bytes (cost-weighted)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0     # 6ND / 2ND convention
    useful_ratio: float = 0.0    # model_flops_per_device / FLOPs
    collective_breakdown: Optional[dict] = None

    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """compute_term / max(all terms): 1.0 == compute-bound at peak."""
        b = self.bound_s()
        return self.compute_s / b if b > 0 else 0.0


def terms_from_monitoring(gpu_duty: float, step_time_s: float,
                          hbm_used_gb: float) -> RooflineTerms:
    """Roofline terms estimated from *monitoring* data (DESIGN.md §11):
    what the job-level observability layer knows about a running job,
    instead of a dry-run's counts.

    ``gpu_duty`` is the MFU proxy (achieved FLOP/s / peak), so the
    per-step achieved flops are ``duty * peak * step``; the memory term
    assumes the job streams its resident HBM footprint once per step —
    the standard working-set bound when no count is available.  With no
    step time reported a nominal 1 s step is used (both terms scale
    together, so the verdict is step-time invariant).
    """
    step = step_time_s if step_time_s > 0 else 1.0
    flops = gpu_duty * hw.PEAK_FLOPS_BF16 * step
    hbm_bytes = hbm_used_gb * 2.0 ** 30
    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = hbm_bytes / hw.HBM_BW
    dominant = "compute" if compute_s >= memory_s else "memory"
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm_bytes, collective_bytes=0.0,
        compute_s=compute_s, memory_s=memory_s, collective_s=0.0,
        dominant=dominant)


def verdict_from_monitoring(gpu_duty: float, step_time_s: float,
                            hbm_used_gb: float) -> str:
    """One-line roofline verdict for a job report, e.g.
    ``"memory-bound at 43% of roofline"`` (the MPCDF-report phrasing).

    The percentage is the dominant term's share of the step time — how
    close the job runs to the roof it is under (compute-bound at duty
    1.0 means the devices never idle).  Jobs reporting neither duty nor
    HBM get ``"no device activity"`` rather than a fabricated bound.
    """
    if gpu_duty <= 0.0 and hbm_used_gb <= 0.0:
        return "no device activity"
    terms = terms_from_monitoring(gpu_duty, step_time_s, hbm_used_gb)
    step = step_time_s if step_time_s > 0 else 1.0
    frac = min(terms.bound_s() / step, 1.0)
    if terms.dominant == "compute":
        return f"compute-bound at {frac * 100:.0f}% of roofline"
    return f"memory-bound at {frac * 100:.0f}% of roofline"


def roofline(cost: dict, hlo_text: str, *, n_devices: int,
             model_flops_global: float = 0.0) -> RooflineTerms:
    """Terms of per-device ``cost`` (``"flops"``, ``"bytes accessed"``),
    with the collectives of ``hlo_text`` over ``hw.LINK_BW``."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = parse_collective_bytes(hlo_text)
    breakdown = {k: v for k, v in coll.items() if k != "_op_counts"}
    coll_bytes = sum(breakdown.values())
    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = hbm / hw.HBM_BW
    coll_s = coll_bytes / hw.LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf_dev = model_flops_global / max(n_devices, 1)
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm, collective_bytes=coll_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=model_flops_global,
        useful_ratio=(mf_dev / flops) if flops else 0.0,
        collective_breakdown={**breakdown,
                              "op_counts": coll.get("_op_counts")},
    )
