"""Target hardware: one NVIDIA H100 SXM.

Peak rates are NVIDIA's data-sheet figures for the SXM part, dense (no
sparsity), at the full 700 W power limit; a card set below that limit runs
slower under load, so a roofline share is stated beside the card's limit.
Device memory is read from the card itself.
"""
from __future__ import annotations

import torch

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, tensor cores, dense
PEAK_FLOPS_FP32 = 67e12      # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s


def peak_flops(dtype: torch.dtype) -> float:
    """Peak FLOP/s for matrix work in ``dtype``."""
    return PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16) \
        else PEAK_FLOPS_FP32


def device_memory_bytes(device) -> int:
    """Total memory of the card ``device`` (read from the card)."""
    return torch.cuda.get_device_properties(device).total_memory


def bound_s(n_bytes: float, flops: float, dtype: torch.dtype):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate.  Returns (seconds, bound_by)."""
    t_bytes = n_bytes / HBM_BW
    t_ops = flops / peak_flops(dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
