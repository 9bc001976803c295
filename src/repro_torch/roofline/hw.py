"""Target hardware: one NVIDIA H100 SXM (700 W), and the link between
cards of a DGX H100 cluster (counterpart of ``repro.roofline.hw``).

Peak rates are NVIDIA's data-sheet figures for the SXM part, dense (no
sparsity), at the full 700 W power limit; a card set below that limit runs
slower under load, so a roofline share is stated beside the card's limit.
Device memory is read from the card itself.  No figure here is measured.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, 700 W:
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, BF16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12      # FLOP/s, FP32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3

# The collective term's rate: the per-GPU inter-node rate of a DGX H100,
# one 400 Gb/s ConnectX-7 (InfiniBand NDR) port per GPU = 50e9 bytes/s
# (NVIDIA DGX H100 data sheet; H100 SXM, 700 W).  Every axis of the
# production meshes (data 16 x model 16, and pod 2 x 16 x 16) spans more
# than one 8-GPU NVLink node, so every ring of a collective crosses this
# link, and it sets the ring's pace.  Within a node NVLink 4 gives
# 450e9 bytes/s each way per GPU (H100 SXM data sheet: 900 GB/s both
# ways); it is not used because no mesh axis fits inside one node.
LINK_BW = 50e9               # bytes/s per GPU, inter-node

# Bytes per element of the HLO type names ``analysis.parse_collective_bytes``
# reads (the reference's table).
DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "u4": 1, "s4": 1,
    "f4e2m1fn": 1, "f8e8m0fnu": 1, "f8e4m3": 1, "f8e3m4": 1,
    "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
}


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
