"""The check every kernel wrapper makes before anything else."""
from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when autograd would record the kernel: the kernels have no
    backward, so their output would silently cut the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, so it would cut the "
            "gradient of inputs that require grad; call it under "
            "torch.no_grad() or on tensors that do not require grad")
