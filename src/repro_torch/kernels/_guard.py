"""The check every kernel wrapper makes before anything else."""
from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when autograd would record the kernel: a wrapper has no
    backward, so its output would silently cut the gradient (the
    differentiable route is ``kernels.ops``, whose autograd Functions call
    the wrappers with grad off)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, so it would cut the "
            "gradient of inputs that require grad; call it through "
            "repro_torch.kernels.ops, under torch.no_grad() or on tensors "
            "that do not require grad")
