"""repro_torch — the PyTorch/CUDA port of the ``repro`` workload substrate.

The package mirrors ``repro`` module for module (``configs``, ``kernels``,
``models``, ``serve``, ``launch``, ``roofline``, ``core.overload``) and
keeps its own copies of what it needs: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.

Entry points take an explicit ``device``.  The default is ``"cuda"``;
without a card they raise unless the caller asks for ``"cpu"``.  Nothing
falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    (the default) and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
