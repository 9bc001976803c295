"""Weights from the JAX package to the port.

:func:`from_jax_params` takes the JAX package's parameter tree with numpy
leaves (``jax.tree.map(np.asarray, params)`` on the JAX side) and returns
the port's tree, the same layout with torch tensors, each in the dtype
the port's ``param_spec`` gives it (the model dtype, or ``dtype`` where
given, and float32 for Mamba-2's A_log, D and dt_bias, as in the
reference), so both packages compute the same function in the parity
tests; ``dtype=torch.float32`` carries the float32 masters of the
reference's ``init_train_state`` across exactly.  The stacked ``blocks``
leaves keep their leading ``n_periods`` axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import leaf_dtype, param_spec


def from_jax_params(tree, cfg, device="cuda", *, dtype=None):
    """Numpy tree (the JAX package's layout) -> the port's tensor tree.

    Raises when a key or a shape differs from the port's ``param_spec``.
    """
    dev = resolve_device(device)

    def convert(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"params{path}: keys {got}, expected "
                                 f"{sorted(spec)}")
            return {k: convert(node[k], spec[k], f"{path}[{k!r}]")
                    for k in spec}
        shape = tuple(spec.shape)
        # a float32 copy: numpy has no bfloat16, bf16 -> f32 is exact, and
        # the tensor must not share the caller's (possibly read-only) buffer
        arr = np.array(node, dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"params{path}: shape {arr.shape}, expected "
                             f"{shape}")
        return torch.from_numpy(arr).to(device=dev,
                                        dtype=leaf_dtype(spec, cfg, dtype))

    return convert(tree, param_spec(cfg), "")
