"""Shared layer primitives (counterpart of ``repro.models.layers``):
the parameter leaf spec, RMSNorm, half-split RoPE, the dense MLP and the
embedding.

Functions take ``(params, x, ...)`` with ``params`` a dict of tensors.
Compute dtype follows the input; statistics accumulate in float32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

F32 = torch.float32


def ones(shape):
    return torch.ones(shape, dtype=F32)


def zeros(shape):
    return torch.zeros(shape, dtype=F32)


class Leaf(NamedTuple):
    """One parameter of a spec tree, as the reference's ``init_*`` makes it.

    With ``std`` set, a normal truncated at two std, times ``std``; else the
    fixed float32 value ``fixed(shape)`` (ones unless given).  ``fp32``
    leaves are float32 whatever the model dtype; the others take the model
    dtype.
    """

    shape: Tuple[int, ...]
    std: Optional[float] = None
    fixed: Callable[[Tuple[int, ...]], torch.Tensor] = ones
    fp32: bool = False


def rmsnorm(params, x, eps: float = 1e-5):
    """fp32 statistics, the scale applied in fp32 before the cast back —
    the reference's ``layers.rmsnorm`` — through the RMSNorm kernel."""
    return ops.rmsnorm(x, params["scale"], eps)


def rope_sincos(positions, dim: int, theta: float):
    """positions [...] int -> (sin, cos) each [..., dim/2] float32."""
    if dim % 2:
        raise ValueError(f"RoPE needs an even dim, got {dim}")
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    inv = torch.from_numpy(inv_freq).to(positions.device)
    angles = positions.to(F32)[..., None] * inv
    return torch.sin(angles), torch.cos(angles)


def apply_rope_bshd(x, positions, theta: float):
    """RoPE on x [B,S,H,D] at positions [S] or [B,S]; half-split: the first
    and second halves of the head dim form the rotated pairs."""
    sin, cos = rope_sincos(positions, x.shape[-1], theta)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].to(F32), x[..., d2:].to(F32)
    if sin.dim() == 2:       # positions [S]
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:                    # positions [B, S]
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def mlp(params, x, act: str):
    """The dense FFN: SwiGLU, GeGLU or GELU.  GELU is the tanh
    approximation, ``jax.nn.gelu``'s default."""
    h = x @ params["w1"]
    if act == "swiglu":
        h = F.silu(h) * (x @ params["w3"])
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ params["w3"])
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ params["w2"]


def embed(table, tokens, scale: float = 1.0):
    x = table[tokens]
    if scale != 1.0:
        x = (x.to(F32) * scale).to(x.dtype)
    return x
