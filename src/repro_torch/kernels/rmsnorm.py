"""ctypes wrapper of the hand-written CUDA RMSNorm (``csrc/rmsnorm.cu``),
the port of ``repro/kernels/rmsnorm.py:19 _rmsnorm_kernel``.

Takes CUDA tensors only and raises on anything the kernel does not take;
the CPU path lives in :mod:`repro_torch.kernels.ops`.  ``launches`` counts
the kernel launches made through this module.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("rmsnorm").rmsnorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x, scale, eps: float = 1e-5):
    """x [..., D] contiguous; scale [D] in x's dtype -> x's shape and
    dtype."""
    global launches
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_cuda:
            raise ValueError(f"rmsnorm: {name} is not a CUDA tensor")
        if t.dtype not in DTYPES:
            raise ValueError(f"rmsnorm: {name} has dtype {t.dtype}; the "
                             f"kernel takes {DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm: {name} must be contiguous")
    if x.device != scale.device:
        raise ValueError("rmsnorm: x and scale on different devices")
    if scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm: scale has dtype {scale.dtype}, x has "
                         f"{x.dtype}; the kernel takes one dtype for both")
    if x.dim() == 0 or scale.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not match "
                         f"x {tuple(x.shape)}")
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        int(x.dtype == torch.bfloat16), rows, d,
                        float(eps), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    launches += 1
    return out
