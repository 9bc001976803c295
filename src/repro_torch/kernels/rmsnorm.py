"""ctypes wrappers of the hand-written CUDA RMSNorm and gated RMSNorm
(``csrc/rmsnorm.cu``), the ports of ``repro/kernels/rmsnorm.py:19
_rmsnorm_kernel`` and ``:26 _gated_kernel``.

Both take CUDA tensors only and raise on anything the kernel does not take;
the CPU path lives in :mod:`repro_torch.kernels.ops`.  There is no
backward: with grad enabled, inputs that require grad raise (``kernels.ops``
is the differentiable route).  ``launches``
counts the launches of the plain norm, ``gated_launches`` those of the
gated one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _guard

launches = 0
gated_launches = 0

DTYPES = (torch.float32, torch.bfloat16)
# The widest gated row the kernel holds in registers (1024 threads x 16
# values): jamba's d_inner, the widest gate of the repo's models.
GATED_MAX_WIDTH = 16384


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("rmsnorm").rmsnorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _gated_kernel():
    fn = _build.load("rmsnorm").gated_rmsnorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_dtypes(name, x, scale):
    """The pairs the kernels take: the scale in x's dtype, or a float32
    scale with bfloat16 x (applied in fp32, as the reference applies the
    1-D scale that its ``cast_params`` leaves in float32).  Returns whether
    the scale is that float32 one."""
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype}; the kernel takes "
                         f"{DTYPES}")
    if scale.dtype == x.dtype:
        return False
    if x.dtype == torch.bfloat16 and scale.dtype == torch.float32:
        return True
    raise ValueError(f"{name}: scale has dtype {scale.dtype}, the input "
                     f"{x.dtype}; the kernel takes the scale in the input's "
                     "dtype, or float32 with bfloat16 input")


def _rows(kernel, t, name, d):
    """``t`` [..., d] as a [rows, d] view with one row stride (the last
    dimension contiguous); ``kernel`` raises when its rows have no single
    stride."""
    if t.shape[-1] != d or t.stride(-1) != 1:
        raise ValueError(f"{kernel}: {name} {tuple(t.shape)} must end in a "
                         f"contiguous dimension of {d}")
    try:
        rows = t.view(-1, d)
    except RuntimeError:
        raise ValueError(f"{kernel}: the rows of {name} (strides "
                         f"{t.stride()}) have no single stride") from None
    return rows, (rows.stride(0) if rows.shape[0] > 1 else d)


def rmsnorm(x, scale, eps: float = 1e-5):
    """x [..., D] with one stride between rows and a contiguous last
    dimension (MLA's ``kv_norm`` reads a slice of a wider projection);
    scale [D] in x's dtype, or float32 with bfloat16 x.  Returns a
    contiguous tensor of x's shape and dtype."""
    global launches
    _guard.refuse_autograd("rmsnorm", x, scale)
    scale_f32 = _check_dtypes("rmsnorm", x, scale)
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_cuda:
            raise ValueError(f"rmsnorm: {name} is not a CUDA tensor")
    if x.device != scale.device:
        raise ValueError("rmsnorm: x and scale on different devices")
    if x.dim() == 0 or scale.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if not scale.is_contiguous():
        raise ValueError("rmsnorm: scale must be contiguous")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    d = x.shape[-1]
    x2, x_stride = _rows("rmsnorm", x, "x", d)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x2.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        int(x.dtype == torch.bfloat16), int(scale_f32),
                        x2.shape[0], d, x_stride, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def gated_rmsnorm(y, z, scale, eps: float = 1e-5):
    """RMSNorm(y * silu(z)).  y, z [..., D] of one shape, each with one
    stride between rows and a contiguous last dimension (the gate is a
    strided slice of the input projection) in one dtype; scale [D] in
    that dtype, or float32 with bfloat16 y and z.  Returns a contiguous
    tensor of y's shape and dtype."""
    global gated_launches
    _guard.refuse_autograd("gated_rmsnorm", y, z, scale)
    if z.dtype != y.dtype:
        raise ValueError(f"gated_rmsnorm: z has dtype {z.dtype}, y has "
                         f"{y.dtype}; the kernel takes one dtype for both")
    scale_f32 = _check_dtypes("gated_rmsnorm", y, scale)
    for name, t in (("y", y), ("z", z), ("scale", scale)):
        if not t.is_cuda:
            raise ValueError(f"gated_rmsnorm: {name} is not a CUDA tensor")
    if not (y.device == z.device == scale.device):
        raise ValueError("gated_rmsnorm: y, z, scale on different devices")
    if y.dim() == 0 or z.shape != y.shape or scale.shape != (y.shape[-1],):
        raise ValueError(f"gated_rmsnorm: y {tuple(y.shape)}, z "
                         f"{tuple(z.shape)} and scale {tuple(scale.shape)} do "
                         "not match")
    if not scale.is_contiguous():
        raise ValueError("gated_rmsnorm: scale must be contiguous")
    d = y.shape[-1]
    if d > GATED_MAX_WIDTH:
        raise ValueError(f"gated_rmsnorm: rows of {d}; the kernel takes at "
                         f"most {GATED_MAX_WIDTH}")
    out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    if out.numel() == 0:
        return out
    y2, y_stride = _rows("gated_rmsnorm", y, "y", d)
    z2, z_stride = _rows("gated_rmsnorm", z, "z", d)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _gated_kernel()(y2.data_ptr(), z2.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), int(y.dtype == torch.bfloat16),
                              int(scale_f32), y2.shape[0], d, y_stride,
                              z_stride, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"gated_rmsnorm kernel launch failed: CUDA error "
                           f"{err}")
    gated_launches += 1
    return out
