"""ctypes wrapper of the hand-written CUDA SSD intra-chunk kernel
(``csrc/ssd.cu``), the port of ``repro/kernels/ssd.py:27 _ssd_kernel``.

Takes CUDA tensors only and raises on anything the kernel does not take;
the CPU path lives in :mod:`repro_torch.kernels.ops`.  There is no
backward: with grad enabled, inputs that require grad raise (``kernels.ops``
is the differentiable route).  ``launches``
counts the kernel launches made through this module; ``heads_per_block``
is what the last launch took: the heads a block of the tensor-core body
owned, or 0 for the CUDA-core body (float32, or bfloat16 rows off 16-byte
alignment).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _guard

launches = 0
heads_per_block = 0

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
MAX_STATE = 256


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("ssd").ssd_intra_chunk_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 9
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk(x, dt, A, B, C, *, out_dtype=None):
    """Diagonal SSD block of each chunk.  x [N,l,h,p]; dt [N,l,h] and A [h]
    contiguous float32; B, C [N,l,g,n] in x's dtype; x, B, C may be strided
    views with a contiguous last dimension.  Returns y [N,l,h,p], contiguous,
    in ``out_dtype`` (float32 or x's dtype; default x's dtype)."""
    global launches, heads_per_block
    _guard.refuse_autograd("ssd_intra_chunk", x, dt, A, B, C)
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.is_cuda:
            raise ValueError(f"ssd_intra_chunk: {name} is not a CUDA tensor")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("ssd_intra_chunk: inputs on different devices")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_intra_chunk: x, B, C have dtypes {x.dtype}, "
                         f"{B.dtype}, {C.dtype}; the kernel takes one of "
                         f"{DTYPES} for all three")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_intra_chunk: dt and A must be float32")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.float32, x.dtype):
        raise ValueError(f"ssd_intra_chunk: out_dtype {out_dtype}; the kernel "
                         f"writes float32 or x's dtype")
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"ssd_intra_chunk: x {tuple(x.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}: expected "
                         "[N,l,h,p] and two [N,l,g,n]")
    N, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (N, l, h) or A.shape != (h,) or B.shape[:2] != (N, l):
        raise ValueError(f"ssd_intra_chunk: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"ssd_intra_chunk: {h} heads in {g} groups")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_intra_chunk: head dim {p} (max {MAX_HEAD_DIM}) "
                         f"or state {n} (max {MAX_STATE}) too large")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssd_intra_chunk: dt and A must be contiguous")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_intra_chunk: {name}'s last dimension must "
                             "be contiguous")
    out = torch.empty((N, l, h, p), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    hb = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), C.data_ptr(), out.data_ptr(),
                        int(x.dtype == torch.bfloat16),
                        int(out_dtype == torch.bfloat16), N, l, h, p, g, n,
                        *x.stride()[:3], *B.stride()[:3], *C.stride()[:3],
                        ctypes.byref(hb), stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    heads_per_block = hb.value
    return out
