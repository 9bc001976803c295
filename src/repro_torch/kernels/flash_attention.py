"""ctypes wrapper of the hand-written CUDA flash-attention forward
(``csrc/flash_attention.cu``), the port of
``repro/kernels/flash_attention.py:27 _flash_kernel``.

Both functions take CUDA tensors only and raise on anything the kernel does
not take; the CPU path lives in :mod:`repro_torch.kernels.ops`.  bfloat16
runs on the tensor cores and reads q, k and v with 16-byte copies, so their
base pointers and (batch, seq, head) strides must be 16-byte aligned;
float32 is the exactness path (fp32 products).  The head dim is one of
``HEAD_DIMS``, the ones the port's configs use (16 reduced, 64, 128, 256);
any other raises.  There is no backward: with
grad enabled, inputs that require grad raise (``kernels.ops`` is the
differentiable route).  ``launches`` counts the
kernel launches made through this module.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _guard

launches = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    _guard.refuse_autograd("flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is not a CUDA tensor")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} has dtype {t.dtype}; "
                             f"the kernel takes {DTYPES}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v differ in dtype")
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")


def _launch(q, k, v, out, dims, strides, causal, scale):
    """dims = (B, H, Hk, S, T, D); strides = four (batch, seq, head)
    triples for q, k, v, out."""
    global launches
    B, H, Hk, S, T, D = dims
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if H % Hk:
        raise ValueError(f"flash_attention: {H} heads are not a multiple of "
                         f"{Hk} kv heads")
    if q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError("flash_attention: q and k differ in batch or head dim")
    if min(B, S, T) == 0:
        return out
    if q.dtype == torch.bfloat16:
        for name, t, st in zip("qkv", (q, k, v), strides):
            if t.data_ptr() % 16 or any(x % 8 for x in st):
                raise ValueError(
                    f"flash_attention: bfloat16 {name} must be 16-byte "
                    f"aligned (address {t.data_ptr():#x}, (batch, seq, "
                    f"head) strides {st} elements, each a multiple of 8)")
    scale = D ** -0.5 if scale is None else scale
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), int(q.dtype == torch.bfloat16),
                        B, H, Hk, S, T, D, *[s for t in strides for s in t],
                        float(scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q [B,H,S,D]; k,v [B,Hk,T,D] -> [B,H,S,D] (H a multiple of Hk)."""
    _check(q, k, v)
    B, H, S, D = q.shape
    Hk, T = k.shape[1], k.shape[2]
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)

    def bsh(t):
        return (t.stride(0), t.stride(2), t.stride(1))

    return _launch(q, k, v, out, (B, H, Hk, S, T, D),
                   (bsh(q), bsh(k), bsh(v), bsh(out)), causal, scale)


def flash_attention_bshd(q, k, v, *, causal: bool = True, scale=None):
    """The model's layout: q [B,S,H,D]; k,v [B,T,Hk,D] -> [B,S,H,D].

    Reads the inputs through their strides; nothing is transposed or copied.
    """
    _check(q, k, v)
    B, S, H, D = q.shape
    T, Hk = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)

    def bsh(t):
        return (t.stride(0), t.stride(1), t.stride(2))

    return _launch(q, k, v, out, (B, H, Hk, S, T, D),
                   (bsh(q), bsh(k), bsh(v), bsh(out)), causal, scale)
