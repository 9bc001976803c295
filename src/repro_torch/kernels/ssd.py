"""ctypes wrapper of the hand-written CUDA SSD intra-chunk kernel
(``csrc/ssd.cu``), the port of ``repro/kernels/ssd.py:27 _ssd_kernel``.

Takes CUDA tensors only and raises on anything the kernel does not take;
the CPU path lives in :mod:`repro_torch.kernels.ops`.  The C entry point
picks the body of each call by shape and alignment alone, one launch a
call (``csrc/ssd_plan.h``):

* bfloat16 x, B, C, 16-byte aligned, head dim 64, state 16 or 128, chunks
  up to 256 (mamba2-370m's and jamba's, every main path): the Hopper body
  ("wgmma": TMA into a ring of mbarrier-tracked stages fed by a producer
  warpgroup, C.B and y += W' x on wgmma, one block an SM walking pairs of
  query tiles);
* other aligned bfloat16 whose shared memory fits the card: the mma.sync
  body ("mma", the reduced configs' head dim 16);
* anything else (float32, rows off 16-byte alignment): the CUDA-core body
  ("fp32").

There is no fallback: the entry point launches the body it picked or
fails, and a failed build, a tensor map that cannot be encoded or a
refused launch raises.  There is no backward: with grad enabled, inputs
that require grad raise (``kernels.ops`` is the differentiable route).
``launches`` counts the kernel launches made through this module and
``launches_by_body`` the same launches by body; ``body`` names the body
the last launch took, as the entry point reports it, and
``heads_per_block`` the heads a block of a tensor-core body owned (1 for
the Hopper body's work items), or 0 for the CUDA-core body.  ``plan``
asks the same rule what a shape would take.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, _guard

# The bodies, by their numbers in csrc/ssd_plan.h.
BODIES = ("fp32", "mma", "wgmma")

launches = 0
launches_by_body = dict.fromkeys(BODIES, 0)
body = None
heads_per_block = 0

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
MAX_STATE = 256

_PlanInts = ctypes.c_int * 6


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch as the C side plans it: the body, its dynamic shared
    memory in bytes, its grid (x, y, z) and the heads a block owns."""
    body: str
    smem: int
    grid: tuple
    heads_per_block: int

    @classmethod
    def of(cls, ints):
        return cls(BODIES[ints[0]], ints[1], tuple(ints[2:5]), ints[5])


def plan(N, l, h, p, g, n, dtype=torch.bfloat16, aligned=True, sms=None,
         smem_optin=None):
    """The ``Plan`` that ``ssd_intra_chunk`` launches for x [N,l,h,p] and
    B, C [N,l,g,n] of ``dtype`` (``aligned``: 16-byte aligned base
    pointers and strides), on a card of ``sms`` SMs and
    ``smem_optin`` bytes of opt-in shared memory a block (default: the
    current CUDA device's): the C side's rule, ``ssd_intra_chunk_plan``."""
    if sms is None:
        sms, smem_optin = _device_limits(torch.cuda.current_device())
    ints = _PlanInts()
    if _plan_entry()(int(dtype == torch.bfloat16), int(aligned), N, l, h, p,
                     g, n, sms, smem_optin, ints):
        raise ValueError(f"ssd_intra_chunk: no plan for N,l,h,p,g,n = "
                         f"{(N, l, h, p, g, n)}")
    return Plan.of(list(ints))


@functools.lru_cache(maxsize=None)
def _device_limits(index):
    """(streaming multiprocessors, opt-in shared memory a block) of CUDA
    device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("ssd").ssd_intra_chunk_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 9
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bind_plan(lib):
    """``ssd_intra_chunk_plan`` of a loaded library, typed."""
    fn = lib.ssd_intra_chunk_plan
    fn.argtypes = [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _plan_entry():
    return _bind_plan(_build.load("ssd"))


def ssd_intra_chunk(x, dt, A, B, C, *, out_dtype=None):
    """Diagonal SSD block of each chunk.  x [N,l,h,p]; dt [N,l,h] and A [h]
    contiguous float32; B, C [N,l,g,n] in x's dtype; x, B, C may be strided
    views with a contiguous last dimension.  Returns y [N,l,h,p], contiguous,
    in ``out_dtype`` (float32 or x's dtype; default x's dtype)."""
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
    return _launch(x, dt, A, B, C, out)


def _launch(x, dt, A, B, C, out):
    """One launch: the checked inputs, ``out`` allocated."""
    global launches, body, heads_per_block
    N, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    ints = _PlanInts()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), C.data_ptr(), out.data_ptr(),
                        int(x.dtype == torch.bfloat16),
                        int(out.dtype == torch.bfloat16), N, l, h, p, g, n,
                        *x.stride()[:3], *B.stride()[:3], *C.stride()[:3],
                        ints, stream)
    if err < 0:
        raise RuntimeError("ssd_intra_chunk: the TMA tensor maps could not "
                           f"be encoded (error {err}: "
                           + ("libcuda has no cuTensorMapEncodeTiled"
                              if err == -1 else "a map was refused") + ")")
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: CUDA error "
                           f"{err} (N,l,h,p,g,n = {(N, l, h, p, g, n)}, plan "
                           f"{list(ints)})")
    done = Plan.of(list(ints))
    launches += 1
    launches_by_body[done.body] += 1
    body = done.body
    heads_per_block = done.heads_per_block
    return out
