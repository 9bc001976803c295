"""ctypes wrapper of the hand-written CUDA flash-attention forward
(``csrc/flash_attention.cu``), the port of
``repro/kernels/flash_attention.py:27 _flash_kernel``.

Both functions take CUDA tensors only and raise on anything the kernel does
not take; the CPU path lives in :mod:`repro_torch.kernels.ops`.  The head
dim is one of ``HEAD_DIMS``, the ones the port's configs use (16 reduced,
64, 128, 256); any other raises.  ``_plan`` picks the body and its tiling
for each call, one launch a call:

* bfloat16 at D 64, 128 and 256, every full-width main path: the Hopper
  body (TMA into a ring of mbarrier-tracked stages fed by a producer warp,
  products on wgmma), in "rows" mode (128-row tiles, each of two consumer
  warpgroups on 64 of them, one block an SM walking the tiles) or "split"
  mode (a block a 64-row tile, the two warpgroups taking alternate KV
  tiles and merging);
* bfloat16 at D 16 and 32: the mma.sync body ("mma");
* float32: the exactness path, fp32 products on the CUDA cores ("fp32").

At a B8 train shape the forward's bounds are the tensor cores' rate and
HBM (8.7 and 15.0 us for internvl2-2b's 16 heads of 128 at S = 512 on an
H100 SXM, data sheet); at a B1 prefill, latency: the serial path of the
heaviest block.  The two modes answer the two (``_plan``).  The bf16
bodies read q, k and v by TMA or 16-byte copies, so their base pointers
must be 16-byte aligned and their (batch, seq, head) strides multiples of
8 elements.  There is no fallback: a failed build, a tensor map that
cannot be encoded or a refused launch raises.  There is no backward: with
grad enabled, inputs that require grad raise (``kernels.ops`` is the
differentiable route).  ``launches`` counts the kernel launches made
through this module.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, _guard

launches = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# The plan's modes, by their numbers in the C entry point.
MODES = {"fp32": 0, "mma": 1, "rows": 2, "split": 3}
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the body and its tiling.  ``block_m`` query rows and
    ``block_n`` keys a tile, ``stages`` of the K/V ring, ``threads`` a
    block, ``smem`` bytes of dynamic shared memory, ``grid`` (x, y, z)."""
    mode: str
    block_m: int
    block_n: int
    stages: int
    threads: int
    smem: int
    grid: tuple


def _wgmma_tile(D, split):
    """(block_m, block_n, stages, smem) of the wgmma body, as
    ``WgTile<D, SPLIT>`` in the source: Q, then the ring of K and V stages,
    1024 bytes of alignment slack and 128 of barriers."""
    block_m = 64 if split else 128
    block_n = 64 if split or D > 128 else 128
    stages = (2 if D > 128 else 4) if split else (2 if D > 128 else 3)
    smem = block_m * D * 2 + stages * 2 * block_n * D * 2 + 1024 + 128
    return block_m, block_n, stages, smem


@functools.lru_cache(maxsize=4096)
def _plan(B, H, Hk, S, T, D, dtype=torch.bfloat16, sms=H100_SMS, mode=None):
    """The launch of one call (``Plan``), deterministic in its arguments;
    ``mode`` ("rows" or "split") overrides the rule below for the wgmma
    body, to time one mode against the other.

    float32 takes the fp32 body (32 query rows a block, grid (tiles, H,
    B)); bfloat16 at D 16 and 32 the mma.sync body (64 rows, grid (H, B,
    tiles)).  bfloat16 at D 64, 128 and 256 takes the wgmma body in one of
    two modes, by the number of 128-row work tiles, B H ceil(S / 128):

    * "rows" when they fill the card's ``sms`` at least once: one block
      an SM (grid (min(tiles, sms), 1, 1)), each walking the work tiles
      heaviest first, with each consumer warpgroup on 64 of a tile's 128
      rows.  The producer loads the next tile's Q and KV while the
      consumers finish the current one, and a KV tile serves 128 rows.
    * "split" otherwise (the B1 prefills and the smaller train steps):
      64-row tiles, a block each (grid (tiles, 1, 1)), so twice the blocks
      of rows mode; the two consumer warpgroups of a block share out its
      KV tiles and merge, halving the serial path that sets the time
      below a wave.

    On an H100 (NVIDIA H100 80GB HBM3, 700 W) the two modes came within
    5% of each other at 128 work tiles, rows ahead from 192 up and split
    ahead up to 80 (chip_smoke.py phase 3 times both near the rule;
    PERF.md).  T does not enter the rule: causal tiles past the diagonal
    are not visited, and a full T adds the same KV tiles to every block."""
    if dtype == torch.float32:
        smem = ((32 + 2 * 64) * (D + 1) + 32 * (64 + 1)) * 4
        return Plan("fp32", 32, 64, 1, 128, smem, (-(-S // 32), H, B))
    if D <= 32:
        smem = (64 + 4 * 128) * (D + 8) * 2
        return Plan("mma", 64, 64, 2, 256, smem, (H, B, -(-S // 64)))
    split = (B * H * -(-S // 128) < sms if mode is None
             else mode == "split")
    block_m, block_n, stages, smem = _wgmma_tile(D, split)
    work = B * H * -(-S // block_m)
    return Plan("split" if split else "rows", block_m, block_n, stages, 384,
                smem, (work if split else min(work, sms), 1, 1))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float] + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
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
    plan = _plan(B, H, Hk, S, T, D, q.dtype, _sm_count(q.device.index))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), int(q.dtype == torch.bfloat16),
                        B, H, Hk, S, T, D, *[s for t in strides for s in t],
                        float(scale), int(causal), MODES[plan.mode],
                        plan.block_m, plan.block_n, plan.stages,
                        plan.threads, plan.smem, *plan.grid, stream)
    if err < 0:
        raise RuntimeError("flash_attention: the TMA tensor maps could not "
                           f"be encoded (error {err}: "
                           + ("libcuda has no cuTensorMapEncodeTiled"
                              if err == -1 else "a map was refused") + ")")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} ({plan})")
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
