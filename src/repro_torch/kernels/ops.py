"""Public kernel entry points (counterpart of ``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises;
a CPU tensor takes the plain PyTorch version in :mod:`.ref`.  Nothing
falls back from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd as _ssd


def flash_attention(q, k, v, *, causal: bool = True):
    """q [B,H,S,D]; k,v [B,Hk,T,D] -> [B,H,S,D].  Forward only."""
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal=causal)
    return ref.attention_ref(q, k, v, causal=causal)


def flash_attention_bshd(q, k, v, *, causal: bool = True):
    """Model layout: q [B,S,H,D]; k,v [B,T,Hk,D] -> [B,S,H,D]."""
    if q.is_cuda:
        return _fa.flash_attention_bshd(q, k, v, causal=causal)
    o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)


def rmsnorm(x, scale, eps: float = 1e-5):
    """x [..., D]; scale [D]; fp32 statistics."""
    if x.is_cuda:
        return _rn.rmsnorm(x, scale, eps)
    return ref.rmsnorm_ref(x, scale, eps)


def gated_rmsnorm(y, z, scale, eps: float = 1e-5):
    """RMSNorm(y * silu(z)); y, z [..., D]; scale [D]; fp32 statistics."""
    if y.is_cuda:
        return _rn.gated_rmsnorm(y, z, scale, eps)
    return ref.gated_rmsnorm_ref(y, z, scale, eps)


def ssd_intra_chunk(x, dt, A, B, C, *, out_dtype=None):
    """x [b,l,h,p]; dt [b,l,h]; A [h]; B,C [b,l,g,n] -> y_diag [b,l,h,p] in
    ``out_dtype`` (default x's dtype), each of the b chunks on its own."""
    if x.is_cuda:
        return _ssd.ssd_intra_chunk(x, dt, A, B, C, out_dtype=out_dtype)
    return ref.ssd_intra_chunk_ref(x, dt, A, B, C, out_dtype=out_dtype)
