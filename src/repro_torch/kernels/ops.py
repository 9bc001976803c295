"""Public kernel entry points (counterpart of ``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises;
a CPU tensor takes the plain PyTorch version in :mod:`.ref`.  Nothing
falls back from one to the other.

Every entry point is differentiable on the card, as the reference's are
(flash attention through ``repro/kernels/ops.py:32-57``'s ``custom_vjp``,
the norms and the SSD block as jnp): when grad is enabled and an input
requires grad, the call goes through an ``autograd.Function`` whose
forward is the kernel and whose backward recomputes the plain version and
takes its vector-Jacobian product, as ``_fad_bwd`` does.  The JAX package
has no backward kernel, and neither has the port.  Any other call (every
call of a serve) goes to the kernel's wrapper directly, with no Function
in between.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd as _ssd


def _on_card(t) -> bool:
    """Whether ``t`` takes the kernel route (a test stands in for it)."""
    return t.is_cuda


def _kernel_route(name: str, kernel, plain):
    """An ``autograd.Function`` called ``name``: forward ``kernel(*tensors,
    **kw)`` (the wrapper, which raises under autograd; grad is off inside
    ``forward``), backward the vector-Jacobian product of ``plain(*tensors,
    **kw)`` recomputed from the saved inputs.  Each input's gradient comes
    in that input's own dtype; the keyword arguments get none.  ``kernel``
    stays on the class, for the calls that need no Function."""

    def forward(ctx, kw, *tensors):
        ctx.kw = kw
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, **kw)

    def backward(ctx, grad_out):
        tensors = ctx.saved_tensors
        wanted = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w)
                      for t, w in zip(tensors, wanted)]
            out = plain(*inputs, **ctx.kw)
            grads = iter(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], grad_out))
        return (None, *(next(grads).to(t.dtype) if w else None
                        for t, w in zip(tensors, wanted)))

    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(forward),
                 "backward": staticmethod(backward),
                 "kernel": staticmethod(kernel)})


def _attention_bshd_ref(q, k, v, *, causal=True):
    o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)


# The wrappers are looked up at call time, so a test can stand in for them.
FlashAttention = _kernel_route(
    "FlashAttention", lambda *a, **k: _fa.flash_attention(*a, **k),
    ref.attention_ref)
FlashAttentionBSHD = _kernel_route(
    "FlashAttentionBSHD", lambda *a, **k: _fa.flash_attention_bshd(*a, **k),
    _attention_bshd_ref)
RMSNorm = _kernel_route(
    "RMSNorm", lambda *a, **k: _rn.rmsnorm(*a, **k), ref.rmsnorm_ref)
GatedRMSNorm = _kernel_route(
    "GatedRMSNorm", lambda *a, **k: _rn.gated_rmsnorm(*a, **k),
    ref.gated_rmsnorm_ref)
SSDIntraChunk = _kernel_route(
    "SSDIntraChunk", lambda *a, **k: _ssd.ssd_intra_chunk(*a, **k),
    ref.ssd_intra_chunk_ref)


def _call(route, tensors, kw):
    """The kernel directly, or through ``route`` when autograd records."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return route.apply(kw, *tensors)
    return route.kernel(*tensors, **kw)


def flash_attention(q, k, v, *, causal: bool = True):
    """q [B,H,S,D]; k,v [B,Hk,T,D] -> [B,H,S,D]."""
    if _on_card(q):
        return _call(FlashAttention, (q, k, v), dict(causal=causal))
    return ref.attention_ref(q, k, v, causal=causal)


def flash_attention_bshd(q, k, v, *, causal: bool = True):
    """Model layout: q [B,S,H,D]; k,v [B,T,Hk,D] -> [B,S,H,D]."""
    if _on_card(q):
        return _call(FlashAttentionBSHD, (q, k, v), dict(causal=causal))
    return _attention_bshd_ref(q, k, v, causal=causal)


def rmsnorm(x, scale, eps: float = 1e-5):
    """x [..., D]; scale [D]; fp32 statistics."""
    if _on_card(x):
        return _call(RMSNorm, (x, scale), dict(eps=eps))
    return ref.rmsnorm_ref(x, scale, eps)


def gated_rmsnorm(y, z, scale, eps: float = 1e-5):
    """RMSNorm(y * silu(z)); y, z [..., D]; scale [D]; fp32 statistics."""
    if _on_card(y):
        return _call(GatedRMSNorm, (y, z, scale), dict(eps=eps))
    return ref.gated_rmsnorm_ref(y, z, scale, eps)


def ssd_intra_chunk(x, dt, A, B, C, *, out_dtype=None):
    """x [b,l,h,p]; dt [b,l,h]; A [h]; B,C [b,l,g,n] -> y_diag [b,l,h,p] in
    ``out_dtype`` (default x's dtype), each of the b chunks on its own."""
    if _on_card(x):
        return _call(SSDIntraChunk, (x, dt, A, B, C),
                     dict(out_dtype=out_dtype))
    return ref.ssd_intra_chunk_ref(x, dt, A, B, C, out_dtype=out_dtype)
