"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

These are the oracles: the CPU path of ``kernels.ops`` runs them, and
``chip_smoke.py`` and the CUDA tests hold each hand-written kernel against
them on the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q [B,H,S,D]; k,v [B,Hk,T,D] (GQA: H = G*Hk).  Full softmax."""
    B, H, S, D = q.shape
    Hk, T = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q.reshape(B, Hk, G, S, D)
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhgsd,bhtd->bhgst", qg.to(F32), k.to(F32)) * scale
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgst,bhtd->bhgsd", w.to(v.dtype), v)
    return o.reshape(B, H, S, D)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """x [..., D]; scale [D].  fp32 statistics, scale applied in fp32."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def gated_rmsnorm_ref(y, z, scale, eps: float = 1e-5):
    """Mamba-2 gated norm: RMSNorm(y * silu(z)), fp32 statistics, the scale
    applied in fp32, cast to y's dtype."""
    h = y.to(F32) * F.silu(z.to(F32))
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps) * scale.to(F32)).to(y.dtype)


class _CumsumCPU(torch.autograd.Function):
    """Left-to-right float32 cumsum of a CPU tensor along ``dim``: numpy's
    float32 accumulate (PyTorch's CPU kernel accumulates in double)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return torch.from_numpy(np.cumsum(x.detach().numpy(), axis=dim,
                                          dtype=np.float32))

    @staticmethod
    def backward(ctx, g):
        return g.flip(ctx.dim).cumsum(ctx.dim).flip(ctx.dim), None


def cumsum_f32(x, dim):
    """float32 cumsum accumulated in float32, as the reference's
    ``jnp.cumsum`` of float32, and in one order on every device: left to
    right, each sum rounded to float32.

    The order matters: the decays are exp of differences of these sums,
    and an fp32 cumsum in another order (a tree scan) moves the SSD block
    of a 256-token chunk by up to twice its tolerance.  The SSD kernel
    (``csrc/ssd.cu``) scans left to right too, so that it and this plain
    version agree bit for bit.  On the card, ATen scans a dimension that
    is not the innermost with one thread per column, left to right, but
    the innermost one with a tree and a 1-D tensor with CUB: a trailing
    dimension of two columns keeps every call on the first.  On the CPU
    numpy's float32 accumulate does it.  A tensor on any other device (the
    meta device, a dry-run's shards) takes the card's route: it yields the
    shape and dtype, and its ops are the ones the card runs."""
    x = x.to(F32)
    dim = dim % x.dim()
    if x.device.type != "cpu":
        return torch.cumsum(x.unsqueeze(-1).expand(*x.shape, 2), dim)[..., 0]
    return _CumsumCPU.apply(x, dim)


def segsum(x):
    """x [..., L] -> [..., L, L]: entry (i, j) is sum_{j<k<=i} x_k for
    j <= i and -inf above the diagonal (the counterpart of
    ``repro.models.ssm._segsum``).  The mask is a selection, so exp of it
    is exactly 0 there, never inf * 0."""
    L = x.shape[-1]
    cs = cumsum_f32(x, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(L, device=x.device)
    return torch.where(idx[:, None] >= idx[None, :], diff,
                       torch.full_like(diff, float("-inf")))


def ssd_intra_chunk_ref(x, dt, A, B, C, *, out_dtype=None):
    """Intra-chunk SSD (each chunk's diagonal block).

    x [b,l,h,p]; dt [b,l,h] (>0); A [h] (<0); B,C [b,l,g,n].  Returns
    y_diag [b,l,h,p] = sum_{j<=i} C_i.B_j exp(sum_{j<k<=i} dtA) x_j dt_j,
    computed in fp32 and cast to ``out_dtype`` (default x's dtype).
    """
    b, l, h, p = x.shape
    g = B.shape[2]
    hg = h // g
    dtA = dt.to(F32) * A.to(F32)[None, None, :]              # [b,l,h]
    L = torch.exp(segsum(dtA.transpose(1, 2)))               # [b,h,i,j]
    cb = torch.einsum("bign,bjgn->bgij", C.to(F32), B.to(F32))
    w = cb[:, :, None] * L.reshape(b, g, hg, l, l)           # [b,g,hg,i,j]
    xdt = x.to(F32) * dt.to(F32)[..., None]                  # [b,l,h,p]
    y = torch.einsum("bghij,bjghp->bighp", w, xdt.reshape(b, l, g, hg, p))
    return y.reshape(b, l, h, p).to(out_dtype or x.dtype)
