"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

These are the oracles: the CPU path of ``kernels.ops`` runs them, and
``chip_smoke.py`` and the CUDA tests hold each hand-written kernel against
them on the card.
"""
from __future__ import annotations

import torch

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
