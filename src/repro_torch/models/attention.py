"""GQA attention, global and sliding-window, with or without QKV bias,
encoder-decoder cross attention, and multi-head latent attention
(counterpart of ``repro.models.attention``).

Prefill attention of a global, uncapped layer goes to the flash kernel when
``PerfFlags.flash_kernel`` is set and the reference's gate holds;
otherwise, and for decode, it is :func:`chunked_attention` in plain
PyTorch, as the reference's is jnp.  A local (sliding-window) layer has the
reference's two paths: masked (full-length scores, the window a mask) and
banded (each query chunk reads only its band of keys), the latter under
``banded=True`` or the ``banded_local`` PerfFlag.

Cross attention (whisper's decoder over the encoder's output) is
:func:`chunked_attention` without a causal mask, as the reference's: no
flash, no RoPE, no bias.

MLA (minicpm3) never takes flash, as in the reference: prefill and
training materialize each head's key and value from the latent and run
:func:`chunked_attention` (query and key heads of 96, value heads of 64);
decode attends in the latent space (:func:`mla_decode`), its cache the
normalized latent ``ckv`` and the shared rope key ``krope``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope_bshd, rmsnorm
from repro_torch.models.perf_flags import current as _perf
from repro_torch.models.sharding_hints import reshape

F32 = torch.float32
NEG_INF = -1e30


def _attend_block(qc, k, v, q_pos, kv_pos, *, causal, window, kv_valid_len,
                  softcap, scale):
    """qc [B,C,Hk,G,D]; k,v [B,T,Hk,D]; q_pos [C] or [B,C]; kv_pos [T]
    (negative for the banded path's front padding, always masked);
    kv_valid_len None or [B].  Returns [B,C,Hk,G,D]."""
    scores = torch.einsum("bchgd,bthd->bhgct", qc.to(F32), k.to(F32)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if q_pos.dim() == 1:
        q_pos = q_pos[None]                                  # [1, C]
    mask = (kv_pos >= 0)[None, None, :]
    if causal:
        mask = mask & (kv_pos[None, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & ((q_pos[:, :, None] - kv_pos[None, None, :]) < window)
    if kv_valid_len is not None:
        mask = mask & (kv_pos[None, None, :] < kv_valid_len[:, None, None])
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgct,bthd->bchgd", weights, v)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_valid_len=None, softcap=None, chunk=1024,
                      banded=False):
    """q, k [B,S(kv),H(kv),D]; v [B,Skv,Hkv,Dv] -> [B,Sq,H,Dv] (MLA's value
    heads are narrower than its query and key heads; the scale is D's).

    Exact softmax per query chunk of ``chunk`` rows.  ``q_offset``: position
    of q[0] in the kv sequence, an int or a per-row [B] tensor (decode:
    cache_len).  ``kv_valid_len``: positions >= it are masked, an int or [B].
    ``window``: a query attends to the ``window`` positions ending at its
    own.  ``softcap``: scores become ``softcap * tanh(s / softcap)``.
    ``banded``: with a window and no ``kv_valid_len``, and more than one
    chunk, each chunk reads only its band of keys, the reference's ``Wb =
    chunk + ceil(window / chunk) * chunk`` of them from keys padded in front
    by ``Wb - chunk`` (and behind to whole chunks); exact for any window.
    """
    B, Sq, H, D = q.shape
    Hk, Skv = k.shape[2], k.shape[1]
    G = H // Hk
    scale = D ** -0.5
    dev = q.device
    qg = reshape(q, B, Sq, Hk, G, D)
    q_off = torch.as_tensor(q_offset, device=dev)
    kvl = None
    if kv_valid_len is not None:
        kvl = torch.as_tensor(kv_valid_len, device=dev).reshape(-1)

    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if banded and window is not None and kvl is None and Sq > chunk:
        wb = chunk + -(-window // chunk) * chunk
        pad = (0, 0, 0, 0, wb - chunk, (-Sq) % chunk)
        k_pad, v_pad = F.pad(k, pad), F.pad(v, pad)
    else:
        wb, kv_pos = None, torch.arange(Skv, device=dev)
    outs = []
    for start in range(0, Sq, chunk):
        qc = qg[:, start:start + chunk]
        ar = torch.arange(start, start + qc.shape[1], device=dev)
        q_pos = q_off[:, None] + ar if q_off.dim() == 1 else q_off + ar
        kc, vc = k, v
        if wb is not None:
            # band element j holds key position start + j - (wb - chunk)
            kc, vc = k_pad[:, start:start + wb], v_pad[:, start:start + wb]
            kv_pos = torch.arange(start - (wb - chunk), start + chunk,
                                  device=dev)
        outs.append(_attend_block(qc, kc, vc, q_pos, kv_pos,
                                  kv_valid_len=kvl, **kw))
    return reshape(torch.cat(outs, dim=1), B, Sq, H, v.shape[-1])


def gqa_project_qkv(params, x, n_heads, n_kv_heads, d_head):
    """The biases, where the tree has them (qwen1.5), are added after the
    product in the model dtype, as the reference does: a fused ``addmm``
    would add them in the product's fp32 epilogue and round otherwise."""
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (reshape(q, B, S, n_heads, d_head),
            reshape(k, B, S, n_kv_heads, d_head),
            reshape(v, B, S, n_kv_heads, d_head))


def _flash_applicable(cfg, local: bool, S: int) -> bool:
    """The reference's gate (attention.py:200-206): the flag is set, the
    layer is global and uncapped, and ``S`` is a multiple of
    ``min(128, S)``."""
    if not _perf().flash_kernel or local or cfg.attn_logit_softcap:
        return False
    block = min(128, S)
    return S % block == 0


def _theta(cfg, local: bool) -> float:
    """The rope base: a local layer's own where the config has one."""
    return cfg.rope_theta_local if (local and cfg.rope_theta_local) \
        else cfg.rope_theta


def gqa_attention(params, x, cfg, *, local: bool, positions, chunk=None,
                  banded=False):
    """Full-sequence (prefill) causal GQA attention, global or (``local``)
    sliding-window.  x [B,S,D] -> ([B,S,D], (k, v)).  Where flash does not
    take it, ``chunked_attention`` runs in query chunks of ``chunk or
    cfg.attn_chunk``, banded or not, as the reference's."""
    q, k, v = gqa_project_qkv(params, x, cfg.n_heads, cfg.n_kv_heads,
                              cfg.d_head)
    theta = _theta(cfg, local)
    q = apply_rope_bshd(q, positions, theta)
    k = apply_rope_bshd(k, positions, theta)
    B, S = q.shape[:2]
    if _flash_applicable(cfg, local, S):
        out = ops.flash_attention_bshd(q, k, v, causal=True)
    else:
        out = chunked_attention(
            q, k, v, causal=True, window=cfg.attn_window if local else None,
            softcap=cfg.attn_logit_softcap, chunk=chunk or cfg.attn_chunk,
            banded=banded)
    return reshape(out, B, S, -1) @ params["wo"], (k, v)


def _cache_write(cache, new, cache_len):
    """Write new [B,1,...] at time position cache_len (an int, a 0-d
    tensor for every row, as the reference's scalar, or a per-row [B]
    tensor) of cache [B,T,...], in place: the cache is the engine's
    preallocated buffer, so nothing is copied.  Returns cache.  A 0-d
    length scatters along the time axis, which a dry-run's DTensor cache
    does on each shard, with no host read of the length."""
    if isinstance(cache_len, int):
        cache[:, cache_len:cache_len + new.shape[1]] = new.to(cache.dtype)
    elif cache_len.dim() == 0:
        if _time_shards(cache):
            return _write_on_shards(cache, new, cache_len)
        idx = cache_len.to(torch.int64).reshape((1,) * new.dim())
        cache.scatter_(1, idx.expand(new.shape), new.to(cache.dtype))
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, cache_len] = new[:, 0].to(cache.dtype)
    return cache


def _time_shards(cache) -> list:
    """The mesh dims that shard the time axis of ``cache``, a ``DTensor``
    (context-parallel decode), major first; [] for any other tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(cache, DTensor):
        return []
    return [i for i, p in enumerate(cache.placements)
            if isinstance(p, Shard) and p.dim == 1]


def _write_on_shards(cache, new, cache_len):
    """The write of ``_cache_write`` into a ``DTensor`` cache whose time
    axis is sharded (the dry-run's context-parallel decode): each device
    writes the token into its own slice of time, where the position falls
    in it, and keeps its rows elsewhere (``local_map``); DTensor would
    gather the whole cache to scatter into it."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, placements = cache.device_mesh, cache.placements
    dims = _time_shards(cache)
    coord = mesh.get_coordinate()
    shard = 0
    for i in dims:
        shard = shard * mesh.size(i) + coord[i]
    whole = tuple(Replicate() if i in dims else p
                  for i, p in enumerate(placements))

    def write(c, n, length):
        T = c.shape[1]
        pos = length.to(torch.int64) - shard * T
        mine = (pos >= 0) & (pos < T)
        idx = pos.clamp(0, T - 1).reshape((1,) * n.dim()).expand(n.shape)
        return c.scatter_(1, idx, torch.where(mine, n.to(c.dtype),
                                              c.gather(1, idx)))

    return local_map(write, out_placements=(placements,),
                     in_placements=(placements, whole, (Replicate(),)
                                    * mesh.ndim),
                     device_mesh=mesh, redistribute_inputs=True)(
        cache, new, cache_len)


def _decode_positions(cache_len, device):
    if isinstance(cache_len, int):
        return torch.full((1,), cache_len, dtype=torch.int32, device=device)
    if cache_len.dim() == 0:
        return cache_len.reshape(1).to(torch.int32)            # [1]
    return cache_len[:, None].to(torch.int32)                  # [B,1]


def gqa_decode(params, x, cfg, cache_k, cache_v, cache_len, *,
               local: bool):
    """Single-token decode. x [B,1,D]; cache_[kv] [B,T,Hk,D], written in
    place at ``cache_len`` (an int, or a per-row [B] tensor for slots of
    ragged length).  A local layer's cache is full length too, as the
    reference's; its window is a mask.  Returns (out, cache_k, cache_v)."""
    q, k, v = gqa_project_qkv(params, x, cfg.n_heads, cfg.n_kv_heads,
                              cfg.d_head)
    theta = _theta(cfg, local)
    pos = _decode_positions(cache_len, x.device)
    q = apply_rope_bshd(q, pos, theta)
    k = apply_rope_bshd(k, pos, theta)
    cache_k = _cache_write(cache_k, k, cache_len)
    cache_v = _cache_write(cache_v, v, cache_len)
    out = chunked_attention(q, cache_k, cache_v, causal=True,
                            window=cfg.attn_window if local else None,
                            q_offset=cache_len, kv_valid_len=cache_len + 1,
                            softcap=cfg.attn_logit_softcap)
    B = x.shape[0]
    return reshape(out, B, 1, -1) @ params["wo"], cache_k, cache_v


# --------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# --------------------------------------------------------------------------


def cross_attention(params, x, enc_k, enc_v, cfg):
    """x [B,S,D] attends, without a causal mask, over the encoder's keys
    and values enc_k, enc_v [B,S_enc,Hk,Dh] (``cross_kv``'s, or the cache's
    ``xk`` and ``xv``)."""
    B, S, _ = x.shape
    q = reshape(x @ params["wq"], B, S, cfg.n_heads, cfg.d_head)
    out = chunked_attention(q, enc_k, enc_v, causal=False,
                            chunk=cfg.attn_chunk)
    return reshape(out, B, S, -1) @ params["wo"]


def cross_kv(params, enc_out, n_kv_heads, d_head):
    """The keys and values of the encoder's output enc_out [B,S_enc,D],
    each [B,S_enc,n_kv_heads,d_head]."""
    B, S, _ = enc_out.shape
    k = reshape(enc_out @ params["wk"], B, S, n_kv_heads, d_head)
    v = reshape(enc_out @ params["wv"], B, S, n_kv_heads, d_head)
    return k, v


# --------------------------------------------------------------------------
# MLA (multi-head latent attention)
# --------------------------------------------------------------------------


def _mla_qkv_full(params, x, cfg):
    """The naive MLA path (train and prefill): each head's key and value
    materialized from the latent.  Returns (q_nope, q_rope, k_nope,
    k_rope [B,S,1,rope], v, ckv)."""
    spec = cfg.mla
    B, S, _ = x.shape
    H, nope = cfg.n_heads, spec.qk_nope_head_dim
    cq = rmsnorm({"scale": params["q_norm"]}, x @ params["wq_a"],
                 cfg.norm_eps)
    q = reshape(cq @ params["wq_b"], B, S, H, spec.qk_head_dim)
    q_nope, q_rope = q.split([nope, spec.qk_rope_head_dim], dim=-1)
    ckv, k_rope = (x @ params["wkv_a"]).split(
        [spec.kv_lora_rank, spec.qk_rope_head_dim], dim=-1)
    # a strided view (rows rank + rope apart), which the norm kernel reads
    ckv = rmsnorm({"scale": params["kv_norm"]}, ckv, cfg.norm_eps)
    kv = reshape(ckv @ params["wkv_b"], B, S, H, nope + spec.v_head_dim)
    k_nope, v = kv.split([nope, spec.v_head_dim], dim=-1)
    return q_nope, q_rope, k_nope, k_rope[:, :, None, :], v, ckv


def mla_attention(params, x, cfg, *, positions):
    """MLA for train and prefill: rope on the rope halves only, the one
    rope key broadcast to every head.  x [B,S,D] -> ([B,S,D], (ckv
    [B,S,rank], k_rope [B,S,rope])) for the cache."""
    spec = cfg.mla
    B, S, _ = x.shape
    q_nope, q_rope, k_nope, k_rope, v, ckv = _mla_qkv_full(params, x, cfg)
    q_rope = apply_rope_bshd(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope_bshd(k_rope, positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(
        *k_nope.shape[:-1], spec.qk_rope_head_dim)], dim=-1)
    out = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return reshape(out, B, S, -1) @ params["wo"], (ckv, k_rope[:, :, 0])


def mla_decode(params, x, cfg, cache_ckv, cache_krope, cache_len):
    """Absorbed MLA decode (the DeepSeek-V2 trick): ``wkv_b``'s key half
    folds into the query and its value half is applied after the softmax,
    so the step attends over the latent cache.  x [B,1,D]; cache_ckv
    [B,T,rank] and cache_krope [B,T,rope], written in place at
    ``cache_len`` (an int or a per-row [B] tensor).  The scores are taken
    in fp32 (the reference's ``preferred_element_type``).  Returns (out,
    cache_ckv, cache_krope)."""
    spec = cfg.mla
    B, H = x.shape[0], cfg.n_heads
    nope, rank = spec.qk_nope_head_dim, spec.kv_lora_rank
    cq = rmsnorm({"scale": params["q_norm"]}, x @ params["wq_a"],
                 cfg.norm_eps)
    q = reshape(cq @ params["wq_b"], B, 1, H, spec.qk_head_dim)
    q_nope, q_rope = q.split([nope, spec.qk_rope_head_dim], dim=-1)
    pos = _decode_positions(cache_len, x.device)
    q_rope = apply_rope_bshd(q_rope, pos, cfg.rope_theta)
    ckv_new, krope_new = (x @ params["wkv_a"]).split(
        [rank, spec.qk_rope_head_dim], dim=-1)
    ckv_new = rmsnorm({"scale": params["kv_norm"]}, ckv_new, cfg.norm_eps)
    krope_new = apply_rope_bshd(krope_new[:, :, None, :], pos,
                                cfg.rope_theta)[:, :, 0, :]
    cache_ckv = _cache_write(cache_ckv, ckv_new, cache_len)
    cache_krope = _cache_write(cache_krope, krope_new, cache_len)

    wkv_b = reshape(params["wkv_b"], rank, H, nope + spec.v_head_dim)
    w_uk, w_uv = wkv_b[:, :, :nope], wkv_b[:, :, nope:]
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
    scores = (torch.einsum("bqhr,btr->bhqt", q_lat.to(F32),
                           cache_ckv.to(F32))
              + torch.einsum("bqhe,bte->bhqt", q_rope.to(F32),
                             cache_krope.to(F32))) * spec.qk_head_dim ** -0.5
    kv_pos = torch.arange(cache_ckv.shape[1], device=x.device)
    if isinstance(cache_len, int) or cache_len.dim() == 0:
        valid = (kv_pos <= cache_len)[None, None, None, :]
    else:
        valid = (kv_pos[None, :] <= cache_len[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1).to(cache_ckv.dtype)
    out_lat = torch.einsum("bhqt,btr->bqhr", weights, cache_ckv)
    out = torch.einsum("bqhr,rhv->bqhv", out_lat, w_uv)
    return reshape(out, B, 1, -1) @ params["wo"], cache_ckv, cache_krope
