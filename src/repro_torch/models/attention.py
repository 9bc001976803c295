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

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope_bshd, rmsnorm
from repro_torch.models.perf_flags import current as _perf
from repro_torch.models.sharding_hints import Relayout, hint_mesh, reshape

F32 = torch.float32
NEG_INF = -1e30


def _attend_block(qc, k, v, q_pos, kv_pos, *, causal, window, kv_valid_len,
                  softcap, scale, reduce=None):
    """qc [B,C,Hk,G,D]; k,v [B,T,Hk,D]; q_pos [C] or [B,C]; kv_pos [T]
    (negative for the banded path's front padding, always masked);
    kv_valid_len None or [B].  Returns [B,C,Hk,G,D].  ``reduce(t, op)``,
    where given, all-reduces ``t`` ("max" or "sum") over the devices that
    share out the keys: the softmax then runs over all of them, and the
    devices' parts of the output are summed.  That path spells the softmax
    out; without ``reduce`` it stays ``torch.softmax``, so that the
    one-card path keeps its numerics (a test ties the two)."""
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
    if reduce is None:
        weights = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhgct,bthd->bchgd", weights, v)
    p = torch.exp(scores - reduce(scores.amax(-1, keepdim=True), "max"))
    weights = (p / reduce(p.sum(-1, keepdim=True), "sum")).to(v.dtype)
    return reduce(torch.einsum("bhgct,bthd->bchgd", weights, v), "sum")


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
    A ``DTensor`` q in a sharding-hint context with a mesh runs on each
    device's share (:func:`_attention_on_shards`).
    """
    kw = dict(causal=causal, window=window, softcap=softcap, chunk=chunk,
              band=(banded and window is not None and kv_valid_len is None
                    and q.shape[1] > chunk))
    shares = _shard_layout(q, k)
    if shares is not None:
        return _attention_on_shards(q, k, v, q_offset, kv_valid_len, shares,
                                    **kw)
    return _chunked(q, k, v, q_offset, kv_valid_len, **kw)


def _chunked(q, k, v, q_offset, kv_valid_len, *, causal, window, softcap,
             chunk, band, kv_start=0, reduce=None):
    """``chunked_attention`` with the band chosen (``band``; it follows an
    int ``q_offset``), over keys at positions ``kv_start`` on; ``reduce``
    as ``_attend_block``'s."""
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

    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              reduce=reduce)
    if band:
        wb = chunk + -(-window // chunk) * chunk
        end = q_offset + -(-Sq // chunk) * chunk
        pad = (0, 0, 0, 0, wb - chunk, max(0, end - Skv))
        k_pad, v_pad = F.pad(k, pad), F.pad(v, pad)
    else:
        kv_pos = torch.arange(kv_start, kv_start + Skv, device=dev)
    outs = []
    for start in range(0, Sq, chunk):
        qc = qg[:, start:start + chunk]
        ar = torch.arange(start, start + qc.shape[1], device=dev)
        q_pos = q_off[:, None] + ar if q_off.dim() == 1 else q_off + ar
        kc, vc = k, v
        if band:
            # band element j holds key position s + j - (wb - chunk)
            s = q_offset + start
            kc, vc = k_pad[:, s:s + wb], v_pad[:, s:s + wb]
            kv_pos = torch.arange(s - (wb - chunk), s + chunk, device=dev)
        outs.append(_attend_block(qc, kc, vc, q_pos, kv_pos,
                                  kv_valid_len=kvl, **kw))
    return reshape(torch.cat(outs, dim=1), B, Sq, H, v.shape[-1])


class _Shares(NamedTuple):
    """How :func:`_attention_on_shards` shares one attention call out over
    a mesh (:func:`_shard_layout` decides it): placements, one per mesh
    dim, of each ``local_map`` input and gradient, and what each device
    does to its share."""
    mesh: object
    tp: int             # the tensor axis's mesh dim
    q: tuple            # q's, in, and the output's
    q_grad: tuple       # q's gradient out of the map
    kv: tuple           # K's and V's, in
    kv_grad: tuple      # their gradients out of the map
    kv_back: tuple      # their gradients as handed back to the projections
    per_row: tuple      # a [B] ``q_offset``'s or ``kv_valid_len``'s
    pick_kv: bool       # pick q's heads' KV heads out of the whole K and V
    rows: bool          # take a contiguous 1 / n of the query rows
    key_dims: tuple     # the mesh dims that share out the keys


def _shard_layout(q, k):
    """The :class:`_Shares` of an attention call where ``q`` is a
    ``DTensor`` in a sharding-hint context with a mesh.  The batch shards
    over the FSDP axes where it divides them; a decode cache's time axis
    keeps the dims that shard it (context-parallel decode).  The tensor
    axis, of n devices, splits the first of:

    * a decode cache's time axis, where it shards it (the
      ``decode_cache_seq_shard`` PerfFlag): each device its keys, the
      softmax's max and sums all-reduced;
    * the batch, where n divides a data device's rows and q's heads do not
      lie split over it already: no K or V moves, and the step's other
      products stay data parallel;
    * the query heads, where n divides them: the KV heads too where n
      divides them, else K and V whole (the small side), each device
      picking its heads' KV heads;
    * the query rows, where it does not and there is more than one: the
      reference's rule for such heads, "context-parallel ... instead"
      (``repro/launch/sharding.py:163-166``).

    The gradients of K and V where a device reads part of them, and of q
    where the keys are shared out, are partial sums; K's and V's go back
    to the projections scattered over the sequence, since DTensor would
    hand them on whole and run the projections' backward whole on every
    device of the tensor axis.  None for any other tensor, outside such a
    context, and for a decode step whose heads n does not divide and whose
    keys it does not split: its one row cannot be split, and DTensor runs
    it whole on every device of the tensor axis."""
    mesh = hint_mesh(q)
    if mesh is None:
        return None
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.launch.mesh import fsdp_axes, tp_axis
    from repro_torch.launch.sharding import _axes_or_none

    names = list(mesh.mesh_dim_names)
    tp = names.index(tp_axis(mesh))
    b_dims = [names.index(a) for a in
              _axes_or_none(mesh, q.shape[0], fsdp_axes(mesh)) or ()]
    Sq = q.shape[1]
    t_dims = [i for i, p in enumerate(getattr(k, "placements", ()))
              if Sq == 1 and isinstance(p, Shard) and p.dim == 1
              and i not in b_dims]
    n = mesh.size(tp)
    kv_tp = None
    if tp in t_dims:
        q_tp = Replicate()
    elif q.placements[tp] != Shard(2) and q.shape[0] % (n * math.prod(
            mesh.size(i) for i in b_dims)) == 0:
        q_tp = kv_tp = Shard(0)
    elif q.shape[2] % n == 0:
        q_tp = Shard(2)
        kv_tp = Shard(2) if k.shape[2] % n == 0 else None
    elif Sq > 1:
        q_tp = Shard(1)
    else:
        return None

    def lay(tp_p, time_p):
        return tuple(Shard(0) if i in b_dims else time_p if i in t_dims
                     else tp_p if i == tp else Replicate()
                     for i in range(mesh.ndim))

    return _Shares(
        mesh, tp, q=lay(q_tp, Replicate()), q_grad=lay(q_tp, Partial()),
        kv=lay(kv_tp or Replicate(), Shard(1)),
        kv_grad=lay(kv_tp or Partial(), Shard(1)),
        kv_back=lay(kv_tp or Shard(1), Shard(1)),
        per_row=lay(q_tp if q_tp == Shard(0) else Replicate(), Replicate()),
        pick_kv=q_tp == Shard(2) and kv_tp is None, rows=q_tp == Shard(1),
        key_dims=tuple(t_dims))


def _attention_on_shards(q, k, v, q_offset, kv_valid_len, shares, **kw):
    """``chunked_attention`` on each device's share (``local_map``), as
    ``shares`` (a :class:`_Shares`) lays it out, where DTensor would take
    q's [B,S,Hk,G,D] reshape whole wherever the tensor axis does not
    divide Hk, and run every head on every device of it.  Query rows split
    over n devices are padded to whole shares and cut off after.  Returns
    [B,Sq,H,Dv], laid out as q."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    s = shares
    mesh, coord = s.mesh, s.mesh.get_coordinate()
    n, r = mesh.size(s.tp), coord[s.tp]
    Sq, G = q.shape[1], q.shape[2] // k.shape[2]
    if s.rows and Sq % n:
        q = F.pad(q, (0, 0, 0, 0, 0, n - Sq % n))
    whole = (Replicate(),) * mesh.ndim

    def dtensor(t):
        return t if isinstance(t, DTensor) or not isinstance(
            t, torch.Tensor) else DTensor.from_local(t, mesh, whole,
                                                     run_check=False)

    q = Relayout.apply(q, mesh, s.q, s.q)
    k, v = (Relayout.apply(dtensor(t), mesh, s.kv, s.kv_back)
            for t in (k, v))
    args = [q, k, v, dtensor(q_offset), dtensor(kv_valid_len)]
    places = [s.q, s.kv, s.kv] + [
        None if t is None or isinstance(t, int) else s.per_row if t.dim()
        else whole for t in args[3:]]

    def reduce(t, op):
        for i in s.key_dims:
            t = funcol.all_reduce(t, op, (mesh, i))
        return funcol.wait_tensor(t)

    def attend(q, k, v, q_offset, kv_valid_len):
        if s.pick_kv:
            m = q.shape[2]
            g = math.gcd(m, G)      # a run of g query heads reads one
            heads = torch.arange(r * m, (r + 1) * m, g, device=k.device) // G
            k, v = k.index_select(2, heads), v.index_select(2, heads)
        if s.rows:
            q_offset = q_offset + r * q.shape[1]
        shard = 0
        for i in s.key_dims:
            shard = shard * mesh.size(i) + coord[i]
        return _chunked(q, k, v, q_offset, kv_valid_len,
                        kv_start=shard * k.shape[1],
                        reduce=reduce if s.key_dims else None, **kw)

    out = local_map(attend, out_placements=(s.q,),
                    in_placements=tuple(places),
                    in_grad_placements=(s.q_grad, s.kv_grad, s.kv_grad,
                                        *places[3:]),
                    device_mesh=mesh, redistribute_inputs=True)(*args)
    return out[:, :Sq] if out.shape[1] != Sq else out


def merge_heads(out):
    """The attention's output [B,S,H,Dv] as [B,S,H*Dv], the output
    projection's input.  On a mesh its batch shards over the FSDP axes and
    H*Dv over the tensor axis (where they divide), in the forward and in
    the backward, as a tensor-parallel product takes them: from rows split
    over the tensor axis, DTensor would run the product's backward whole
    on every device of it."""
    B, S = out.shape[:2]
    out = reshape(out, B, S, -1)
    mesh = hint_mesh(out)
    if mesh is None:
        return out
    from repro_torch.launch.mesh import fsdp_axes, tp_axis
    from repro_torch.launch.sharding import _axes_or_none, to_placements

    p = to_placements((_axes_or_none(mesh, B, fsdp_axes(mesh)), None,
                       _axes_or_none(mesh, out.shape[2], tp_axis(mesh))),
                      mesh)
    return Relayout.apply(out, mesh, p, p)


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
    return merge_heads(out) @ params["wo"], (k, v)


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
    return merge_heads(out) @ params["wo"], cache_k, cache_v


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
    return merge_heads(out) @ params["wo"]


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
    return merge_heads(out) @ params["wo"], (ckv, k_rope[:, :, 0])


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
