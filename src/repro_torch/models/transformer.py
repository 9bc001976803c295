"""Model assembly: dense, Mamba-2, MoE, hybrid, vision-language and
encoder-decoder stacks (counterpart of ``repro.models.transformer``).

A model is ``n_periods`` copies of a period of layers plus a remainder.
Each layer's mixer is the one ``cfg.layer_pattern`` names for its slot:
global GQA attention (``"attn"``), sliding-window GQA attention
(``"attn_local"``, gemma3's 5 of every 6) or the Mamba-2 mixer
(``"ssm"``), so one period may mix them, as jamba's 1:7 attention:Mamba
period does.  An attention layer of a config with an ``MLASpec``
(minicpm3) is multi-head latent attention instead, and one of a config
with ``qkv_bias`` (qwen1.5) adds biases to its projections.  Its FFN is
the one ``cfg.mlp_pattern`` names for its slot:
the mixture of experts (``models/moe.py``) for ``"moe"``, else the dense
MLP of ``cfg.act``; a non-MoE block whose ``mlp`` is empty (``d_ff`` 0, as
mamba2-370m) has no FFN and never reads ``ln2``.

Two stub frontends feed precomputed embeddings ``frontend_embeds``
[B,N,d]: ``patch_stub`` (internvl2) prepends N patches, cast to the
embedding's dtype, to the tokens, and the loss pads its labels with N
entries of -1 in front; ``audio_stub`` (whisper) gives N frames to an
encoder (``encode``: ``cfg.encoder.n_layers`` blocks of full attention
without positions and a GELU MLP, then ``enc_norm``), and every decoder
block then runs ``ln_x`` and cross attention over the encoder's output
between its self-attention and its FFN.  The frames must come in the
encoder's weight dtype: the reference's scan refuses others, and they are
never cast down.

The parameter and cache trees keep the reference's layout exactly, so
that the bridge and the serving splice read them the same way::

    params = {"embed": [V,d], "blocks": {str(p): tree[n_periods, ...]},
              "rem": {str(i): tree}, "final_norm": {"scale": [d]},
              "enc_blocks": tree[enc.n_layers, ...],  # encoder-decoder
              "enc_norm": {"scale": [d]}}             # only
    caches = {"blocks": {str(p): leaves[n_periods, B, ...]},
              "rem": {str(i): leaves[B, ...]}}

with cache leaves ``k``, ``v`` [B,T,Hk,Dh] in the model dtype for an
attention layer (``ckv`` [B,T,kv_lora_rank] and ``krope``
[B,T,qk_rope_head_dim] for an MLA layer), and ``conv`` [B,K-1,C] in the
model dtype and ``ssd`` [B,G,HG,P,N] in float32 for a Mamba-2 layer; an
encoder-decoder layer adds the encoder's keys and values ``xk``, ``xv``
[B,S_enc,enc.n_kv_heads,d // enc.n_heads], which have no time axis to
grow.

The reference scans over the period axis; here a Python loop takes layer
``i`` as a view ``leaf[i]`` of each stacked leaf.  Decode writes the cache
in place and returns the same tree.

When autograd records (a train step), each period of the stacked blocks is
rematerialized as ``cfg.remat`` says, as the reference's ``_remat``: its
activations are recomputed in the backward, kernels included, so a train
step under ``"full"`` or ``"dots"`` launches every block-level forward
kernel twice.  The remainder layers, the final norm, the encoder and the
serve paths are never rematerialized.

With the ``bf16_grads`` PerfFlag each block's output is the identity in
the forward and rounds its cotangent to bfloat16 in the backward (the
reference's ``_bf16_cotangent``), in the periods, their recompute and the
remainder layers alike; the encoder's blocks are not wrapped.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Leaf, embed, mlp, rmsnorm, zeros
from repro_torch.models.perf_flags import current as _perf
from repro_torch.models.perf_flags import perf_flags
from repro_torch.models.sharding_hints import (current_hints, hint_context,
                                               reshape, shard_hint)

F32 = torch.float32


def model_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


FRONTENDS = ("none", "patch_stub", "audio_stub")


def check_supported(cfg):
    """The port's model covers every family of the repo: layers of global
    or sliding-window attention (logits capped or not, with or without QKV
    bias, or MLA) or Mamba-2 mixers in any pattern, with SwiGLU, GeGLU or
    GELU dense FFNs, and SwiGLU or GELU experts (the acts the reference's
    ``moe_ffn`` takes); the patch frontend, and the audio frontend with its
    encoder.  Raise for any other act or frontend."""
    acts = ("swiglu", "gelu") if "moe" in cfg.mlp_pattern \
        else ("swiglu", "geglu", "gelu")
    missing = [name for name, present in (
        ("act " + cfg.act, cfg.act not in acts),
        ("frontend " + cfg.frontend, cfg.frontend not in FRONTENDS),
        ("frontend audio_stub without an encoder",
         cfg.frontend == "audio_stub" and cfg.encoder is None)) if present]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not support {', '.join(missing)}")


# ==========================================================================
# Parameters
# ==========================================================================


def _attention_spec(d, H, Hk, Dh, bias=False):
    """The reference's ``init_attention``."""
    hd, kvd = H * Dh, Hk * Dh
    spec = {"wq": Leaf((d, hd), d ** -0.5), "wk": Leaf((d, kvd), d ** -0.5),
            "wv": Leaf((d, kvd), d ** -0.5), "wo": Leaf((hd, d), hd ** -0.5)}
    if bias:
        spec.update(bq=Leaf((hd,), fixed=zeros), bk=Leaf((kvd,), fixed=zeros),
                    bv=Leaf((kvd,), fixed=zeros))
    return spec


def _mlp_spec(d, d_ff, act):
    """The reference's ``init_mlp``."""
    spec = {"w1": Leaf((d, d_ff), d ** -0.5),
            "w2": Leaf((d_ff, d), d_ff ** -0.5)}
    if act in ("swiglu", "geglu"):
        spec["w3"] = Leaf((d, d_ff), d ** -0.5)
    return spec


def _block_spec(cfg, kind, mlp_kind):
    d = cfg.d_model
    spec = {"ln1": {"scale": Leaf((d,))},
            "ln2": {"scale": Leaf((d,))}}
    if kind == "ssm":
        spec["mixer"] = ssm_mod.mamba2_spec(d, cfg.ssm)
    elif cfg.mla is not None:
        spec["mixer"] = _mla_spec(d, cfg.n_heads, cfg.mla)
    else:
        spec["mixer"] = _attention_spec(d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.d_head, cfg.qkv_bias)
    if cfg.is_encdec:
        spec["ln_x"] = {"scale": Leaf((d,))}
        spec["xattn"] = _attention_spec(d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.d_head)
    spec["mlp"] = {}    # attention-free SSM blocks (mamba2) have no FFN
    if mlp_kind == "moe":
        spec["mlp"] = moe_mod.moe_spec(d, cfg.moe)
    elif cfg.d_ff > 0:
        spec["mlp"] = _mlp_spec(d, cfg.d_ff, cfg.act)
    return spec


def _enc_block_spec(cfg):
    """The reference's ``_init_enc_block``: heads of d // enc.n_heads, no
    bias, a GELU MLP of ``enc.d_ff``."""
    enc, d = cfg.encoder, cfg.d_model
    return {"ln1": {"scale": Leaf((d,))}, "ln2": {"scale": Leaf((d,))},
            "mixer": _attention_spec(d, enc.n_heads, enc.n_kv_heads,
                                     d // enc.n_heads),
            "mlp": _mlp_spec(d, enc.d_ff, "gelu")}


def _mla_spec(d, H, mla):
    """The reference's ``init_mla``: the latent projections and their
    norms (ones), and ``wo`` from the H value heads."""
    qk, vd = mla.qk_head_dim, mla.v_head_dim
    rank = mla.kv_lora_rank
    return {"wq_a": Leaf((d, mla.q_lora_rank), d ** -0.5),
            "q_norm": Leaf((mla.q_lora_rank,)),
            "wq_b": Leaf((mla.q_lora_rank, H * qk), mla.q_lora_rank ** -0.5),
            "wkv_a": Leaf((d, rank + mla.qk_rope_head_dim), d ** -0.5),
            "kv_norm": Leaf((rank,)),
            "wkv_b": Leaf((rank, H * (mla.qk_nope_head_dim + vd)),
                          rank ** -0.5),
            "wo": Leaf((H * vd, d), (H * vd) ** -0.5)}


def _tree_map(fn, spec):
    if isinstance(spec, dict):
        return {k: _tree_map(fn, v) for k, v in spec.items()}
    return fn(spec)


def leaves(tree):
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def _stacked(spec, n):
    return _tree_map(lambda leaf: leaf._replace(shape=(n,) + leaf.shape),
                     spec)


def param_spec(cfg):
    """The parameter tree as :class:`~repro_torch.models.layers.Leaf`
    leaves: shape, init kind and dtype, as ``init_params`` of the reference
    makes each."""
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    spec = {"embed": Leaf((V, d), d ** -0.5)}
    spec["blocks"] = {
        str(p): _stacked(_block_spec(cfg, cfg.layer_pattern[p],
                                     cfg.mlp_pattern[p]), cfg.n_periods)
        for p in range(cfg.period)}
    spec["rem"] = {str(i): _block_spec(cfg, cfg.layer_pattern[i],
                                       cfg.mlp_pattern[i])
                   for i in range(cfg.n_remainder)}
    spec["final_norm"] = {"scale": Leaf((d,))}
    if not cfg.tie_embeddings:
        spec["lm_head"] = Leaf((d, V), d ** -0.5)
    if cfg.is_encdec:
        spec["enc_blocks"] = _stacked(_enc_block_spec(cfg),
                                      cfg.encoder.n_layers)
        spec["enc_norm"] = {"scale": Leaf((d,))}
    return spec


def leaf_dtype(leaf: Leaf, cfg, dtype=None) -> torch.dtype:
    """float32 for an fp32 leaf, else ``dtype`` or the model dtype."""
    return F32 if leaf.fp32 else dtype or model_dtype(cfg)


# Elements a draw on the card takes at a time: 512 MiB of float32.
DRAW_SLICE = 1 << 27


def _draw(out, std, generator, slice_elems):
    """Fill ``out`` with a normal truncated at two std, times ``std``,
    drawn in float32 on the generator's device in slices of at most
    ``slice_elems`` elements of ``out``'s flat order, each cast into its
    slice of ``out`` as it is drawn."""
    flat = out.view(-1)
    for start in range(0, flat.numel(), slice_elems):
        part = flat[start:start + slice_elems]
        t = torch.empty(part.shape, dtype=F32, device=generator.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        part.copy_(t.mul_(std))


def init_params(cfg, generator: torch.Generator, *, device="cuda",
                dtype=None):
    """Random parameters on ``device``: each leaf in its spec dtype (the
    model dtype, or ``dtype`` where given, except float32 leaves).

    With a CPU ``generator`` (what the entry points pass) each leaf is
    drawn whole in float32 on the host and then moved, so one seed gives
    the same weights on every device.  With a generator on ``device``
    itself the draw happens there, in place, in slices of ``DRAW_SLICE``
    elements: no leaf exists in float32 as a whole, on the card or on the
    host, so that 48 GB of bf16 weights (jamba at full width, 5 layers)
    are drawn on one card in about a second.  Its values differ from the
    CPU draw of the same seed.  Only leaves with a ``std`` draw; the others
    are fixed, as in the reference.
    """
    dev = resolve_device(device)
    on_host = generator.device.type == "cpu"
    if not on_host and (generator.device.type != dev.type or (
            dev.index is not None and generator.device.index != dev.index)):
        raise ValueError(f"init_params draws from a CPU torch.Generator or "
                         f"one on {dev}, not on {generator.device}")

    def make(leaf):
        out = torch.empty(leaf.shape, dtype=leaf_dtype(leaf, cfg, dtype),
                          device=dev)
        if leaf.std is None:
            out.copy_(leaf.fixed(leaf.shape))
        else:
            _draw(out, leaf.std, generator,
                  max(out.numel(), 1) if on_host else DRAW_SLICE)
        return out

    return _tree_map(make, param_spec(cfg))


def _layer(tree, i):
    """Layer ``i`` of a stacked block tree, as views."""
    return _tree_map(lambda t: t[i], tree)


def _blocks(params, cfg):
    """(block params, block key, period index, mixer kind, mlp kind) in
    layer order."""
    for i in range(cfg.n_periods):
        for p in range(cfg.period):
            yield (_layer(params["blocks"][str(p)], i), str(p), i,
                   cfg.layer_pattern[p], cfg.mlp_pattern[p])
    for r in range(cfg.n_remainder):
        yield (params["rem"][str(r)], str(r), None, cfg.layer_pattern[r],
               cfg.mlp_pattern[r])


# ==========================================================================
# Forward (prefill) and decode
# ==========================================================================


def _apply_mlp(bp, x, cfg, mlp_kind, *, want_aux=False):
    """Returns (x, aux): aux the [load_balance, z] router losses [2] of a
    MoE block when ``want_aux``, else None."""
    if mlp_kind != "moe" and not bp["mlp"]:
        return x, None    # no FFN (mamba2): ln2 is not read
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if mlp_kind != "moe":
        return x + mlp(bp["mlp"], h, cfg.act), None
    aux = None
    if want_aux:
        aux = torch.stack(moe_mod.moe_aux_losses(bp["mlp"], h, cfg.moe))
    return x + moe_mod.moe_ffn(bp["mlp"], h, cfg.moe, cfg.act), aux


class _BF16Cotangent(torch.autograd.Function):
    """The identity in the forward; the backward rounds the cotangent to
    bfloat16 and back to its dtype (the reference's ``_bf16_cotangent``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _enc_kv_heads(cfg):
    """(KV heads, head dim) of the encoder's attention and of the cross
    attention's keys and values."""
    enc = cfg.encoder
    return enc.n_kv_heads, cfg.d_model // enc.n_heads


def apply_block_full(bp, x, cfg, mixer_kind, mlp_kind, positions,
                     enc_out=None, *, banded=False, want_aux=False):
    """Returns (x, cache entry of the layer in the cache's dtypes, aux):
    aux as ``_apply_mlp`` gives it.  A local layer takes the banded path
    under ``banded`` or the ``banded_local`` PerfFlag, as the reference's.
    In an encoder-decoder model ``ln_x`` and cross attention over
    ``enc_out`` follow the self-attention, and the entry holds their
    ``xk``, ``xv``.  The output takes the ``"activation"`` sharding hint
    and, under the ``bf16_grads`` PerfFlag, goes through
    ``_BF16Cotangent``."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    dt = model_dtype(cfg)
    if mixer_kind == "ssm":
        y, (conv_tail, state) = ssm_mod.mamba2_forward(bp["mixer"], h, cfg)
        cache = {"conv": conv_tail.to(dt), "ssd": state.to(F32)}
    elif cfg.mla is not None:
        y, (ckv, krope) = attn_mod.mla_attention(bp["mixer"], h, cfg,
                                                 positions=positions)
        cache = {"ckv": ckv.to(dt), "krope": krope.to(dt)}
    else:
        local = mixer_kind == "attn_local"
        y, (k, v) = attn_mod.gqa_attention(
            bp["mixer"], h, cfg, local=local, positions=positions,
            banded=banded or (_perf().banded_local and local))
        cache = {"k": k.to(dt), "v": v.to(dt)}
    x = shard_hint(x + y, "activation")
    if cfg.is_encdec:
        h = rmsnorm(bp["ln_x"], x, cfg.norm_eps)
        cache["xk"], cache["xv"] = attn_mod.cross_kv(bp["xattn"], enc_out,
                                                     *_enc_kv_heads(cfg))
        x = shard_hint(x + attn_mod.cross_attention(
            bp["xattn"], h, cache["xk"], cache["xv"], cfg), "activation")
    x, aux = _apply_mlp(bp, x, cfg, mlp_kind, want_aux=want_aux)
    x = shard_hint(x, "activation")
    if _perf().bf16_grads:
        x = _BF16Cotangent.apply(x)
    return x, cache, aux


def apply_block_decode(bp, x, cfg, mixer_kind, mlp_kind, cache, cache_len):
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if mixer_kind == "ssm":
        y, _, _ = ssm_mod.mamba2_decode(bp["mixer"], h, cfg, cache["conv"],
                                        cache["ssd"])
    elif cfg.mla is not None:
        y, _, _ = attn_mod.mla_decode(bp["mixer"], h, cfg, cache["ckv"],
                                      cache["krope"], cache_len)
    else:
        y, _, _ = attn_mod.gqa_decode(bp["mixer"], h, cfg, cache["k"],
                                      cache["v"], cache_len,
                                      local=mixer_kind == "attn_local")
    x = shard_hint(x + y, "activation")
    if cfg.is_encdec:
        h = rmsnorm(bp["ln_x"], x, cfg.norm_eps)
        x = shard_hint(x + attn_mod.cross_attention(
            bp["xattn"], h, cache["xk"], cache["xv"], cfg), "activation")
    return shard_hint(_apply_mlp(bp, x, cfg, mlp_kind)[0], "activation")


def input_embeddings(params, cfg, tokens, frontend_embeds=None):
    """The token embeddings, after ``patch_stub``'s patches (cast to the
    embedding's dtype) where given."""
    x = embed(params["embed"], tokens, cfg.embed_scale)
    if cfg.frontend == "patch_stub" and frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return x


def encode(params, cfg, enc_embeds):
    """enc_embeds [B,S_enc,d] (the audio stub's frames) -> the encoder's
    output [B,S_enc,d] after ``enc_norm``, as the reference's ``encode``:
    each layer ln1, attention without a causal mask and without positions
    (plain chunked attention, as the reference's jnp, over heads of d //
    enc.n_heads), ln2 and the tanh-GELU MLP.  Raises ``TypeError`` for
    frames in another dtype than the encoder's weights."""
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder model needs its "
                         "frames (frontend_embeds)")
    enc = cfg.encoder
    w = params["enc_blocks"]["mixer"]["wq"]
    if enc_embeds.dtype != w.dtype:
        raise TypeError(f"{cfg.name}: frames in {enc_embeds.dtype}, the "
                        f"encoder's weights in {w.dtype}")
    Hk, d_head = _enc_kv_heads(cfg)
    x = enc_embeds
    for i in range(enc.n_layers):
        bp = _layer(params["enc_blocks"], i)
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        q, k, v = attn_mod.gqa_project_qkv(bp["mixer"], h, enc.n_heads, Hk,
                                           d_head)
        o = attn_mod.chunked_attention(q, k, v, causal=False,
                                       chunk=cfg.attn_chunk)
        x = shard_hint(x + attn_mod.merge_heads(o) @ bp["mixer"]["wo"],
                       "activation")
        x = shard_hint(x + mlp(bp["mlp"], rmsnorm(bp["ln2"], x, cfg.norm_eps),
                               "gelu"), "activation")
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# The outputs that ``"dots"`` keeps: the matrix products', as
# ``jax.checkpoint_policies.checkpoint_dots`` keeps dot_general outputs.
# Everything else, the hand-written kernels' outputs included, is
# recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """``fn`` rematerialized as ``cfg.remat`` says (the reference's
    ``_remat``): ``"none"`` as it is; ``"full"`` recomputes everything in
    the backward; ``"dots"``, or the ``remat_dots`` PerfFlag, recomputes
    everything but the matrix products.  No block draws random numbers, so
    the checkpoint's RNG stash is moot and stays at its default."""
    if cfg.remat == "none":
        return fn
    flags = _perf()
    mesh, hints = current_hints() or (None, None)
    kw = {}
    if cfg.remat == "dots" or flags.remat_dots:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def under_flags(*args):
        # The recompute runs in the backward, on the autograd engine's
        # device thread for CUDA tensors, where this thread's PerfFlags and
        # sharding hints are not set: it must take the forward's routes
        # (flash or not) and layouts.
        with perf_flags(flags), hint_context(hints, mesh):
            return fn(*args)

    return functools.partial(checkpoint, under_flags, use_reentrant=False,
                             **kw)


def _records(params) -> bool:
    """Whether autograd records a graph through ``params``."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves(params))


def forward_hidden(params, cfg, tokens, frontend_embeds=None, *,
                   want_cache=False, banded=False, want_aux=False):
    """tokens [B,S] -> (hidden [B,S',d] after the final norm, caches or
    None), or with ``want_aux`` (hidden, caches, aux [2]): the MoE blocks'
    (load_balance, z) router losses summed and divided by ``cfg.n_layers``,
    every layer counted, as the reference's.  ``frontend_embeds`` are the
    encoder's frames of an encoder-decoder model, or the P patches a
    ``patch_stub`` model puts before the tokens (S' = P + S).  ``banded``
    gives every local layer the banded path (``apply_block_full``).  The
    embeddings take the ``"activation"`` sharding hint.  Each period of
    the stacked blocks goes through ``_remat`` when autograd records, the
    encoder's output one of its inputs and its share of aux one of its
    outputs."""
    check_supported(cfg)
    enc_out = encode(params, cfg, frontend_embeds) if cfg.is_encdec \
        else None
    x = shard_hint(input_embeddings(params, cfg, tokens, frontend_embeds),
                   "activation")
    positions = torch.arange(x.shape[1], device=x.device)

    def period_fn(x, aux, enc_out, pparams):
        caches = {}
        for p in range(cfg.period):
            x, caches[str(p)], a = apply_block_full(
                pparams[str(p)], x, cfg, cfg.layer_pattern[p],
                cfg.mlp_pattern[p], positions, enc_out, banded=banded,
                want_aux=want_aux)
            if a is not None:
                aux = aux + a
        return x, aux, caches

    if _records(params):
        period_fn = _remat(period_fn, cfg)
    aux = torch.zeros(2, dtype=F32, device=x.device) if want_aux else None
    stacked = []
    for i in range(cfg.n_periods):
        x, aux, c = period_fn(x, aux, enc_out, {
            str(p): _layer(params["blocks"][str(p)], i)
            for p in range(cfg.period)})
        if want_cache:
            stacked.append(c)
    rem = {}
    for r in range(cfg.n_remainder):
        x, rem[str(r)], a = apply_block_full(
            params["rem"][str(r)], x, cfg, cfg.layer_pattern[r],
            cfg.mlp_pattern[r], positions, enc_out, banded=banded,
            want_aux=want_aux)
        if a is not None:
            aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    caches = None
    if want_cache:
        blocks = {key: {n: torch.stack([c[key][n] for c in stacked])
                        for n in stacked[0][key]}
                  for key in stacked[0]} if stacked else {}
        caches = {"blocks": blocks, "rem": rem}
    if want_aux:
        return x, caches, aux / max(cfg.n_layers, 1)
    return x, caches


def logits_last(params, cfg, hidden):
    """Logits of the last position, [B,V] in fp32: the products of the
    (bf16) inputs are summed in fp32, as ``preferred_element_type=F32``
    does in the reference."""
    return _logits(params, cfg, hidden[:, -1])


def _head(params, cfg):
    """(the head's weight, whether it is the tied embedding [V,d])."""
    if cfg.tie_embeddings:
        return params["embed"], True
    return params["lm_head"], False


def _logits(params, cfg, h):
    return _head_logits(*_head(params, cfg), h)


def _head_logits(w, tied, h):
    """h [..., d] -> [..., V] fp32 through the head ``w``.  A bf16 product
    is exact in fp32, so upcasting the inputs sums the bf16 products in
    fp32."""
    w = w.to(F32)
    return h.to(F32) @ (w.t() if tied else w)


def _chunk_loss(w, tied, hc, lc):
    """(sum of logsumexp - gold over labels >= 0, their count) of one
    chunk; hc [B,C,d], lc [B,C].  The logits take the ``"logits"``
    sharding hint.  The gold logits are gathered from the rows of the
    logits flattened to [B*C, V]: the same values, and a lookup that a
    vocab-sharded DTensor (the dry-run's) takes as a masked partial
    reduce, which it cannot do for a 3-d gather.  The reduce then meets
    the [B*C, 1] gather as it came: DTensor keeps its mask at that shape
    through a reshape, and a rank with data would fail to apply it."""
    logits = shard_hint(_head_logits(w, tied, hc), "logits")
    lse = torch.logsumexp(logits, dim=-1).reshape(-1, 1)
    lc = lc.reshape(-1, 1)
    gold = torch.gather(logits.flatten(0, 1), 1, lc.clamp(min=0))
    valid = lc >= 0
    return torch.where(valid, lse - gold, 0.0).sum(), valid.sum()


def chunked_ce_loss(params, cfg, hidden, labels):
    """Mean CE over labels >= 0 without holding [B,S,V] logits (the
    reference's ``chunked_ce_loss``).

    hidden [B,S,d]; labels [B,S] integer (-1 = ignore).  The sequence is
    padded with -1 labels to a multiple of ``min(cfg.loss_chunk, S)`` and
    taken in chunks of that length; each chunk's logits are recomputed in
    the backward (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``), so one chunk's [B,C,V] logits live at a time.
    Under the ``loss_weight_gather`` PerfFlag the head's weight takes the
    ``"loss_head"`` (``"loss_head_tied"``) sharding hint first.
    """
    B, S, _ = hidden.shape
    C = min(cfg.loss_chunk, S)
    pad = (-S) % C
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    w, tied = _head(params, cfg)
    if _perf().loss_weight_gather:
        w = shard_hint(w, "loss_head_tied" if tied else "loss_head")
    loss_sum = torch.zeros((), dtype=F32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for start in range(0, S + pad, C):
        part, n = checkpoint(
            _chunk_loss, w, tied, hidden[:, start:start + C],
            labels[:, start:start + C], use_reentrant=False)
        loss_sum, count = loss_sum + part, count + n
    return loss_sum / count.clamp(min=1)


def lm_loss(params, cfg, tokens, labels, frontend_embeds=None, *,
            banded=False, aux_weights=None):
    """Mean next-token CE of ``tokens`` [B,S] against ``labels`` [B,S]
    (-1 = ignore), the reference's ``lm_loss``; ``frontend_embeds`` as
    ``forward_hidden`` takes them, a ``patch_stub`` model's P patches
    padding the labels with P entries of -1 in front; ``banded`` as
    ``forward_hidden`` takes it.  ``aux_weights=(lb_w, z_w)`` adds lb_w *
    load_balance + z_w * z of ``forward_hidden(want_aux=)``; ignored for a
    config without MoE."""
    want_aux = aux_weights is not None and cfg.moe is not None
    out = forward_hidden(params, cfg, tokens, frontend_embeds,
                         banded=banded, want_aux=want_aux)
    if cfg.frontend == "patch_stub" and frontend_embeds is not None:
        labels = torch.nn.functional.pad(
            labels, (frontend_embeds.shape[1], 0), value=-1)
    loss = chunked_ce_loss(params, cfg, out[0], labels)
    if want_aux:
        loss = loss + aux_weights[0] * out[2][0] + aux_weights[1] * out[2][1]
    return loss


def prefill(params, cfg, tokens, frontend_embeds=None):
    """Returns (last-token logits [B,V] fp32, caches); ``frontend_embeds``
    as ``forward_hidden`` takes them."""
    hidden, caches = forward_hidden(params, cfg, tokens, frontend_embeds,
                                    want_cache=True)
    return logits_last(params, cfg, hidden), caches


def decode_step(params, cfg, token, caches, cache_len):
    """One decode step.  token [B,1]; cache_len an int, a 0-d tensor (one
    length for every row) or a per-row [B] tensor (read by attention
    layers only).  Writes the new k, v (or conv and ssd states) into
    ``caches`` in place and returns (logits [B,V] fp32, caches)."""
    check_supported(cfg)
    x = embed(params["embed"], token, cfg.embed_scale)
    for bp, key, i, kind, mlp_kind in _blocks(params, cfg):
        if i is None:
            c = caches["rem"][key]
        else:
            c = {n: t[i] for n, t in caches["blocks"][key].items()}
        x = apply_block_decode(bp, x, cfg, kind, mlp_kind, c, cache_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_last(params, cfg, x), caches


def _mixer_cache(cfg, kind, lead, B, T, device):
    dt = model_dtype(cfg)
    if kind == "ssm":
        spec = cfg.ssm
        ch = spec.d_inner(cfg.d_model) + 2 * spec.n_groups * spec.d_state
        H = spec.n_heads(cfg.d_model)
        return {"conv": torch.zeros(lead + (B, spec.d_conv - 1, ch),
                                    dtype=dt, device=device),
                "ssd": torch.zeros(lead + (B, spec.n_groups,
                                           H // spec.n_groups,
                                           spec.head_dim, spec.d_state),
                                   dtype=F32, device=device)}
    if cfg.mla is not None:
        return {"ckv": torch.zeros(lead + (B, T, cfg.mla.kv_lora_rank),
                                   dtype=dt, device=device),
                "krope": torch.zeros(lead + (B, T, cfg.mla.qk_rope_head_dim),
                                     dtype=dt, device=device)}
    shape = lead + (B, T, cfg.n_kv_heads, cfg.d_head)
    return {n: torch.zeros(shape, dtype=dt, device=device) for n in ("k", "v")}


def _block_cache(cfg, kind, lead, B, T, device):
    """A layer's zero cache; an encoder-decoder layer's ``xk``, ``xv``
    span the encoder's ``source_len`` positions."""
    cache = _mixer_cache(cfg, kind, lead, B, T, device)
    if cfg.is_encdec:
        shape = lead + (B, cfg.encoder.source_len) + _enc_kv_heads(cfg)
        cache.update({n: torch.zeros(shape, dtype=model_dtype(cfg),
                                     device=device) for n in ("xk", "xv")})
    return cache


def init_cache(cfg, B: int, T: int, *, device):
    """Zero caches with capacity T (attention) for B rows, per layer kind
    as the reference's ``init_cache``."""
    check_supported(cfg)
    return {"blocks": {str(p): _block_cache(cfg, cfg.layer_pattern[p],
                                            (cfg.n_periods,), B, T, device)
                       for p in range(cfg.period)},
            "rem": {str(i): _block_cache(cfg, cfg.layer_pattern[i], (), B, T,
                                         device)
                    for i in range(cfg.n_remainder)}}
