"""Model assembly, dense subset (counterpart of ``repro.models.transformer``).

A model is ``n_periods`` copies of a period of layers plus a remainder.  The
parameter and cache trees keep the reference's layout exactly, so that the
bridge and the serving splice read them the same way::

    params = {"embed": [V,d], "blocks": {str(p): tree[n_periods, ...]},
              "rem": {str(i): tree}, "final_norm": {"scale": [d]}}
    caches = {"blocks": {str(p): {"k", "v": [n_periods,B,T,Hk,Dh]}},
              "rem": {str(i): {"k", "v": [B,T,Hk,Dh]}}}

The reference scans over the period axis; here a Python loop takes layer
``i`` as a view ``leaf[i]`` of each stacked leaf.  Decode writes the cache
in place and returns the same tree.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import embed, mlp, rmsnorm

F32 = torch.float32


def model_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg):
    """The port's model covers dense global-attention SwiGLU configs;
    raise for any feature a later slice brings."""
    missing = [name for name, present in (
        ("family " + cfg.family, cfg.family != "dense"),
        ("non-attn layers", any(m != "attn" for m in cfg.layer_pattern)),
        ("non-mlp blocks", any(m != "mlp" for m in cfg.mlp_pattern)),
        ("act " + cfg.act, cfg.act != "swiglu"),
        ("qkv_bias", cfg.qkv_bias),
        ("attn_logit_softcap", cfg.attn_logit_softcap is not None),
        ("moe", cfg.moe is not None), ("ssm", cfg.ssm is not None),
        ("mla", cfg.mla is not None), ("encoder", cfg.encoder is not None),
        ("frontend " + cfg.frontend, cfg.frontend != "none"),
        ("d_ff 0", cfg.d_ff <= 0)) if present]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not support {', '.join(missing)} yet")


# ==========================================================================
# Parameters
# ==========================================================================


def _block_spec(cfg):
    d, hd = cfg.d_model, cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    return {
        "ln1": {"scale": ((d,), None)},
        "ln2": {"scale": ((d,), None)},
        "mixer": {"wq": ((d, hd), d ** -0.5), "wk": ((d, kvd), d ** -0.5),
                  "wv": ((d, kvd), d ** -0.5), "wo": ((hd, d), hd ** -0.5)},
        "mlp": {"w1": ((d, cfg.d_ff), d ** -0.5),
                "w2": ((cfg.d_ff, d), cfg.d_ff ** -0.5),
                "w3": ((d, cfg.d_ff), d ** -0.5)},
    }


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


def param_spec(cfg):
    """The parameter tree as (shape, std) leaves; std None marks a norm
    scale (ones), else a normal truncated at two std, as ``init_params``
    of the reference draws it."""
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    spec = {"embed": ((V, d), d ** -0.5)}
    spec["blocks"] = {
        str(p): _tree_map(lambda leaf: ((cfg.n_periods,) + leaf[0], leaf[1]),
                          _block_spec(cfg))
        for p in range(cfg.period)}
    spec["rem"] = {str(i): _block_spec(cfg) for i in range(cfg.n_remainder)}
    spec["final_norm"] = {"scale": ((d,), None)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, V), d ** -0.5)
    return spec


def init_params(cfg, generator: torch.Generator, *, device="cuda",
                dtype=None):
    """Random parameters in the model dtype on ``device``.

    The draws come from ``generator``, a CPU generator, and are moved to the
    device afterwards, so one seed gives the same weights on every device.
    """
    dev = resolve_device(device)
    if generator.device.type != "cpu":
        raise ValueError("init_params draws from a CPU torch.Generator")
    dtype = dtype or model_dtype(cfg)

    def make(leaf):
        shape, std = leaf
        if std is None:
            return torch.ones(shape, dtype=dtype, device=dev)
        t = torch.empty(shape, dtype=F32)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (t * std).to(device=dev, dtype=dtype)

    return _tree_map(make, param_spec(cfg))


def _layer(tree, i):
    """Layer ``i`` of a stacked block tree, as views."""
    return _tree_map(lambda t: t[i], tree)


def _blocks(params, cfg):
    """(block params, block key, period index) in layer order."""
    for i in range(cfg.n_periods):
        for p in range(cfg.period):
            yield _layer(params["blocks"][str(p)], i), str(p), i
    for r in range(cfg.n_remainder):
        yield params["rem"][str(r)], str(r), None


# ==========================================================================
# Forward (prefill) and decode
# ==========================================================================


def apply_block_full(bp, x, cfg, positions):
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    y, (k, v) = attn_mod.gqa_attention(bp["mixer"], h, cfg,
                                       positions=positions)
    x = x + y
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg.act), {"k": k, "v": v}


def apply_block_decode(bp, x, cfg, cache, cache_len):
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    y, _, _ = attn_mod.gqa_decode(bp["mixer"], h, cfg, cache["k"],
                                  cache["v"], cache_len)
    x = x + y
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg.act)


def input_embeddings(params, cfg, tokens):
    return embed(params["embed"], tokens, cfg.embed_scale)


def forward_hidden(params, cfg, tokens, *, want_cache=False):
    """tokens [B,S] -> (hidden [B,S,d] after the final norm, caches or
    None)."""
    check_supported(cfg)
    x = input_embeddings(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    dt = model_dtype(cfg)
    stacked = {str(p): [] for p in range(cfg.period)}
    rem = {}
    for bp, key, i in _blocks(params, cfg):
        x, c = apply_block_full(bp, x, cfg, positions)
        if want_cache:
            c = {n: t.to(dt) for n, t in c.items()}
            if i is None:
                rem[key] = c
            else:
                stacked[key].append(c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if not want_cache:
        return x, None
    blocks = {key: {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
              for key, cs in stacked.items() if cs}
    return x, {"blocks": blocks, "rem": rem}


def logits_last(params, cfg, hidden):
    """Logits of the last position, [B,V] in fp32: the products of the
    (bf16) inputs are summed in fp32, as ``preferred_element_type=F32``
    does in the reference."""
    h = hidden[:, -1].to(F32)
    if cfg.tie_embeddings:
        return h @ params["embed"].to(F32).t()
    return h @ params["lm_head"].to(F32)


def prefill(params, cfg, tokens):
    """Returns (last-token logits [B,V] fp32, caches)."""
    hidden, caches = forward_hidden(params, cfg, tokens, want_cache=True)
    return logits_last(params, cfg, hidden), caches


def decode_step(params, cfg, token, caches, cache_len):
    """One decode step.  token [B,1]; cache_len an int or a per-row [B]
    tensor.  Writes the new k, v into ``caches`` in place and returns
    (logits [B,V] fp32, caches)."""
    check_supported(cfg)
    x = embed(params["embed"], token, cfg.embed_scale)
    for bp, key, i in _blocks(params, cfg):
        if i is None:
            c = caches["rem"][key]
        else:
            c = {n: t[i] for n, t in caches["blocks"][key].items()}
        x = apply_block_decode(bp, x, cfg, c, cache_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_last(params, cfg, x), caches


def init_cache(cfg, B: int, T: int, *, device):
    """Zero caches with capacity T, in the model dtype."""
    check_supported(cfg)
    dt = model_dtype(cfg)
    shape = (B, T, cfg.n_kv_heads, cfg.d_head)

    def zeros(lead):
        return {n: torch.zeros(lead + shape, dtype=dt, device=device)
                for n in ("k", "v")}

    return {"blocks": {str(p): zeros((cfg.n_periods,))
                       for p in range(cfg.period)},
            "rem": {str(i): zeros(()) for i in range(cfg.n_remainder)}}
