"""The port's Mamba-2 model against the JAX package's on the CPU, float32:
the same bridged weights and tokens give the same hidden states, prefill
logits, caches and 8 greedy decode steps, on reduced mamba2-370m (which
has an FFN, d_ff=128) and on its attention-free, FFN-free variant with
two stacked layers (d_ff=0, the block the full model runs).  Tolerance
2e-4, the reference's own for the chunked SSD (tests/test_ssm.py).

Also, at full size without allocating: the port's parameter spec and
cache tree equal the reference's leaf by leaf in shape and dtype, for
mamba2-370m, llsc-100m, the two MoE configs (the router float32) and the
jamba hybrid.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

TOL = 2e-4
B, S, STEPS = 2, 40, 8      # 40 tokens: three chunks of 16, the last padded


def _variants():
    """(name, port config, JAX config): reduced mamba2, and the d_ff=0
    two-layer stack of the full model's block."""
    cfg, jcfg = reduced_config("mamba2-370m"), jax_reduced("mamba2-370m")
    return {"reduced": (cfg, jcfg),
            "no_ffn_2_layers": (dataclasses.replace(cfg, d_ff=0, n_layers=2),
                                dataclasses.replace(jcfg, d_ff=0,
                                                    n_layers=2))}


@pytest.fixture(scope="module", params=["reduced", "no_ffn_2_layers"])
def setup(request):
    cfg, jcfg = _variants()[request.param]
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return jcfg, cfg, jparams, params, tokens


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().to(torch.float32).numpy())))


def _flat_jax(tree):
    return {jax.tree_util.keystr(p): a
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def test_variant_blocks(setup):
    jcfg, cfg, jparams, params, _ = setup
    blk = params["blocks"]["0"]
    assert cfg.n_periods == cfg.n_layers and cfg.n_remainder == 0
    assert (blk["mlp"] == {}) == (cfg.d_ff == 0)
    assert set(blk["mixer"]) == set(jparams["blocks"]["0"]["mixer"])


def test_forward_hidden_prefill_and_caches_match(setup):
    jcfg, cfg, jparams, params, tokens = setup
    jh, _ = jax_tf.forward_hidden(jparams, jcfg, jnp.asarray(tokens))
    jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens))
    h, _ = tf.forward_hidden(params, cfg, torch.from_numpy(tokens))
    logits, cache = model_lib.prefill(params, cfg, torch.from_numpy(tokens))
    assert h.shape == (B, S, cfg.d_model) and logits.dtype == torch.float32
    assert _err(jh, h) < TOL
    assert _err(jlogits, logits) < TOL
    jflat, flat = _flat_jax(jcache), _flat(cache)
    assert set(flat) == set(jflat)
    for path, arr in jflat.items():
        assert tuple(flat[path].shape) == arr.shape, path
        assert _err(arr, flat[path]) < TOL, path


def test_greedy_decode_matches(setup):
    jcfg, cfg, jparams, params, tokens = setup
    jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens))
    logits, cache = model_lib.prefill(params, cfg, torch.from_numpy(tokens))
    jdecode = jax.jit(lambda p, t, c, n: jax_tf.decode_step(p, jcfg, t, c, n))
    jtok = jnp.argmax(jlogits, axis=-1)
    tok = torch.argmax(logits, dim=-1)
    for step in range(STEPS):
        assert np.array_equal(np.asarray(jtok), tok.numpy()), step
        jlogits, jcache = jdecode(jparams, jtok[:, None], jcache, S + step)
        logits, cache = model_lib.decode_step(params, cfg, tok[:, None],
                                              cache, S + step)
        assert _err(jlogits, logits) < TOL, step
        jtok = jnp.argmax(jlogits, axis=-1)
        tok = torch.argmax(logits, dim=-1)
    assert np.array_equal(np.asarray(jtok), tok.numpy())
    for path, arr in _flat_jax(jcache).items():
        assert _err(arr, _flat(cache)[path]) < TOL, path


# --------------------------------------------------------------------------
# Full-size trees, without allocating
# --------------------------------------------------------------------------


ARCHS = ["mamba2-370m", "llsc-100m", "granite-moe-1b-a400m",
         "qwen3-moe-30b-a3b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_reference_tree(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ref = _flat_jax(jax_model.init_params_shape(jcfg))
    mine = _flat(tf.param_spec(cfg))
    assert set(mine) == set(ref)
    for path, leaf in mine.items():
        assert leaf.shape == ref[path].shape, path
        assert str(tf.leaf_dtype(leaf, cfg)).split(".")[1] == \
            str(ref[path].dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_equals_reference_tree(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ref = _flat_jax(jax_model.cache_struct(jcfg, 4, 384))
    mine = _flat(model_lib.init_cache(cfg, 4, 384, device="meta"))
    assert set(mine) == set(ref)
    for path, t in mine.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == ref[path].shape, path
        assert str(t.dtype).split(".")[1] == str(ref[path].dtype), path


def test_bridge_and_init_keep_float32_leaves_float32():
    """In a bf16 model, A_log, D, dt_bias and the ssd cache stay float32 as
    in the reference; everything else is bf16."""
    cfg = dataclasses.replace(reduced_config("mamba2-370m"), dtype="bfloat16")
    jcfg = dataclasses.replace(jax_reduced("mamba2-370m"), dtype="bfloat16")
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    bridged = _flat(from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu"))
    drawn = _flat(model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu"))
    for path, arr in _flat_jax(jparams).items():
        want = torch.float32 if arr.dtype == jnp.float32 else torch.bfloat16
        assert bridged[path].dtype == want, path
        assert drawn[path].dtype == want, path
    fp32 = {p for p, t in bridged.items() if t.dtype == torch.float32}
    assert {p.split("[")[-1] for p in fp32} == {"'A_log']", "'D']",
                                                 "'dt_bias']"}
    cache = _flat(model_lib.init_cache(cfg, 2, 8, device="cpu"))
    assert {p: str(t.dtype) for p, t in cache.items()} == {
        "['blocks']['0']['conv']": "torch.bfloat16",
        "['blocks']['0']['ssd']": "torch.float32"}


def test_init_params_fixed_leaves_equal_the_reference():
    """conv_b zeros, A_log = log(1..H), D ones, dt_bias = softplus^-1(0.01),
    the norm scales ones: the same values as the reference's init."""
    cfg, jcfg = reduced_config("mamba2-370m"), jax_reduced("mamba2-370m")
    mine = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    theirs = jax_init(jcfg, jax.random.PRNGKey(0))
    for name in ("conv_b", "A_log", "D", "dt_bias", "norm"):
        a = mine["blocks"]["0"]["mixer"][name]
        b = np.asarray(theirs["blocks"]["0"]["mixer"][name])
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name in ("in_proj", "conv_w", "out_proj"):
        a = mine["blocks"]["0"]["mixer"][name]
        std = float(np.asarray(theirs["blocks"]["0"]["mixer"][name]).std())
        assert 0.5 * std < float(a.std()) < 2 * std, name
