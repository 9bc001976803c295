"""The port's model against the JAX package on reduced llsc-100m, fp32,
S=128 (as tests/test_flash_integration.py): the same bridged weights and
tokens give the same hidden states, prefill logits, caches and greedy
decode, with the flash path on and off.  Tolerance 5e-5, the reference's
own for the flash path at model level.  The same for reduced
granite-moe-1b-a400m (one MoE layer, capacity factor 4: nothing drops)
and for two stacked MoE layers at the full config's capacity factor 1.25,
where the 128-token groups drop tokens; there the MoE auxiliary losses of
``forward_hidden(want_aux=True)`` are held to the reference's too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.perf_flags import PerfFlags as JaxFlags  # noqa: E402
from repro.models.perf_flags import perf_flags as jax_perf_flags  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402

TOL = 5e-5
B, S, STEPS = 2, 128, 8


def _setup(jcfg, cfg):
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return jcfg, cfg, jparams, params, tokens


@pytest.fixture(scope="module")
def setup():
    return _setup(jax_reduced("llsc-100m"), reduced_config("llsc-100m"))


def granite_configs(variant):
    """(JAX config, port config) of reduced granite-moe-1b-a400m:
    ``"reduced"`` as ``reduced_config`` makes it, or ``"2_layers_drops"``
    with two stacked layers and the full config's capacity factor."""
    jcfg = jax_reduced("granite-moe-1b-a400m")
    cfg = reduced_config("granite-moe-1b-a400m")
    if variant == "2_layers_drops":
        jcfg = dataclasses.replace(jcfg, n_layers=2, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=1.25))
        cfg = dataclasses.replace(cfg, n_layers=2, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.25))
    return jcfg, cfg


@pytest.fixture(scope="module", params=["reduced", "2_layers_drops"])
def granite(request):
    return _setup(*granite_configs(request.param))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().to(torch.float32).numpy())))


@pytest.mark.parametrize("flash", [False, True])
def test_forward_hidden_and_prefill_match(setup, flash):
    _check_prefill(setup, flash)


@pytest.mark.parametrize("flash", [False, True])
def test_granite_forward_hidden_and_prefill_match(granite, flash):
    _check_prefill(granite, flash)


def test_granite_aux_losses_match(granite):
    """(load_balance, z) summed over the MoE blocks over n_layers."""
    jcfg, cfg, jparams, params, tokens = granite
    _, _, jaux = jax_tf.forward_hidden(jparams, jcfg, jnp.asarray(tokens),
                                       want_aux=True)
    _, caches, aux = tf.forward_hidden(params, cfg, torch.from_numpy(tokens),
                                       want_aux=True)
    assert caches is None and aux.shape == (2,) and aux.dtype == torch.float32
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-5)


def _check_prefill(setup, flash):
    jcfg, cfg, jparams, params, tokens = setup
    with jax_perf_flags(JaxFlags(flash_kernel=flash)):
        jh, _ = jax_tf.forward_hidden(jparams, jcfg, jnp.asarray(tokens))
        jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens))
    with perf_flags(PerfFlags(flash_kernel=flash)):
        h, _ = tf.forward_hidden(params, cfg, torch.from_numpy(tokens))
        logits, cache = model_lib.prefill(params, cfg,
                                          torch.from_numpy(tokens))
    assert h.shape == (B, S, cfg.d_model) and logits.dtype == torch.float32
    assert _err(jh, h) < TOL
    assert _err(jlogits, logits) < TOL
    for part in ("blocks", "rem"):
        assert set(cache[part]) == set(jcache[part])
        for key, entry in jcache[part].items():
            assert set(cache[part][key]) == set(entry)
            for name, arr in entry.items():
                assert tuple(cache[part][key][name].shape) == arr.shape
                assert _err(arr, cache[part][key][name]) < TOL


def test_init_cache_tree_matches(setup):
    _check_cache_tree(setup)


def test_granite_init_cache_tree_matches(granite):
    _check_cache_tree(granite)


def _check_cache_tree(setup):
    jcfg, cfg, *_ = setup
    jc = jax_tf.init_cache(jcfg, 3, 40)
    c = model_lib.init_cache(cfg, 3, 40, device="cpu")
    jflat = {jax.tree_util.keystr(p): a.shape
             for p, a in jax.tree_util.tree_leaves_with_path(jc)}
    flat = {}
    for part, entries in c.items():
        for key, entry in entries.items():
            for name, t in entry.items():
                flat[f"['{part}']['{key}']['{name}']"] = tuple(t.shape)
    assert flat == jflat


def _pad_time(tree_jax, tree_torch, extra):
    def jpad(path, a):
        t_ax = 2 if "blocks" in jax.tree_util.keystr(path) else 1
        pad = [(0, 0)] * a.ndim
        pad[t_ax] = (0, extra)
        return jnp.pad(a, pad)

    jc = jax.tree_util.tree_map_with_path(jpad, tree_jax)
    tc = {}
    for part, entries in tree_torch.items():
        t_ax = 2 if part == "blocks" else 1
        tc[part] = {}
        for key, entry in entries.items():
            tc[part][key] = {}
            for name, t in entry.items():
                shape = list(t.shape)
                shape[t_ax] = extra
                tc[part][key][name] = torch.cat(
                    [t, torch.zeros(shape, dtype=t.dtype)], dim=t_ax)
    return jc, tc


@pytest.mark.parametrize("flash", [False, True])
def test_greedy_decode_matches(setup, flash):
    _check_decode(setup, flash)


@pytest.mark.parametrize("flash", [False, True])
def test_granite_greedy_decode_matches(granite, flash):
    """B = 2 decode rows: a group each, so no decode token drops."""
    _check_decode(granite, flash)


def _check_decode(setup, flash):
    jcfg, cfg, jparams, params, tokens = setup
    with jax_perf_flags(JaxFlags(flash_kernel=flash)):
        jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens))
    with perf_flags(PerfFlags(flash_kernel=flash)):
        logits, cache = model_lib.prefill(params, cfg,
                                          torch.from_numpy(tokens))
    jcache, cache = _pad_time(jcache, cache, STEPS)
    jdecode = jax.jit(lambda p, t, c, n: jax_tf.decode_step(p, jcfg, t, c, n))
    jtok = jnp.argmax(jlogits, axis=-1)
    tok = torch.argmax(logits, dim=-1)
    for step in range(STEPS):
        assert np.array_equal(np.asarray(jtok), tok.numpy()), step
        pos = S + step
        # scalar cache_len on even steps, per-row on odd ones
        jlen = pos if step % 2 == 0 else jnp.full((B,), pos, jnp.int32)
        tlen = pos if step % 2 == 0 else torch.full((B,), pos)
        jlogits, jcache = jdecode(jparams, jtok[:, None], jcache, jlen)
        logits, cache = model_lib.decode_step(params, cfg, tok[:, None],
                                              cache, tlen)
        assert _err(jlogits, logits) < TOL, step
        jtok = jnp.argmax(jlogits, axis=-1)
        tok = torch.argmax(logits, dim=-1)
    assert np.array_equal(np.asarray(jtok), tok.numpy())


@pytest.mark.parametrize("mode", ["prefill_ragged_chunks", "decode_per_row",
                                  "decode_scalar"])
def test_chunked_attention_matches_jax(mode):
    from repro.models.attention import chunked_attention as jax_chunked
    from repro_torch.models.attention import chunked_attention

    rng = np.random.default_rng(9)
    if mode == "prefill_ragged_chunks":     # 20 rows in chunks of 16
        Sq, T, kw, tkw = 20, 20, dict(chunk=16), dict(chunk=16)
    else:                                   # one query row against a cache
        Sq, T = 1, 24
        lens = [5, 17] if mode == "decode_per_row" else 11
        jl = jnp.asarray(lens)
        tl = torch.as_tensor(lens) if isinstance(lens, list) else lens
        kw = dict(q_offset=jl, kv_valid_len=jl + 1)
        tkw = dict(q_offset=tl, kv_valid_len=tl + 1)
    q = rng.standard_normal((2, Sq, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, T, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, T, 2, 16), dtype=np.float32)
    theirs = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, **kw)
    mine = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, **tkw)
    assert _err(theirs, mine) < 2e-5


def test_bridge_rejects_a_foreign_tree(setup):
    jcfg, cfg, jparams, *_ = setup
    tree = jax.tree.map(np.asarray, jparams)
    tree["final_norm"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(tree, cfg, "cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(tree, cfg, "cpu")


def test_init_params_is_seeded_and_shaped():
    cfg = reduced_config("llsc-100m")
    a = model_lib.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    b = model_lib.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    spec = tf.param_spec(cfg)
    for leaf, x, y in zip(tf.leaves(spec), tf.leaves(a), tf.leaves(b)):
        assert tuple(x.shape) == leaf.shape and torch.equal(x, y)
        if leaf.std is None:
            assert torch.equal(x, torch.ones(leaf.shape))
        else:
            assert float(x.abs().max()) <= 2 * leaf.std + 1e-6
