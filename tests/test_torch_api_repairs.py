"""The reference's keywords, argument names and ``ModelConfig`` members in
the port, held against the JAX package on the CPU, float32, with the same
bridged weights.

* ``banded=True`` through ``forward_hidden``, ``lm_loss``,
  ``loss_and_grads`` and ``make_train_step`` on reduced gemma3-1b (7
  layers: 6 local, window 8, ``attn_chunk`` 16, 40 tokens) equals the
  reference's ``banded=True`` (5e-5 for hidden states, 1e-5 relative for
  the loss, gradients within 5e-3 and 1e-4 of each leaf's largest, the
  bounds of tests/test_torch_gemma3.py) and, bit for bit, the port's own
  ``banded_local`` route; it takes the band on local layers only.
* ``gqa_attention(chunk=)`` equals the reference's (5e-5), banded or not.
* ``apply_block_full`` / ``apply_block_decode`` take ``mixer_kind`` and
  ``encode`` takes ``enc_embeds`` by keyword, as the reference's.
* ``uses_attention``, ``sub_quadratic``, ``param_count()`` and
  ``active_param_count()`` equal the reference's for every registered
  arch, full and reduced.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.train import DataConfig as JaxDataConfig  # noqa: E402
from repro.train import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "gemma3-1b"
F32 = torch.float32
TOL = 5e-5
B, S = 2, 40        # three query chunks of 16: the band (32 keys) engages
BANDED_LOCAL = PerfFlags(banded_local=True)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_reduced(ARCH), reduced_config(ARCH)
    jstate = jax_ts.init_train_state(jcfg, jax.random.PRNGKey(0),
                                     jax_ts.default_opt_cfg(jcfg))
    params = from_jax_params(jax.tree.map(np.asarray, jstate.params), cfg,
                             "cpu", dtype=F32)
    b = JaxSyntheticLM(JaxDataConfig(cfg.vocab_size, S, B, 0)).batch(0)
    batch = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
             for k, v in b.items()}
    return jcfg, cfg, jstate, params, b, batch


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().to(F32).numpy())))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


def _jax_paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# --------------------------------------------------------------------------
# banded=
# --------------------------------------------------------------------------


def test_forward_hidden_banded_matches_jax_and_the_flag(setup, monkeypatch):
    """Hidden states under ``banded=True`` within 5e-5 of the reference's,
    equal to the ``banded_local`` route's, and each local layer's query
    chunks read the band of 32 keys while the global layer reads all 40."""
    jcfg, cfg, jstate, params, b, batch = setup
    jh, _ = jax_tf.forward_hidden(jstate.params, jcfg, b["tokens"],
                                  banded=True)
    widths = []
    attend = attn_mod._attend_block

    def recorded(qc, k, *args, **kw):
        widths.append((kw["window"] is not None, k.shape[1]))
        return attend(qc, k, *args, **kw)

    monkeypatch.setattr(attn_mod, "_attend_block", recorded)
    with torch.no_grad():
        h, _ = tf.forward_hidden(params, cfg, batch["tokens"], banded=True)
        local = {w for is_local, w in widths if is_local}
        glob = {w for is_local, w in widths if not is_local}
        assert local == {32} and glob == {S}
        with perf_flags(BANDED_LOCAL):
            h_flag, _ = tf.forward_hidden(params, cfg, batch["tokens"])
    assert _err(jh, h) < TOL
    assert torch.equal(h, h_flag)


def test_lm_loss_and_gradients_banded_match_jax_and_the_flag(setup):
    """``lm_loss(banded=True)`` and its gradients against the reference's;
    ``loss_and_grads(banded=True)`` equals the ``banded_local`` route's."""
    jcfg, cfg, jstate, params, b, batch = setup
    jl, jg = jax.value_and_grad(lambda p: jax_tf.lm_loss(
        p, jcfg, b["tokens"], b["labels"], banded=True))(jstate.params)
    with torch.no_grad():
        loss = tf.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                          banded=True)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    loss, grads = ts.loss_and_grads(params, cfg, batch, banded=True)
    with perf_flags(BANDED_LOCAL):
        loss_flag, grads_flag = ts.loss_and_grads(params, cfg, batch)
    assert torch.equal(loss, loss_flag)
    jg, grads, grads_flag = _jax_paths(jg), _flat(grads), _flat(grads_flag)
    assert set(grads) == set(jg)
    for key, g in grads.items():
        assert torch.equal(g, grads_flag[key]), key
        err = float(np.max(np.abs(g.numpy() - jg[key])))
        peak = float(np.max(np.abs(jg[key])))
        assert err < 5e-3 and err <= 1e-4 * peak, (key, err, peak)


def test_make_train_step_banded_matches_jax_and_the_flag(setup):
    """One AdamW step of ``make_train_step(banded=True)``: the loss within
    1e-5 relative of the reference's ``make_train_step(banded=True)``, and
    the new state equal to the ``banded_local`` route's, leaf for leaf."""
    jcfg, cfg, jstate, params, b, batch = setup
    jstep = jax.jit(jax_ts.make_train_step(
        jcfg, jax_ts.default_opt_cfg(jcfg, total_steps=3), banded=True))
    _, jmet = jstep(jstate, b)
    ocfg = ts.default_opt_cfg(cfg, total_steps=3)
    state = ts.TrainState(params, opt.init_opt_state(params, ocfg))
    new, met = ts.make_train_step(cfg, ocfg, banded=True)(state, batch)
    with perf_flags(BANDED_LOCAL):
        new_flag, met_flag = ts.make_train_step(cfg, ocfg)(state, batch)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        1e-5 * abs(float(jmet["loss"]))
    assert torch.equal(met["loss"], met_flag["loss"])
    for key, p in _flat(new.params).items():
        assert torch.equal(p, _flat(new_flag.params)[key]), key


def test_banded_is_a_keyword_where_the_reference_has_it():
    for mine, ref in ((tf.forward_hidden, jax_tf.forward_hidden),
                      (tf.lm_loss, jax_tf.lm_loss),
                      (tf.apply_block_full, jax_tf.apply_block_full),
                      (ts.make_train_step, jax_ts.make_train_step),
                      (attn_mod.gqa_attention, jax_attn.gqa_attention)):
        got = inspect.signature(mine).parameters
        want = inspect.signature(ref).parameters
        assert got["banded"].kind is inspect.Parameter.KEYWORD_ONLY
        assert got["banded"].default is want["banded"].default is False
    got = inspect.signature(attn_mod.gqa_attention).parameters["chunk"]
    assert got.default is None and got.kind is inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("chunk", [None, 8])
def test_gqa_attention_chunk_matches_jax(setup, monkeypatch, chunk, banded):
    """A local layer's attention with ``chunk`` (None: ``attn_chunk`` 16)
    against the reference's: output and k, v within 5e-5; the plain
    attention runs in query chunks of ``chunk or cfg.attn_chunk``."""
    jcfg, cfg, jstate, params, _, _ = setup
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jmix = jax.tree.map(lambda t: t[0], jstate.params["blocks"]["0"]["mixer"])
    mix = {k: v[0] for k, v in params["blocks"]["0"]["mixer"].items()}
    jout, (jk, jv) = jax_attn.gqa_attention(
        jmix, jnp.asarray(x), jcfg, local=True, positions=jnp.arange(S),
        chunk=chunk, banded=banded)
    rows = []
    attend = attn_mod._attend_block

    def recorded(qc, *args, **kw):
        rows.append(qc.shape[1])
        return attend(qc, *args, **kw)

    monkeypatch.setattr(attn_mod, "_attend_block", recorded)
    with torch.no_grad():
        out, (k, v) = attn_mod.gqa_attention(
            mix, torch.from_numpy(x), cfg, local=True,
            positions=torch.arange(S), chunk=chunk, banded=banded)
    assert max(rows) == (chunk or cfg.attn_chunk) and sum(rows) >= S
    for a, t in ((jout, out), (jk, k), (jv, v)):
        assert _err(a, t) < TOL


# --------------------------------------------------------------------------
# argument names
# --------------------------------------------------------------------------


def test_block_functions_take_the_reference_argument_names(setup):
    """``mixer_kind`` by keyword gives what the positional call gives, and
    the positional names are the reference's."""
    _, cfg, _, params, _, batch = setup
    for mine, ref in ((tf.apply_block_full, jax_tf.apply_block_full),
                      (tf.apply_block_decode, jax_tf.apply_block_decode),
                      (tf.encode, jax_tf.encode)):
        names = [n for n, p in inspect.signature(mine).parameters.items()
                 if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
        want = list(inspect.signature(ref).parameters)[:len(names)]
        assert names == want
    bp = {k: v for k, v in tf._layer(params["blocks"]["0"], 0).items()}
    x = tf.embed(params["embed"], batch["tokens"], cfg.embed_scale)
    positions = torch.arange(S)
    with torch.no_grad():
        y, cache, _ = tf.apply_block_full(
            bp=bp, x=x, cfg=cfg, mixer_kind="attn_local", mlp_kind="mlp",
            positions=positions)
        y2, _, _ = tf.apply_block_full(bp, x, cfg, "attn_local", "mlp",
                                       positions)
        assert torch.equal(y, y2)
        cache = {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1))
                 for n, t in cache.items()}
        step = tf.apply_block_decode(
            bp=bp, x=x[:, :1], cfg=cfg, mixer_kind="attn_local",
            mlp_kind="mlp", cache=dict(cache), cache_len=S)
        step2 = tf.apply_block_decode(bp, x[:, :1], cfg, "attn_local", "mlp",
                                      dict(cache), S)
        assert torch.equal(step, step2)


def test_encode_takes_enc_embeds_by_keyword():
    """Reduced whisper-base: ``encode(params, cfg, enc_embeds=...)``
    equals the reference's ``encode`` over the same frames (5e-5)."""
    jcfg, cfg = jax_reduced("whisper-base"), reduced_config("whisper-base")
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    frames = np.random.default_rng(5).standard_normal(
        (2, cfg.encoder.source_len, cfg.d_model)).astype(np.float32)
    want = jax_tf.encode(jparams, jcfg, enc_embeds=jnp.asarray(frames))
    with torch.no_grad():
        got = tf.encode(params, cfg, enc_embeds=torch.from_numpy(frames))
    assert _err(want, got) < TOL


# --------------------------------------------------------------------------
# ModelConfig members
# --------------------------------------------------------------------------


def test_every_reference_arch_is_registered():
    assert list_archs() == jax_list_archs()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_model_config_members_match_jax(arch, reduced):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jax_reduced(jcfg), reduced_config(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.uses_attention == jcfg.uses_attention
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
