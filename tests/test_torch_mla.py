"""The port's multi-head latent attention (minicpm3) against the JAX
package on the CPU: reduced minicpm3-4b (one layer, 4 heads; q_lora_rank
32, kv_lora_rank 16, query and key heads of 8 + 8, value heads of 8), its
norm scales (ln1, ln2, ``q_norm``, ``kv_norm``, the final norm) planted
with values drawn by numpy from a seed before ``from_jax_params``, in
both packages (the reference initializes them to ones).

- ``mla_attention`` (the naive path of training and prefill) and
  ``mla_decode`` (the absorbed one) one by one against the reference's, in
  float32 and bfloat16;
- the absorbed decode of step t against the naive attention over the
  first t + 1 tokens;
- ``chunked_attention`` returns the value heads' width, over one query
  chunk and over several (a port that reshaped to the query's head dim
  would raise here);
- the model: hidden states, prefill logits and the ``ckv``/``krope``
  caches, 8 greedy decode steps, ``ServeEngine`` completions through 3
  slots of ragged lengths, loss gradients and 3 train steps under remat
  "none", "full" and "dots", each with and without ``flash_kernel`` (MLA
  never takes flash, as in the reference), through the checks of
  tests/test_torch_qwen_phi3.py at its tolerances;
- "full" and "dots" give "none"'s gradients bit for bit;
- AdamW does not decay ``q_norm`` and ``kv_norm``, as the reference's
  ``_decay_mask`` says;
- the norm kernel's wrapper takes ``kv_norm``'s strided input as it is;
- chip_smoke.py's launch counts and the launchers.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as jax_attn  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402


def _checks():
    """tests/test_torch_qwen_phi3.py as a module: its model-level checks
    are functions of the arch."""
    path = Path(__file__).resolve().parent / "test_torch_qwen_phi3.py"
    spec = importlib.util.spec_from_file_location("qwen_phi3_checks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


checks = _checks()
ARCH = "minicpm3-4b"
F32 = torch.float32
FLASH = [False, True]
# float32: the reference's own tolerance for the flash path at model level;
# bfloat16: the kernels' (tests/test_kernels.py), relative and absolute
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def setup():
    return checks.setup_arch(ARCH)


def _layer(jparams, params, dtype):
    """The mixer of the one layer, both sides in ``dtype``."""
    jmix = jax.tree.map(lambda a: a[0].astype(getattr(jnp, dtype)),
                        jparams["blocks"]["0"]["mixer"])
    mix = {k: v[0].to(getattr(torch, dtype))
           for k, v in params["blocks"]["0"]["mixer"].items()}
    return jmix, mix


def _close(theirs, mine, dtype):
    want = np.asarray(jnp.asarray(theirs).astype(jnp.float32))
    got = mine.detach().to(F32).numpy()
    assert got.shape == want.shape
    tol = TOLS[dtype]
    assert np.all(np.abs(got - want) <= tol + tol * np.abs(want)), \
        float(np.max(np.abs(got - want)))


def test_reduced_minicpm3_layout_and_planted_leaves(setup):
    """The MLA tree (the reference's ``init_mla``), its ``ckv``/``krope``
    cache, the reduced spec (ranks 32 and 16, heads of 8 + 8 and 8), and
    every norm scale planted."""
    jcfg, cfg, jparams, params, _ = setup
    assert (cfg.n_layers, cfg.n_heads, cfg.d_head) == (1, 4, 16)
    mla = cfg.mla
    assert (mla.q_lora_rank, mla.kv_lora_rank, mla.qk_nope_head_dim,
            mla.qk_rope_head_dim, mla.v_head_dim) == (32, 16, 8, 8, 8)
    mixer = params["blocks"]["0"]["mixer"]
    assert list(mixer) == ["wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
                           "wkv_b", "wo"]
    shapes = {k: tuple(v.shape[1:]) for k, v in mixer.items()}
    assert shapes == {"wq_a": (64, 32), "q_norm": (32,), "wq_b": (32, 64),
                      "wkv_a": (64, 24), "kv_norm": (16,),
                      "wkv_b": (16, 64), "wo": (32, 64)}
    assert set(checks.flat(params)) == set(checks.flat_jax(jparams))
    planted = checks.planted_leaves(jparams)
    assert len(planted) == 5
    mine = checks.flat(params)
    for key in planted:
        assert not torch.any(mine[key] == 1), key
    cache = model_lib.init_cache(cfg, 3, 10, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache["blocks"]["0"].items()} == \
        {"ckv": (1, 3, 10, 16), "krope": (1, 3, 10, 8)}
    assert set(engine.TIME_AXIS_LEAVES) >= {"ckv", "krope"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_jax(setup, dtype):
    """The naive path over 40 tokens (three query chunks of 16): the output
    and the cache entry (the normalized latent and the rotated rope key)."""
    jcfg, cfg, jparams, params, _ = setup
    jmix, mix = _layer(jparams, params, dtype)
    x = np.random.default_rng(3).standard_normal((2, 40, 64)) \
        .astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jout, (jckv, jkrope) = jax_attn.mla_attention(jmix, jx, jcfg,
                                                  positions=jnp.arange(40))
    out, (ckv, krope) = attn_mod.mla_attention(mix, tx, cfg,
                                               positions=torch.arange(40))
    assert out.dtype == tx.dtype
    assert tuple(ckv.shape) == (2, 40, 16) and tuple(krope.shape) == (2, 40, 8)
    for theirs, mine in ((jout, out), (jckv, ckv), (jkrope, krope)):
        _close(theirs, mine, dtype)


@pytest.mark.parametrize("lens", ["scalar", "per_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(setup, dtype, lens):
    """One absorbed decode step against caches of 24 positions holding 11
    tokens (an int ``cache_len``) or 5 and 17 (a per-row one): the output
    and both caches, written in place at ``cache_len``."""
    jcfg, cfg, jparams, params, _ = setup
    jmix, mix = _layer(jparams, params, dtype)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ckv = rng.standard_normal((2, 24, 16)).astype(np.float32)
    krope = rng.standard_normal((2, 24, 8)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jl, tl = (11, 11) if lens == "scalar" else (
        jnp.asarray([5, 17]), torch.as_tensor([5, 17]))
    jout, jckv, jkrope = jax_attn.mla_decode(
        jmix, jnp.asarray(x, jdt), jcfg, jnp.asarray(ckv, jdt),
        jnp.asarray(krope, jdt), jl)
    cache_ckv = torch.from_numpy(ckv).to(tdt)
    cache_krope = torch.from_numpy(krope).to(tdt)
    out, c1, c2 = attn_mod.mla_decode(mix, torch.from_numpy(x).to(tdt), cfg,
                                      cache_ckv, cache_krope, tl)
    assert c1 is cache_ckv and c2 is cache_krope    # written in place
    for theirs, mine in ((jout, out), (jckv, c1), (jkrope, c2)):
        _close(theirs, mine, dtype)


@pytest.mark.parametrize("t", [0, 7, 16, 39])
def test_absorbed_decode_equals_the_naive_attention(setup, t):
    """float32: the prefill's cache of the first t tokens and the absorbed
    decode of token t give the naive path's output at position t over the
    first t + 1 tokens, within 2e-5."""
    _, cfg, _, params, _ = setup
    _, mix = _layer({"blocks": {"0": {"mixer": {}}}}, params, "float32") \
        if False else (None, {k: v[0] for k, v in
                              params["blocks"]["0"]["mixer"].items()})
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, t + 1, 64)).astype(np.float32))
    naive, _ = attn_mod.mla_attention(mix, x, cfg,
                                      positions=torch.arange(t + 1))
    cache_ckv = torch.zeros(2, 48, 16)
    cache_krope = torch.zeros(2, 48, 8)
    if t:
        _, (ckv, krope) = attn_mod.mla_attention(mix, x[:, :t], cfg,
                                                 positions=torch.arange(t))
        cache_ckv[:, :t], cache_krope[:, :t] = ckv, krope
    out, _, _ = attn_mod.mla_decode(mix, x[:, t:], cfg, cache_ckv,
                                    cache_krope, t)
    assert float((out[:, 0] - naive[:, t]).abs().max()) < 2e-5


@pytest.mark.parametrize("Sq,chunk", [(8, 16), (40, 16)])
def test_chunked_attention_returns_the_value_width(Sq, chunk):
    """Query and key heads of 16, value heads of 8, as MLA calls it: the
    output has the value width, the scale the query's (16^-0.5), within
    2e-5 of the reference's; over one query chunk and over three."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sq, 4, 8)).astype(np.float32)
    theirs = jax_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        chunk=chunk)
    mine = attn_mod.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=True,
                                      chunk=chunk)
    assert tuple(mine.shape) == (2, Sq, 4, 8)
    assert checks.err(theirs, mine) < 2e-5


@pytest.mark.parametrize("flash", FLASH)
def test_forward_hidden_prefill_and_caches_match(flash):
    cache = checks.check_forward_prefill_and_caches(ARCH, flash)
    assert set(cache["blocks"]["0"]) == {"ckv", "krope"}


@pytest.mark.parametrize("flash", FLASH)
def test_greedy_decode_matches(flash):
    checks.check_greedy_decode(ARCH, flash)


@pytest.mark.parametrize("flash", FLASH)
def test_completions_through_3_slots_identical_to_jax(flash):
    checks.check_completions(ARCH, flash)


@pytest.mark.parametrize("flash", FLASH)
def test_lm_loss_gradients_match_jax(flash):
    checks.check_gradients(ARCH, flash)


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_three_train_steps_match_jax(remat, flash):
    checks.check_three_train_steps(ARCH, remat, flash)


def test_remat_gives_the_gradients_of_none_bit_for_bit(monkeypatch):
    """Two stacked MLA layers, the kernel routes stood in: "full", "dots"
    and the ``remat_dots`` flag give the loss and every gradient of "none"
    bit for bit, and run each layer's four norms twice a step."""
    launches = checks.kernel_stand_ins(monkeypatch)
    _, base = checks.train_configs(ARCH, n_layers=2)
    params = ts.init_train_state(base, torch.Generator().manual_seed(0),
                                 ts.default_opt_cfg(base), device="cpu").params
    batch = SyntheticLM(DataConfig(base.vocab_size, 40, 2, 0)).batch(0)
    out = {}
    for remat, flags in (("none", ""), ("full", ""), ("dots", ""),
                         ("full", "remat_dots")):
        launches.clear()
        cfg = dataclasses.replace(base, remat=remat)
        with perf_flags(PerfFlags.parse("flash_kernel," + flags)):
            loss, grads = ts.loss_and_grads(params, cfg, batch)
        runs = 1 if remat == "none" else 2
        assert launches == {"rmsnorm": 4 * 2 * runs + 1}, (remat, flags)
        out[remat, flags] = (loss, checks.flat(grads))
    loss0, g0 = out["none", ""]
    for key, (loss, g) in out.items():
        assert torch.equal(loss, loss0), key
        assert all(torch.equal(g[k], g0[k]) for k in g0), key


def test_adamw_does_not_decay_the_mla_norms():
    """``q_norm`` and ``kv_norm`` hold ``norm`` in their key string, so the
    reference does not decay them, and neither does the port; the latent
    projections are decayed."""
    for key in ("q_norm", "kv_norm"):
        assert not jax_opt._decay_mask((jax.tree_util.DictKey(key),))
        assert not opt._decay_mask((key,))
    checks.check_decay(ARCH, decayed=("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"),
                       kept=("q_norm", "kv_norm", "scale"))


def test_kv_norm_input_is_a_strided_view_the_kernel_reads():
    """``kv_norm`` normalises the first 256 of wkv_a's 288 output columns:
    a view whose rows are 288 elements apart.  The norm kernel's wrapper
    reads it as [rows, 256] with that row stride (no copy), and the plain
    version on the CPU gives a contiguous copy's result."""
    proj = torch.randn(4, 3, 288)
    x = proj[..., :256]
    rows, stride = rn._rows("rmsnorm", x, "x", 256)
    assert tuple(rows.shape) == (12, 256) and stride == 288
    assert rows.data_ptr() == proj.data_ptr()
    s = torch.rand(256) + 0.5
    assert torch.equal(ops.rmsnorm(x, s), ops.rmsnorm(x.contiguous(), s))
    with pytest.raises(ValueError, match="no single stride"):
        rn._rows("rmsnorm", torch.randn(4, 6, 64)[:, :5], "x", 64)
    with pytest.raises(ValueError, match="contiguous"):
        rn._rows("rmsnorm", proj.transpose(1, 2), "x", 3)


def test_launch_counts_of_chip_smoke(monkeypatch):
    """MLA takes no flash, with the flag or without, and runs four norms a
    layer (ln1, ln2, ``q_norm``, ``kv_norm``): reduced, 5 a prefill or
    decode step with the final norm, and 9 a train step under remat
    "full"; at full width and depth 249 a prefill or decode step, and at 8
    layers 65 a train step."""
    checks.check_launch_counts(ARCH, monkeypatch, {"rmsnorm": 5 * 2},
                               {"rmsnorm": 9})
    cs = checks.chip_smoke()
    big = get_config(ARCH)
    for n_pre, n_dec in ((1, 0), (0, 1)):
        assert {k: v for k, v in cs.serve_launches(big, n_pre, n_dec).items()
                if v} == {"rmsnorm": 249}
    eight = dataclasses.replace(big, n_layers=8)
    assert {k: v for k, v in cs.step_launches(eight).items() if v} == \
        {"rmsnorm": 65}


def test_launchers_on_the_cpu(capsys):
    checks.check_launchers(ARCH, capsys)
