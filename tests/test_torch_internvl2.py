"""The port's vision-language model (internvl2: the patch frontend on a
GQA decoder) against the JAX package on the CPU, float32, with the same
bridged weights: reduced internvl2-2b (one layer of 4 query and 2 KV heads
of 16, G = 2, rope base 1e6; 8 stub patches before the tokens), every
norm scale planted with values drawn by numpy from a seed in both
packages.  The patches are the JAX package's ``SyntheticLM.frontend``,
fed to both sides.

- the model with patches: hidden states over P + S positions, prefill
  logits and caches, 8 greedy decode steps at ``cache_len`` P + S + step,
  decode against prefill, the loss (its labels padded with P entries of
  -1 in front) and every leaf's gradient under remat "none", "full" and
  "dots", with neither flag, either or both (``flash_kernel``,
  ``bf16_grads``), 3 train steps with the patches in the batch,
  checkpoints written by either package and restored by the other
  (tests/test_torch_whisper.py's checks, run on this arch);
- patches in float32 for a bfloat16 model are cast to the embedding's
  dtype, in both packages;
- ``ServeEngine`` serves the model as a text-only LM, as the reference's:
  completions through 3 slots equal the reference's token for token;
- the launchers and chip_smoke.py's launch counts.

Tolerances are those of tests/test_torch_whisper.py.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402


def _whisper_checks():
    """tests/test_torch_whisper.py as a module: its model-level checks are
    functions of the arch."""
    path = Path(__file__).resolve().parent / "test_torch_whisper.py"
    spec = importlib.util.spec_from_file_location("whisper_checks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


w = _whisper_checks()
checks = w.checks
ARCH = "internvl2-2b"
B, S, P = w.B, w.S, 8


def test_reduced_layout_and_planted_leaves():
    """Reduced internvl2 keeps GQA (4 query and 2 KV heads of 16), its rope
    base and 8 patches; no encoder and no cross attention; the tree is the
    reference's; every norm scale is planted."""
    _, cfg, jparams, params, _, fe = w.setup(ARCH)
    assert (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head) == \
        (1, 4, 2, 16)
    assert (cfg.frontend, cfg.frontend_len, cfg.rope_theta) == \
        ("patch_stub", P, 1e6)
    assert fe.shape == (B, P, 64)
    assert set(params) == {"embed", "blocks", "rem", "final_norm", "lm_head"}
    assert set(params["blocks"]["0"]) == {"ln1", "ln2", "mixer", "mlp"}
    assert set(checks.flat(params)) == set(checks.flat_jax(jparams))
    planted = checks.planted_leaves(jparams)
    assert len(planted) == 3
    mine = checks.flat(params)
    for key in planted:
        assert not torch.any(mine[key] == 1), key


@pytest.mark.parametrize("flash", w.FLASH)
def test_prefill_and_caches_match(flash):
    """The caches hold P + S positions: patches and tokens."""
    mine = w.check_prefill_and_caches(ARCH, flash)
    assert mine["['blocks']['0']['k']"].shape == (1, B, P + S, 2, 16)


@pytest.mark.parametrize("flash", w.FLASH)
def test_greedy_decode_matches(flash):
    w.check_greedy_decode(ARCH, flash)


def test_decode_equals_prefill():
    w.check_decode_equals_prefill(ARCH)


@pytest.mark.parametrize("flash,bf16_grads", w.FLAGS)
@pytest.mark.parametrize("remat", w.REMATS)
def test_lm_loss_gradients_match_jax(remat, flash, bf16_grads):
    w.check_gradients(ARCH, remat, flash, bf16_grads)


@pytest.mark.parametrize("remat,flash", [("full", True), ("none", False)])
def test_three_train_steps_match_jax(remat, flash):
    w.check_three_train_steps(ARCH, remat, flash)


def test_checkpoints_both_ways(tmp_path):
    w.check_checkpoints_both_ways(ARCH, tmp_path)


def test_patch_labels_are_padded():
    """The loss with P patches is the CE of the hidden states after the
    patches against the labels: the patch positions carry none."""
    _, cfg, _, params, tokens, fe = w.setup(ARCH)
    t, f = torch.from_numpy(tokens), torch.from_numpy(fe)
    labels = torch.roll(t, -1, dims=1)
    loss = model_lib.lm_loss(params, cfg, t, labels, f)
    hidden, _ = tf.forward_hidden(params, cfg, t, f)
    assert hidden.shape[1] == P + S
    want = tf.chunked_ce_loss(params, cfg, hidden[:, P:], labels)
    assert float((loss - want).abs()) < 1e-6


def test_patches_are_cast_to_the_embedding_dtype():
    """float32 patches for a bfloat16 model: both packages cast them to the
    embedding's dtype, so they give the logits of patches cast first."""
    jcfg, cfg, jparams, _, tokens, fe = w.setup(ARCH, dtype="bfloat16")
    jl32, _ = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens),
                             jnp.asarray(fe))
    jl16, _ = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens),
                             jnp.asarray(fe, jnp.bfloat16))
    assert np.array_equal(np.asarray(jl32), np.asarray(jl16))
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    t, f = torch.from_numpy(tokens), torch.from_numpy(fe)
    l32, cache = model_lib.prefill(params, cfg, t, f)
    l16, _ = model_lib.prefill(params, cfg, t, f.to(torch.bfloat16))
    assert torch.equal(l32, l16)
    assert cache["blocks"]["0"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("flash", w.FLASH)
def test_completions_through_3_slots_identical_to_jax(flash):
    """Text only, as the reference's engine serves it."""
    checks.check_completions(ARCH, flash)


def test_launchers_on_the_cpu(capsys):
    checks.check_launchers(ARCH, capsys)


def test_launch_counts_of_chip_smoke(monkeypatch):
    """Reduced, with patches (P + S = 48: flash takes it): flash 1 and
    RMSNorm 3 a prefill, 3 a decode step; a train step under remat "full"
    2 and 5.  At full width and depth: 24 flash and 49 RMSNorm a prefill,
    49 a decode step; 48 flash and 97 RMSNorm a train step."""
    w.check_launch_counts(ARCH, monkeypatch,
                          {"flash_attention": 1, "rmsnorm": 3 + 3},
                          {"flash_attention": 2, "rmsnorm": 5})
    big, smoke = get_config(ARCH), w.smoke
    assert {k: v for k, v in smoke.serve_launches(big, 1, 0).items() if v} == \
        {"flash_attention": 24, "rmsnorm": 49}
    assert {k: v for k, v in smoke.serve_launches(big, 0, 1).items() if v} == \
        {"rmsnorm": 49}
    assert {k: v for k, v in smoke.step_launches(big).items() if v} == \
        {"flash_attention": 48, "rmsnorm": 97}
