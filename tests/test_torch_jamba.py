"""The port's jamba hybrid (Mamba-2 and attention layers in one period, MoE
on the odd slots) against the JAX package's on the CPU, float32, with the
same bridged weights: reduced jamba-1.5-large-398b (one period of 8: slot
4 attention, the others Mamba-2; MoE on slots 1, 3, 5, 7), and 13 of its
layers (a stacked period plus 5 remainder layers, the layout of the
5-layer full-width serve).  Hidden states, prefill logits, caches, the MoE
auxiliary losses, 8 greedy decode steps and ``ServeEngine`` completions
through 2 and 3 slots agree, the tokens exactly.  Tolerance 5e-5, the
reference's own for the flash path at model level
(tests/test_flash_integration.py); the errors are 5e-6 to 1e-5.

Also the launchers on reduced jamba, and the sliced draw that lets
``init_params`` draw full-width weights on the card.
"""
import dataclasses
import math

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
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402
from repro_torch.monitor import JobRegistry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ARCH = "jamba-1.5-large-398b"
TOL = 5e-5
B, S, STEPS = 2, 40, 8      # 40 tokens: three SSD chunks of 16, one padded
CPU_FIGURES = dict(peak_flops=1e12, mem_total_gb=16.0)


def _configs(n_layers=None):
    jcfg, cfg = jax_reduced(ARCH), reduced_config(ARCH)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


@pytest.fixture(scope="module", params=[8, 13])
def setup(request):
    jcfg, cfg = _configs(request.param)
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
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


def test_reduced_jamba_mixes_every_layer_kind(setup):
    _, cfg, jparams, params, _ = setup
    assert cfg.family == "hybrid" and cfg.n_periods == 1
    assert cfg.n_remainder == cfg.n_layers - 8
    blocks = params["blocks"]
    assert "wq" in blocks["4"]["mixer"] and "in_proj" in blocks["0"]["mixer"]
    assert "router" in blocks["1"]["mlp"] and "w1" in blocks["0"]["mlp"]
    assert set(_flat(params)) == set(_flat_jax(jparams))


@pytest.mark.parametrize("flash", [False, True])
def test_forward_hidden_prefill_and_caches_match(setup, flash):
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
    jflat, flat = _flat_jax(jcache), _flat(cache)
    assert set(flat) == set(jflat)
    assert {p.split("[")[-1] for p in flat} == {"'k']", "'v']", "'conv']",
                                                "'ssd']"}
    for path, arr in jflat.items():
        assert tuple(flat[path].shape) == arr.shape, path
        assert str(flat[path].dtype).split(".")[1] == str(arr.dtype), path
        assert _err(arr, flat[path]) < TOL, path


def test_init_cache_tree_matches(setup):
    jcfg, cfg, *_ = setup
    ref = _flat_jax(jax_tf.init_cache(jcfg, 3, 24))
    mine = _flat(model_lib.init_cache(cfg, 3, 24, device="cpu"))
    assert set(mine) == set(ref)
    for path, t in mine.items():
        assert tuple(t.shape) == ref[path].shape, path
        assert str(t.dtype).split(".")[1] == str(ref[path].dtype), path
        assert not t.any(), path


def test_aux_losses_match(setup):
    """(load_balance, z) of the MoE slots, summed and divided by every
    layer, as the reference counts them."""
    jcfg, cfg, jparams, params, tokens = setup
    _, _, jaux = jax_tf.forward_hidden(jparams, jcfg, jnp.asarray(tokens),
                                       want_aux=True)
    _, _, aux = tf.forward_hidden(params, cfg, torch.from_numpy(tokens),
                                  want_aux=True)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_greedy_decode_matches(setup, flash):
    """A prefill of 40 tokens and 8 greedy decode steps: the same tokens,
    logits and caches (the attention layer's k, v rows past the prompt
    and the Mamba-2 layers' conv and ssd states)."""
    jcfg, cfg, jparams, params, tokens = setup
    with jax_perf_flags(JaxFlags(flash_kernel=flash)):
        jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens))
    with perf_flags(PerfFlags(flash_kernel=flash)):
        logits, cache = model_lib.prefill(params, cfg,
                                          torch.from_numpy(tokens))

    def grow(c, pad):   # room for the decode steps on the time axis
        return {p: {k: {n: pad(t) if n in ("k", "v") else t
                        for n, t in e.items()} for k, e in part.items()}
                for p, part in c.items()}

    jcache = grow(jcache, lambda t: jnp.pad(
        t, [(0, 0)] * (t.ndim - 3) + [(0, STEPS), (0, 0), (0, 0)]))
    cache = grow(cache, lambda t: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, STEPS)))
    jdecode = jax.jit(lambda p, t, c, n: jax_tf.decode_step(p, jcfg, t, c, n))
    jtok, tok = jnp.argmax(jlogits, axis=-1), torch.argmax(logits, dim=-1)
    for step in range(STEPS):
        assert np.array_equal(np.asarray(jtok), tok.numpy()), step
        jlogits, jcache = jdecode(jparams, jtok[:, None], jcache, S + step)
        logits, cache = model_lib.decode_step(params, cfg, tok[:, None],
                                              cache, S + step)
        assert _err(jlogits, logits) < TOL, step
        jtok, tok = jnp.argmax(jlogits, axis=-1), torch.argmax(logits, dim=-1)
    assert np.array_equal(np.asarray(jtok), tok.numpy())
    flat = _flat(cache)
    for path, arr in _flat_jax(jcache).items():
        assert tuple(flat[path].shape) == arr.shape, path
        assert _err(arr, flat[path]) < TOL, path


# --------------------------------------------------------------------------
# ServeEngine against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("slots,flash", [(2, False), (3, True)])
def test_completions_identical_to_jax(setup, slots, flash):
    """Prompts of 2 tokens (shorter than the conv), 8 and 40 (three SSD
    chunks of 16) through 2 slots and through 3, whose decode tokens form
    one MoE group: every refill splices k and v along the time axis and
    copies the conv and ssd rows whole into a slot another request used
    before, and the completions agree token for token."""
    jcfg, cfg, jparams, params, _ = setup
    rng = np.random.default_rng(12)
    lens = (2, 8, 40, 8, 2, 40, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    jeng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=slots, max_seq_len=64, monitor=False))
    job = f"serve-jamba-{cfg.n_layers}-{slots}"
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=slots, max_seq_len=64, job_name=job, device="cpu",
        **CPU_FIGURES))
    for i, prompt in enumerate(prompts):
        jeng.submit(jax_engine.Request(i, prompt, max_new_tokens=4 + i % 3))
        eng.submit(engine.Request(i, prompt, max_new_tokens=4 + i % 3))
    jeng.run()
    with perf_flags(PerfFlags(flash_kernel=flash)):
        stats = eng.run()
    theirs = {c.request_id: c.tokens for c in jeng.completions}
    mine = {c.request_id: c.tokens for c in eng.completions}
    assert mine == theirs and stats["requests"] == len(lens)
    assert 0 < JobRegistry.global_registry().entries()[job].duty_cycle
    JobRegistry.global_registry().remove(job)


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------


def test_launch_serve_jamba_on_the_cpu(capsys):
    rc = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--requests", "3", "--slots", "2",
                            "--prompt-len", "20", "--max-new", "4",
                            "--flags", "flash_kernel", "--peak-flops",
                            "1e12", "--mem-total-gb", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"[serve:{ARCH}-reduced] 3 requests, 12 tokens" in out
    assert "LLload view: duty=" in out and "Overload controller" in out


def test_launch_train_jamba_on_the_cpu(capsys):
    """bf16 moments (the config's ``opt_dtype``); the published duty's
    model FLOPs are those of the active parameters."""
    rc = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", "32",
                            "--peak-flops", "1e12", "--mem-total-gb", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in
              out.split("[launch.train] losses:")[1].splitlines()[0].split()]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "[launch.train] done: steps=3 " in out and "start_step=0" in out
    pub = JobRegistry.global_registry().entries()[f"train:{ARCH}-reduced"]
    cfg = reduced_config(ARCH)
    active = model_lib.count_params_analytic(cfg, True)
    assert active < model_lib.count_params(cfg)
    assert pub.achieved_flops == pytest.approx(
        6 * active * 2 * 32 / pub.step_time_s)


# --------------------------------------------------------------------------
# init_params' sliced draw
# --------------------------------------------------------------------------


def test_sliced_draw_fills_each_slice_from_the_generator_in_turn():
    """``_draw`` in slices of 1000 of a [3, 700] bf16 leaf: each slice holds
    the next draw of its size from the generator, times std, rounded to
    bf16; the values lie within two std."""
    out = torch.empty(3, 700, dtype=torch.bfloat16)
    tf._draw(out, 0.02, torch.Generator().manual_seed(5), 1000)
    gen = torch.Generator().manual_seed(5)
    want = []
    for n in (1000, 1000, 100):
        t = torch.empty(n)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        want.append((t * 0.02).to(torch.bfloat16))
    assert torch.equal(out.view(-1), torch.cat(want))
    assert float(out.float().abs().max()) <= 0.04 * (1 + 2 ** -8)


def test_init_params_from_a_cpu_generator_draws_whole_leaves(monkeypatch):
    """A CPU generator draws every leaf whole, whatever ``DRAW_SLICE``
    says: the values do not depend on the slice, so a seed gives the same
    weights on every device as before."""
    cfg = reduced_config(ARCH)
    a = model_lib.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    monkeypatch.setattr(tf, "DRAW_SLICE", 7)
    b = model_lib.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tf.leaves(a), tf.leaves(b)))
