"""The port's gemma3 (5:1 sliding-window and global attention, GeGLU, tied
and scaled embeddings) against the JAX package's on the CPU, float32, with
the same bridged weights: reduced gemma3-1b, 7 layers (a stacked period of
5 local layers and 1 global, then 1 local remainder layer), window 8,
``attn_chunk`` 16, ``d_head`` 16.  Hidden states, prefill logits and
caches, 8 greedy decode steps from a prompt longer than the window,
``ServeEngine`` completions through 3 slots, loss gradients and 3 train
steps (remat "none" and "full") agree, each with and without the
``banded_local`` and ``flash_kernel`` PerfFlags (on the CPU flash is the
plain version; the reference's gate sends only the global layer to it).

Tolerances are tests/test_torch_model.py's and tests/test_torch_train.py's:
5e-5 for hidden states, logits and caches (the reference's own for the
flash path at model level); for the loss 1e-5 relative, for gradients
5e-3 absolute and 1e-4 of each leaf's largest; after 3 steps chip_smoke.py's
``update_gaps``.

Also the GeGLU MLP against ``jax.nn.gelu``'s tanh approximation, the
launchers on reduced gemma3, and the launch counts that chip_smoke.py
expects of a serve and a train step (flash for global layers only).
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.perf_flags import PerfFlags as JaxFlags  # noqa: E402
from repro.models.perf_flags import perf_flags as jax_perf_flags  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.train import DataConfig as JaxDataConfig  # noqa: E402
from repro.train import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import _guard, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402
from repro_torch.monitor import JobRegistry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCH = "gemma3-1b"
F32 = torch.float32
TOL = 5e-5
B, S, STEPS = 2, 40, 8      # 40 tokens: three query chunks of 16, so the
#                             band (32 keys) engages; 5 windows of 8
CPU_FIGURES = dict(peak_flops=1e12, mem_total_gb=16.0)
# (banded_local, flash_kernel)
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _flags(banded, flash):
    return (JaxFlags(banded_local=banded, flash_kernel=flash),
            PerfFlags(banded_local=banded, flash_kernel=flash))


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch only in main)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_reduced(ARCH), reduced_config(ARCH)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return jcfg, cfg, jparams, params, tokens


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().to(F32).numpy())))


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


def test_reduced_gemma3_layout(setup):
    """One stacked period of 5 local layers and a global one, then a local
    remainder layer; GeGLU FFNs with w3; the tree is the reference's."""
    _, cfg, jparams, params, _ = setup
    assert (cfg.n_layers, cfg.period, cfg.n_periods, cfg.n_remainder) == \
        (7, 6, 1, 1)
    assert (cfg.attn_window, cfg.attn_chunk, cfg.d_head) == (8, 16, 16)
    assert cfg.layer_pattern == ("attn_local",) * 5 + ("attn",)
    assert cfg.embed_scale == math.sqrt(cfg.d_model)
    assert set(params["blocks"]["0"]["mlp"]) == {"w1", "w2", "w3"}
    assert set(_flat(params)) == set(_flat_jax(jparams))


@pytest.mark.parametrize("banded,flash", FLAGS)
def test_forward_hidden_prefill_and_caches_match(setup, banded, flash):
    jcfg, cfg, jparams, params, tokens = setup
    jflags, flags = _flags(banded, flash)
    with jax_perf_flags(jflags):
        jh, _ = jax_tf.forward_hidden(jparams, jcfg, jnp.asarray(tokens))
        jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens))
    with perf_flags(flags):
        h, _ = tf.forward_hidden(params, cfg, torch.from_numpy(tokens))
        logits, cache = model_lib.prefill(params, cfg,
                                          torch.from_numpy(tokens))
    assert h.shape == (B, S, cfg.d_model) and logits.dtype == F32
    assert _err(jh, h) < TOL
    assert _err(jlogits, logits) < TOL
    jflat, flat = _flat_jax(jcache), _flat(cache)
    assert set(flat) == set(jflat)
    for path, arr in jflat.items():
        assert tuple(flat[path].shape) == arr.shape, path
        assert _err(arr, flat[path]) < TOL, path


@pytest.mark.parametrize("banded", [False, True])
def test_banded_local_takes_the_band_on_local_layers_only(setup, monkeypatch,
                                                          banded):
    """Under the flag each local layer's query chunks read 32 keys (the
    band: chunk 16 + one chunk for the window of 8), the global layer all
    40; without it every layer reads all 40."""
    _, cfg, _, params, tokens = setup
    widths = []
    attend = attn_mod._attend_block

    def recorded(qc, k, *args, **kw):
        widths.append((kw["window"] is not None, k.shape[1]))
        return attend(qc, k, *args, **kw)

    monkeypatch.setattr(attn_mod, "_attend_block", recorded)
    with perf_flags(PerfFlags(banded_local=banded)):
        tf.forward_hidden(params, cfg, torch.from_numpy(tokens))
    local = {w for is_local, w in widths if is_local}
    glob = {w for is_local, w in widths if not is_local}
    assert local == ({32} if banded else {S}) and glob == {S}
    assert len(widths) == 3 * cfg.n_layers      # three chunks a layer


@pytest.mark.parametrize("banded,flash", FLAGS)
def test_greedy_decode_past_the_window_matches(setup, banded, flash):
    """A prefill of 40 tokens (five windows) and 8 greedy decode steps: the
    same tokens, logits and caches.  The local layers' caches are full
    length, their window a mask."""
    jcfg, cfg, jparams, params, tokens = setup
    jflags, flags = _flags(banded, flash)
    with jax_perf_flags(jflags):
        jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens))
    with perf_flags(flags):
        logits, cache = model_lib.prefill(params, cfg,
                                          torch.from_numpy(tokens))

    def grow(c, pad):   # room for the decode steps on the time axis
        return {p: {k: {n: pad(t) for n, t in e.items()}
                    for k, e in part.items()} for p, part in c.items()}

    jcache = grow(jcache, lambda t: jnp.pad(
        t, [(0, 0)] * (t.ndim - 3) + [(0, STEPS), (0, 0), (0, 0)]))
    cache = grow(cache, lambda t: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, STEPS)))
    jdecode = jax.jit(lambda p, t, c, n: jax_tf.decode_step(p, jcfg, t, c, n))
    jtok, tok = jnp.argmax(jlogits, axis=-1), torch.argmax(logits, dim=-1)
    for step in range(STEPS):
        assert np.array_equal(np.asarray(jtok), tok.numpy()), step
        jlogits, jcache = jdecode(jparams, jtok[:, None], jcache, S + step)
        with perf_flags(flags):
            logits, cache = model_lib.decode_step(params, cfg, tok[:, None],
                                                  cache, S + step)
        assert _err(jlogits, logits) < TOL, step
        jtok, tok = jnp.argmax(jlogits, axis=-1), torch.argmax(logits, dim=-1)
    assert np.array_equal(np.asarray(jtok), tok.numpy())
    flat = _flat(cache)
    for path, arr in _flat_jax(jcache).items():
        assert tuple(flat[path].shape) == arr.shape, path
        assert _err(arr, flat[path]) < TOL, path


def test_local_rope_base_and_window_are_read(setup):
    """The local layers' own rope base and window change the output: with
    either set to the global layer's, the hidden states move far past the
    tolerance (so a port that ignored them would fail the tests above)."""
    _, cfg, _, params, tokens = setup
    h, _ = tf.forward_hidden(params, cfg, torch.from_numpy(tokens))
    for change in ({"rope_theta_local": None}, {"attn_window": S}):
        other, _ = tf.forward_hidden(
            params, dataclasses.replace(cfg, **change), torch.from_numpy(tokens))
        assert float((other - h).abs().max()) > 100 * TOL, change


@pytest.mark.parametrize("banded,flash", [(False, False), (True, True)])
def test_completions_through_3_slots_identical_to_jax(setup, banded, flash):
    """Prompts of 2, 8 and 40 tokens and decodes past the window through 3
    slots: every refill splices k and v along the time axis of the local
    and global caches alike (``TIME_AXIS_LEAVES``), and the completions
    agree token for token."""
    jcfg, cfg, jparams, params, _ = setup
    assert engine.TIME_AXIS_LEAVES[:2] == ("k", "v")
    rng = np.random.default_rng(12)
    lens = (2, 8, 40, 8, 2, 40, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    jeng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=3, max_seq_len=64, monitor=False))
    job = f"serve-gemma3-{banded}-{flash}"
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=3, max_seq_len=64, job_name=job, device="cpu",
        **CPU_FIGURES))
    for i, prompt in enumerate(prompts):
        jeng.submit(jax_engine.Request(i, prompt, max_new_tokens=10 + i % 3))
        eng.submit(engine.Request(i, prompt, max_new_tokens=10 + i % 3))
    jflags, flags = _flags(banded, flash)
    with jax_perf_flags(jflags):
        jeng.run()
    with perf_flags(flags):
        stats = eng.run()
    theirs = {c.request_id: c.tokens for c in jeng.completions}
    mine = {c.request_id: c.tokens for c in eng.completions}
    assert mine == theirs and stats["requests"] == len(lens)
    assert 0 < JobRegistry.global_registry().entries()[job].duty_cycle
    JobRegistry.global_registry().remove(job)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def _configs(**changes):
    return (dataclasses.replace(jax_reduced(ARCH), **changes),
            dataclasses.replace(reduced_config(ARCH), **changes))


def _masters(jcfg, cfg):
    jstate = jax_ts.init_train_state(jcfg, jax.random.PRNGKey(0),
                                     jax_ts.default_opt_cfg(jcfg))
    params = from_jax_params(jax.tree.map(np.asarray, jstate.params), cfg,
                             "cpu", dtype=F32)
    return jstate, params


def _jax_batch(cfg, step):
    b = JaxSyntheticLM(JaxDataConfig(cfg.vocab_size, S, B, 0)).batch(step)
    return b, {k: torch.from_numpy(np.asarray(v).astype(np.int64))
               for k, v in b.items()}


def _jax_paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("banded,flash", FLAGS)
def test_lm_loss_gradients_match_jax(banded, flash):
    """The loss within 1e-5 relative; each leaf's gradient within 5e-3 and
    within 1e-4 of its largest."""
    jcfg, cfg = _configs()
    jstate, params = _masters(jcfg, cfg)
    jb, batch = _jax_batch(cfg, 0)
    jflags, flags = _flags(banded, flash)
    with jax_perf_flags(jflags):
        jl, jg = jax.value_and_grad(lambda p: jax_tf.lm_loss(
            p, jcfg, jb["tokens"], jb["labels"]))(jstate.params)
    with perf_flags(flags):
        loss, grads = ts.loss_and_grads(params, cfg, batch)
    jg, grads = _jax_paths(jg), _flat(grads)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(grads) == set(jg)
    for key, g in grads.items():
        err = float(np.max(np.abs(g.detach().numpy() - jg[key])))
        peak = float(np.max(np.abs(jg[key])))
        assert err < 5e-3 and err <= 1e-4 * peak, (key, err, peak)


@pytest.mark.parametrize("banded,flash", [(False, False), (True, True)])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_three_train_steps_match_jax(remat, banded, flash):
    """Losses within 1e-5 relative and parameters within ``update_gaps``'
    bounds after 3 AdamW steps, ``cfg.remat`` and the flags the same on
    both sides (under "full" the recompute takes the forward's routes)."""
    jcfg, cfg = _configs(remat=remat)
    jstate, params = _masters(jcfg, cfg)
    jb, _ = _jax_batch(cfg, 0)
    jflags, flags = _flags(banded, flash)
    with jax_perf_flags(jflags):
        g1 = _jax_paths(jax.grad(lambda p: jax_tf.lm_loss(
            p, jcfg, jb["tokens"], jb["labels"]))(jstate.params))
        jstep = jax.jit(jax_ts.make_train_step(
            jcfg, jax_ts.default_opt_cfg(jcfg, total_steps=3)))
        ocfg = ts.default_opt_cfg(cfg, total_steps=3)
        step_fn = ts.make_train_step(cfg, ocfg)
        state = ts.TrainState(params, opt.init_opt_state(params, ocfg))
        lrs = []
        for k in range(3):
            jb, batch = _jax_batch(cfg, k)
            jstate, jmet = jstep(jstate, jb)
            with perf_flags(flags):
                state, met = step_fn(state, batch)
            assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
                1e-5 * abs(float(jmet["loss"]))
            lrs.append(met["lr"])
    want = {k: torch.from_numpy(v.copy())
            for k, v in _jax_paths(jstate.params).items()}
    g1 = {k: torch.from_numpy(v.copy()) for k, v in g1.items()}
    tight, loose, held = _chip_smoke().update_gaps(_flat(state.params),
                                                   want, g1, lrs)
    assert tight <= 1 and loose <= 1, (tight, loose)
    assert held > 0.25


# --------------------------------------------------------------------------
# GeGLU
# --------------------------------------------------------------------------


def test_geglu_is_the_tanh_gelu_of_jax():
    """``mlp`` with ``geglu`` is ``jax.nn.gelu``'s default, the tanh
    approximation; the exact (erf) GELU differs from it past the
    tolerance, so a port that took it would fail."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 7, 32)).astype(np.float32) * 2
    p = {"w1": rng.standard_normal((32, 64)).astype(np.float32) * 0.3,
         "w3": rng.standard_normal((32, 64)).astype(np.float32) * 0.3,
         "w2": rng.standard_normal((64, 32)).astype(np.float32) * 0.2}
    want = np.asarray(jax_layers.mlp(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), "geglu"))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    got = layers.mlp(tp, tx, "geglu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    h = tx @ tp["w1"]
    erf = ((torch.nn.functional.gelu(h, approximate="none") * (tx @ tp["w3"]))
           @ tp["w2"]).numpy()
    assert np.max(np.abs(erf - want)) > 100 * 1e-5
    gelu = np.asarray(jax_layers.mlp(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), "gelu"))
    np.testing.assert_allclose(layers.mlp(tp, tx, "gelu").numpy(), gelu,
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# chip_smoke's launch counts, with the kernel routes stood in
# --------------------------------------------------------------------------


def _kernel_stand_ins(monkeypatch):
    """Every kernel wrapper counts its launch and runs the plain version,
    and ``kernels.ops`` takes the kernel route for CPU tensors."""
    launches = {}

    def stand_in(module, attr, name, plain):
        def call(*args, **kw):
            _guard.refuse_autograd(attr, *args)
            launches[name] = launches.get(name, 0) + 1
            return plain(*args, **kw)
        monkeypatch.setattr(module, attr, call)

    stand_in(fa, "flash_attention_bshd", "flash_attention",
             ops._attention_bshd_ref)
    stand_in(rn, "rmsnorm", "rmsnorm", ref.rmsnorm_ref)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    return launches


def test_launch_counts_of_chip_smoke(setup, monkeypatch):
    """``serve_launches`` and ``step_launches`` count flash for the global
    layers only (local layers take chunked attention), and so does the
    model: a prefill and a decode step of reduced gemma3, and a train step
    under remat "full" (the stacked period's kernels run again in the
    recompute).  At full width and depth they give chip_smoke's 4 flash
    and 53 RMSNorm launches a prefill, 53 a decode step, 8 and 101 a
    train step."""
    cs = _chip_smoke()
    _, cfg, _, params, tokens = setup
    launches = _kernel_stand_ins(monkeypatch)
    flags = PerfFlags(flash_kernel=True, banded_local=True)
    with perf_flags(flags):
        _, cache = model_lib.prefill(params, cfg, torch.from_numpy(tokens))
        cache = {p: {k: {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 1))
                         for n, t in e.items()} for k, e in part.items()}
                 for p, part in cache.items()}
        model_lib.decode_step(params, cfg, torch.zeros(B, 1, dtype=torch.long),
                              cache, S)
    want = {k: v for k, v in cs.serve_launches(cfg, 1, 1).items() if v}
    assert launches == want == {"flash_attention": 1, "rmsnorm": 2 * 15}
    launches.clear()
    full = dataclasses.replace(cfg, remat="full")
    with perf_flags(flags):
        ts.loss_and_grads(params, full, _jax_batch(cfg, 0)[1])
    want = {k: v for k, v in cs.step_launches(full).items() if v}
    assert launches == want == {"flash_attention": 2, "rmsnorm": 27}
    from repro_torch.configs import get_config
    big = get_config(ARCH)
    assert {k: v for k, v in cs.serve_launches(big, 1, 0).items() if v} == \
        {"flash_attention": 4, "rmsnorm": 53}
    assert cs.serve_launches(big, 0, 1)["rmsnorm"] == 53
    assert {k: v for k, v in cs.step_launches(big).items() if v} == \
        {"flash_attention": 8, "rmsnorm": 101}


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------


def test_launch_serve_gemma3_on_the_cpu(capsys):
    rc = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--requests", "3", "--slots", "2",
                            "--prompt-len", "20", "--max-new", "4",
                            "--flags", "banded_local,flash_kernel",
                            "--peak-flops", "1e12", "--mem-total-gb", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"[serve:{ARCH}-reduced] 3 requests, 12 tokens" in out
    assert "LLload view: duty=" in out


def test_launch_train_gemma3_on_the_cpu(capsys):
    rc = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", "32",
                            "--flags", "banded_local,flash_kernel",
                            "--peak-flops", "1e12", "--mem-total-gb", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in
              out.split("[launch.train] losses:")[1].splitlines()[0].split()]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "[launch.train] done: steps=3 " in out
