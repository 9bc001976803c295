"""The port's qwen1.5 (QKV bias) and phi3 (GQA, 40 query and 10 KV heads)
against the JAX package on the CPU, float32, with the same bridged
weights: reduced qwen1.5-4b (4 query and 4 KV heads of 16, biases on q, k
and v) and reduced phi3-medium-14b (4 query and 2 KV heads of 16, G = 2).

The reference initializes the biases to zeros and every norm scale to
ones, so a test that carried init weights across would pass with the bias
add or a norm scale missing: every bias and norm scale is planted with
values drawn by numpy from a seed (``plant``) before ``from_jax_params``,
in both packages.

Hidden states, prefill logits and caches, 8 greedy decode steps,
``ServeEngine`` completions through 3 slots of ragged lengths, loss
gradients and 3 train steps under remat "none", "full" and "dots" agree,
each with and without ``flash_kernel`` (on the CPU flash is the plain
version; the JAX side runs its Pallas kernel in interpret mode).
Tolerances are tests/test_torch_model.py's and tests/test_torch_train.py's:
5e-5 for hidden states, logits and caches; for the loss 1e-5 relative, for
gradients 5e-3 absolute and 1e-4 of each leaf's largest; after 3 steps
chip_smoke.py's ``update_gaps``.

The model-level checks are functions of the arch, so that
tests/test_torch_mla.py runs them on reduced minicpm3-4b too.  Also: GQA
with phi3's full 40 query and 10 KV heads through flash, chunked attention
and decode; the biases are decayed by AdamW, as the reference's
``_decay_mask`` says; the launchers; and chip_smoke.py's launch counts.
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
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.perf_flags import PerfFlags as JaxFlags  # noqa: E402
from repro.models.perf_flags import perf_flags as jax_perf_flags  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.train import DataConfig as JaxDataConfig  # noqa: E402
from repro.train import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import _guard, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402
from repro_torch.monitor import JobRegistry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCHS = ["qwen1.5-4b", "phi3-medium-14b"]
F32 = torch.float32
TOL = 5e-5
B, S, STEPS = 2, 40, 8      # 40 tokens: three query chunks of 16
CPU_FIGURES = dict(peak_flops=1e12, mem_total_gb=16.0)
FLASH = [False, True]


def chip_smoke():
    """chip_smoke.py as a module (it imports torch only in main)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(flash):
    return JaxFlags(flash_kernel=flash), PerfFlags(flash_kernel=flash)


# Leaves the reference initializes to a constant: the QKV biases (zeros)
# and every norm scale (ones), by the last key of their path.
BIASES = ("['bq']", "['bk']", "['bv']")
PLANTED = BIASES + ("['scale']", "['q_norm']", "['kv_norm']")


def plant(tree, seed=7):
    """The JAX parameter tree with every bias drawn from N(0, 0.5^2) and
    every norm scale from 1 + N(0, 0.3^2), by numpy from ``seed``; the
    other leaves as they are."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if not key.endswith(PLANTED):
            return a
        noise = rng.standard_normal(a.shape).astype(np.float32)
        base = 0.0 if key.endswith(BIASES) else 1.0
        scale = 0.5 if base == 0.0 else 0.3
        return jnp.asarray(base + scale * noise, a.dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


def planted_leaves(tree):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]
            if jax.tree_util.keystr(p).endswith(PLANTED)]


def setup_arch(arch, **changes):
    """(JAX config, port config, planted JAX params, bridged port params,
    tokens [B,S])."""
    jcfg = dataclasses.replace(jax_reduced(arch), **changes)
    cfg = dataclasses.replace(reduced_config(arch), **changes)
    jparams = plant(jax_init(jcfg, jax.random.PRNGKey(0)))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return jcfg, cfg, jparams, params, tokens


def err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().to(F32).numpy())))


def flat_jax(tree):
    return {jax.tree_util.keystr(p): a
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


def grow_jax(cache, n):
    """Room for ``n`` more tokens on the time axis of every cache leaf (the
    axis after the batch: 2 in the stacked blocks, 1 in the remainder)."""
    def pad(t, axis):
        widths = [(0, 0)] * t.ndim
        widths[axis] = (0, n)
        return jnp.pad(t, widths)

    return {part: {key: {name: pad(t, 2 if part == "blocks" else 1)
                         for name, t in entry.items()}
                   for key, entry in entries.items()}
            for part, entries in cache.items()}


def grow(cache, n):
    """``grow_jax`` of the port's cache tree."""
    def pad(t, axis):
        shape = list(t.shape)
        shape[axis] = n
        return torch.cat([t, t.new_zeros(shape)], dim=axis)

    return {part: {key: {name: pad(t, 2 if part == "blocks" else 1)
                         for name, t in entry.items()}
                   for key, entry in entries.items()}
            for part, entries in cache.items()}


# --------------------------------------------------------------------------
# the model-level checks, shared with tests/test_torch_mla.py
# --------------------------------------------------------------------------


def check_forward_prefill_and_caches(arch, flash):
    jcfg, cfg, jparams, params, tokens = setup_arch(arch)
    jflags, flags = _flags(flash)
    with jax_perf_flags(jflags):
        jh, _ = jax_tf.forward_hidden(jparams, jcfg, jnp.asarray(tokens))
        jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens))
    with perf_flags(flags):
        h, _ = tf.forward_hidden(params, cfg, torch.from_numpy(tokens))
        logits, cache = model_lib.prefill(params, cfg,
                                          torch.from_numpy(tokens))
    assert h.shape == (B, S, cfg.d_model) and logits.dtype == F32
    assert err(jh, h) < TOL
    assert err(jlogits, logits) < TOL
    jflat, mine = flat_jax(jcache), flat(cache)
    assert set(mine) == set(jflat)
    for path, arr in jflat.items():
        assert tuple(mine[path].shape) == arr.shape, path
        assert err(arr, mine[path]) < TOL, path
    return cache


def check_greedy_decode(arch, flash):
    """A prefill of 40 tokens and 8 greedy decode steps: the same tokens,
    logits and caches."""
    jcfg, cfg, jparams, params, tokens = setup_arch(arch)
    jflags, flags = _flags(flash)
    with jax_perf_flags(jflags):
        jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens))
    with perf_flags(flags):
        logits, cache = model_lib.prefill(params, cfg,
                                          torch.from_numpy(tokens))
    jcache, cache = grow_jax(jcache, STEPS), grow(cache, STEPS)
    jdecode = jax.jit(lambda p, t, c, n: jax_tf.decode_step(p, jcfg, t, c, n))
    jtok, tok = jnp.argmax(jlogits, axis=-1), torch.argmax(logits, dim=-1)
    for step in range(STEPS):
        assert np.array_equal(np.asarray(jtok), tok.numpy()), step
        jlogits, jcache = jdecode(jparams, jtok[:, None], jcache, S + step)
        with perf_flags(flags):
            logits, cache = model_lib.decode_step(params, cfg, tok[:, None],
                                                  cache, S + step)
        assert err(jlogits, logits) < TOL, step
        jtok, tok = jnp.argmax(jlogits, axis=-1), torch.argmax(logits, dim=-1)
    assert np.array_equal(np.asarray(jtok), tok.numpy())
    mine = flat(cache)
    for path, arr in flat_jax(jcache).items():
        assert tuple(mine[path].shape) == arr.shape, path
        assert err(arr, mine[path]) < TOL, path


def check_completions(arch, flash):
    """Prompts of 2, 8 and 40 tokens through 3 slots: every refill splices
    the cache leaves along their time axis (``TIME_AXIS_LEAVES``), and the
    completions agree token for token."""
    jcfg, cfg, jparams, params, _ = setup_arch(arch)
    rng = np.random.default_rng(12)
    lens = (2, 8, 40, 8, 2, 40, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    jeng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=3, max_seq_len=64, monitor=False))
    job = f"serve-{arch}-{flash}"
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=3, max_seq_len=64, job_name=job, device="cpu",
        **CPU_FIGURES))
    for i, prompt in enumerate(prompts):
        jeng.submit(jax_engine.Request(i, prompt, max_new_tokens=10 + i % 3))
        eng.submit(engine.Request(i, prompt, max_new_tokens=10 + i % 3))
    jflags, flags = _flags(flash)
    with jax_perf_flags(jflags):
        jeng.run()
    with perf_flags(flags):
        stats = eng.run()
    theirs = {c.request_id: c.tokens for c in jeng.completions}
    mine = {c.request_id: c.tokens for c in eng.completions}
    assert mine == theirs and stats["requests"] == len(lens)
    assert 0 < JobRegistry.global_registry().entries()[job].duty_cycle
    JobRegistry.global_registry().remove(job)


def train_configs(arch, **changes):
    return (dataclasses.replace(jax_reduced(arch), **changes),
            dataclasses.replace(reduced_config(arch), **changes))


def planted_masters(jcfg, cfg):
    """The reference's train state with its masters planted, and the
    port's float32 masters bridged from them."""
    jstate = jax_ts.init_train_state(jcfg, jax.random.PRNGKey(0),
                                     jax_ts.default_opt_cfg(jcfg))
    jstate = jstate._replace(params=plant(jstate.params))
    params = from_jax_params(jax.tree.map(np.asarray, jstate.params), cfg,
                             "cpu", dtype=F32)
    return jstate, params


def jax_batch(cfg, step):
    b = JaxSyntheticLM(JaxDataConfig(cfg.vocab_size, S, B, 0)).batch(step)
    return b, {k: torch.from_numpy(np.asarray(v).astype(np.int64))
               for k, v in b.items()}


def jax_paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def check_gradients(arch, flash):
    """The loss within 1e-5 relative; each leaf's gradient within 5e-3 and
    within 1e-4 of its largest."""
    jcfg, cfg = train_configs(arch)
    jstate, params = planted_masters(jcfg, cfg)
    jb, batch = jax_batch(cfg, 0)
    jflags, flags = _flags(flash)
    with jax_perf_flags(jflags):
        jl, jg = jax.value_and_grad(lambda p: jax_tf.lm_loss(
            p, jcfg, jb["tokens"], jb["labels"]))(jstate.params)
    with perf_flags(flags):
        loss, grads = ts.loss_and_grads(params, cfg, batch)
    jg, grads = jax_paths(jg), flat(grads)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(grads) == set(jg)
    for key, g in grads.items():
        gap = float(np.max(np.abs(g.detach().numpy() - jg[key])))
        peak = float(np.max(np.abs(jg[key])))
        assert gap < 5e-3 and gap <= 1e-4 * peak, (key, gap, peak)


def check_three_train_steps(arch, remat, flash):
    """Losses within 1e-5 relative and parameters within ``update_gaps``'
    bounds after 3 AdamW steps, ``cfg.remat`` and the flags the same on
    both sides."""
    jcfg, cfg = train_configs(arch, remat=remat)
    jstate, params = planted_masters(jcfg, cfg)
    jb, _ = jax_batch(cfg, 0)
    jflags, flags = _flags(flash)
    with jax_perf_flags(jflags):
        g1 = jax_paths(jax.grad(lambda p: jax_tf.lm_loss(
            p, jcfg, jb["tokens"], jb["labels"]))(jstate.params))
        jstep = jax.jit(jax_ts.make_train_step(
            jcfg, jax_ts.default_opt_cfg(jcfg, total_steps=3)))
        ocfg = ts.default_opt_cfg(cfg, total_steps=3)
        step_fn = ts.make_train_step(cfg, ocfg)
        state = ts.TrainState(params, opt.init_opt_state(params, ocfg))
        lrs = []
        for k in range(3):
            jb, batch = jax_batch(cfg, k)
            jstate, jmet = jstep(jstate, jb)
            with perf_flags(flags):
                state, met = step_fn(state, batch)
            assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
                1e-5 * abs(float(jmet["loss"]))
            lrs.append(met["lr"])
    want = {k: torch.from_numpy(v.copy())
            for k, v in jax_paths(jstate.params).items()}
    g1 = {k: torch.from_numpy(v.copy()) for k, v in g1.items()}
    tight, loose, held = chip_smoke().update_gaps(flat(state.params),
                                                  want, g1, lrs)
    assert tight <= 1 and loose <= 1, (tight, loose)
    assert held > 0.25


def check_decay(arch, decayed, kept):
    """One AdamW step of zero gradients: only weight decay moves a leaf,
    by lr * weight_decay * p.  The leaves ``decayed`` move and ``kept``
    stay, in the port and in the reference alike, and the two agree."""
    jcfg, cfg = train_configs(arch)
    jstate, params = planted_masters(jcfg, cfg)
    jzero = jax.tree.map(jnp.zeros_like, jstate.params)
    jcfg_opt = jax_ts.default_opt_cfg(jcfg, total_steps=3)
    jnew, _, _ = jax_opt.adamw_update(jstate.params, jzero, jstate.opt,
                                      jcfg_opt)
    ocfg = ts.default_opt_cfg(cfg, total_steps=3)
    zero = tf._tree_map(torch.zeros_like, params)
    new, _, met = opt.adamw_update(params, zero,
                                   opt.init_opt_state(params, ocfg), ocfg)
    assert ocfg.weight_decay > 0 and met["lr"] > 0
    before, after, theirs = flat(params), flat(new), jax_paths(jnew)
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    theirs_moved = {k for k in before
                    if not np.array_equal(before[k].numpy(), theirs[k])}
    assert moved == theirs_moved
    for leaf in decayed:
        keys = [k for k in before if k.endswith(f"['{leaf}']")]
        assert keys and all(k in moved for k in keys), leaf
    for leaf in kept:
        keys = [k for k in before if k.endswith(f"['{leaf}']")]
        assert keys and not any(k in moved for k in keys), leaf
    for k in before:
        assert err(theirs[k], after[k]) < 1e-7, k


def kernel_stand_ins(monkeypatch):
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


def check_launch_counts(arch, monkeypatch, serve_want, step_want):
    """``serve_launches`` and ``step_launches`` of chip_smoke.py count what
    the model launches: a prefill and a decode step, and a train step under
    remat "full" (the stacked layers' kernels run again in the recompute),
    with the kernel routes stood in."""
    cs = chip_smoke()
    _, cfg, _, params, tokens = setup_arch(arch)
    launches = kernel_stand_ins(monkeypatch)
    with perf_flags(PerfFlags(flash_kernel=True)):
        _, cache = model_lib.prefill(params, cfg, torch.from_numpy(tokens))
        model_lib.decode_step(params, cfg, torch.zeros(B, 1, dtype=torch.long),
                              grow(cache, 1), S)
    want = {k: v for k, v in cs.serve_launches(cfg, 1, 1).items() if v}
    assert launches == want == serve_want
    launches.clear()
    full = dataclasses.replace(cfg, remat="full")
    with perf_flags(PerfFlags(flash_kernel=True)):
        ts.loss_and_grads(params, full, jax_batch(cfg, 0)[1])
    want = {k: v for k, v in cs.step_launches(full).items() if v}
    assert launches == want == step_want


def check_launchers(arch, capsys):
    rc = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--requests", "3", "--slots", "2",
                            "--prompt-len", "20", "--max-new", "4",
                            "--flags", "flash_kernel",
                            "--peak-flops", "1e12", "--mem-total-gb", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"[serve:{arch}-reduced] 3 requests, 12 tokens" in out
    assert "LLload view: duty=" in out
    rc = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", "32",
                            "--flags", "flash_kernel",
                            "--peak-flops", "1e12", "--mem-total-gb", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in
              out.split("[launch.train] losses:")[1].splitlines()[0].split()]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "[launch.train] done: steps=3 " in out


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_layout_and_planted_leaves(arch):
    """qwen1.5 keeps its biases (4 query and 4 KV heads), phi3 its GQA (4
    query and 2 KV heads); the tree is the reference's; every bias and
    norm scale is planted (no bias is zero, no scale one)."""
    _, cfg, jparams, params, _ = setup_arch(arch)
    assert (cfg.n_layers, cfg.period, cfg.d_head) == (1, 1, 16)
    heads = {"qwen1.5-4b": (4, 4), "phi3-medium-14b": (4, 2)}[arch]
    assert (cfg.n_heads, cfg.n_kv_heads) == heads
    mixer = set(params["blocks"]["0"]["mixer"])
    bias = {"bq", "bk", "bv"}
    assert mixer == {"wq", "wk", "wv", "wo"} | (bias if cfg.qkv_bias
                                                 else set())
    assert cfg.qkv_bias == (arch == "qwen1.5-4b")
    assert set(flat(params)) == set(flat_jax(jparams))
    planted = planted_leaves(jparams)
    assert len(planted) == 3 + 3 * cfg.qkv_bias
    mine = flat(params)
    for key in planted:
        t = mine[key]
        assert not torch.any(t == 0) and not torch.any(t == 1), key


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_prefill_and_caches_match(arch, flash):
    check_forward_prefill_and_caches(arch, flash)


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches(arch, flash):
    check_greedy_decode(arch, flash)


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("arch", ARCHS)
def test_completions_through_3_slots_identical_to_jax(arch, flash):
    check_completions(arch, flash)


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_jax(arch, flash):
    check_gradients(arch, flash)


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, remat, flash):
    check_three_train_steps(arch, remat, flash)


def test_planted_biases_are_read():
    """Without its biases (each set back to zero) the port's reduced qwen1.5
    moves far past the tolerance: a port that dropped the bias add would
    fail the tests above, as would one that read one bias for another."""
    _, cfg, _, params, tokens = setup_arch("qwen1.5-4b")
    h, _ = tf.forward_hidden(params, cfg, torch.from_numpy(tokens))
    mixer = params["blocks"]["0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        changed = dict(params, blocks={"0": dict(
            params["blocks"]["0"], mixer=dict(
                mixer, **{name: torch.zeros_like(mixer[name])}))})
        other, _ = tf.forward_hidden(changed, cfg, torch.from_numpy(tokens))
        assert float((other - h).abs().max()) > 100 * TOL, name
    swapped = dict(params, blocks={"0": dict(params["blocks"]["0"], mixer=dict(
        mixer, bk=mixer["bv"], bv=mixer["bk"]))})
    other, _ = tf.forward_hidden(swapped, cfg, torch.from_numpy(tokens))
    assert float((other - h).abs().max()) > 100 * TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_biased_projection_matches_jax(dtype):
    """``gqa_project_qkv`` with planted biases against the reference's, in
    float32 (5e-6) and in bfloat16 (the product rounded to bf16, then the
    bias added in bf16: within one bf16 ulp of the output, 2^-7 relative)."""
    rng = np.random.default_rng(4)
    d, H, Hk, D = 64, 4, 2, 16
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {"wq": rng.standard_normal((d, H * D)) * d ** -0.5,
         "wk": rng.standard_normal((d, Hk * D)) * d ** -0.5,
         "wv": rng.standard_normal((d, Hk * D)) * d ** -0.5,
         "bq": rng.standard_normal(H * D) * 0.5,
         "bk": rng.standard_normal(Hk * D) * 0.5,
         "bv": rng.standard_normal(Hk * D) * 0.5}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    theirs = jax_attn.gqa_project_qkv(
        {k: jnp.asarray(v, jdt) for k, v in p.items()},
        jnp.asarray(x, jdt), H, Hk, D)
    mine = attn_mod.gqa_project_qkv(
        {k: torch.from_numpy(np.asarray(v, np.float32)).to(tdt)
         for k, v in p.items()}, torch.from_numpy(x).to(tdt), H, Hk, D)
    for a, b in zip(theirs, mine):
        assert b.dtype == tdt and tuple(b.shape) == a.shape
        want = np.asarray(a.astype(jnp.float32))
        gap = np.abs(b.to(F32).numpy() - want)
        if dtype == "float32":
            assert gap.max() < 5e-6
        else:
            assert np.all(gap <= 2.0 ** -7 * np.abs(want) + 1e-6)


def _gqa_inputs(S, T, H=40, Hk=10, D=16, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, S, H, D), dtype=np.float32),
            rng.standard_normal((2, T, Hk, D), dtype=np.float32),
            rng.standard_normal((2, T, Hk, D), dtype=np.float32))


def test_gqa_40_10_flash_and_chunked_attention_match_jax():
    """phi3-medium-14b's heads, 40 query and 10 KV (G = 4), at a head dim
    of 16: the flash route (on the CPU the plain version; the reference's
    Pallas kernel in interpret mode) and chunked attention over 3 query
    chunks agree with the reference's, and with each other."""
    q, k, v = _gqa_inputs(32, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    flash = ops.flash_attention_bshd(tq, tk, tv, causal=True)
    jflash = jax_ops.flash_attention_bshd(jq, jk, jv, causal=True,
                                          block_q=32, block_k=32)
    chunked = attn_mod.chunked_attention(tq, tk, tv, causal=True, chunk=12)
    jchunked = jax_attn.chunked_attention(jq, jk, jv, causal=True, chunk=12)
    assert flash.shape == chunked.shape == (2, 32, 40, 16)
    assert err(jflash, flash) < 2e-5
    assert err(jchunked, chunked) < 2e-5
    assert float((flash - chunked).abs().max()) < 2e-5
    # query head h reads KV head h // 4: moving KV head 1 moves heads 4-7
    tk2 = tk.clone()
    tk2[:, :, 1] = torch.from_numpy(_gqa_inputs(1, 32, seed=12)[1][:, :, 1])
    moved = (attn_mod.chunked_attention(tq, tk2, tv, chunk=12) - chunked)
    moved = moved.abs().amax(dim=(0, 1, 3))
    assert torch.all(moved[4:8] > 1e-2)
    assert torch.all(moved[:4] < 1e-6) and torch.all(moved[8:] < 1e-6)


def test_gqa_40_10_decode_matches_jax():
    """One decode row per batch entry against a cache of 24, ragged lengths
    (5 and 17), 40 query and 10 KV heads, as ``gqa_decode`` calls it."""
    q, k, v = _gqa_inputs(1, 24)
    lens = [5, 17]
    theirs = jax_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=jnp.asarray(lens), kv_valid_len=jnp.asarray(lens) + 1)
    tl = torch.as_tensor(lens)
    mine = attn_mod.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_offset=tl, kv_valid_len=tl + 1)
    assert mine.shape == (2, 1, 40, 16)
    assert err(theirs, mine) < 2e-5


def test_adamw_decays_the_qkv_biases_as_the_reference_does():
    """The reference's ``_decay_mask`` matches ``"bias"`` in the string of
    the last key, ``['bq']``, which holds none: the reference decays bq,
    bk and bv, and so does the port; the norm scales are not decayed."""
    for key in ("bq", "bk", "bv"):
        assert jax_opt._decay_mask((jax.tree_util.DictKey(key),))
        assert opt._decay_mask((key,))
    check_decay("qwen1.5-4b", decayed=("bq", "bk", "bv", "wq"),
                kept=("scale",))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_counts_of_chip_smoke(arch, monkeypatch):
    """Reduced: one layer, so flash 1 and RMSNorm 2 a layer and the final
    norm; at full width and depth the serve's 40 flash a prefill and 81
    RMSNorm a prefill or decode step, and at 8 layers 16 flash and 33
    RMSNorm a train step."""
    check_launch_counts(arch, monkeypatch,
                        {"flash_attention": 1, "rmsnorm": 2 * 3},
                        {"flash_attention": 2, "rmsnorm": 5})
    cs = chip_smoke()
    big = get_config(arch)
    assert {k: v for k, v in cs.serve_launches(big, 1, 0).items() if v} == \
        {"flash_attention": 40, "rmsnorm": 81}
    assert {k: v for k, v in cs.serve_launches(big, 0, 1).items() if v} == \
        {"rmsnorm": 81}
    eight = dataclasses.replace(big, n_layers=8)
    assert {k: v for k, v in cs.step_launches(eight).items() if v} == \
        {"flash_attention": 16, "rmsnorm": 33}


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_the_cpu(arch, capsys):
    check_launchers(arch, capsys)
