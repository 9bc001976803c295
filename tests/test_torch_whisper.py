"""The port's encoder-decoder model (whisper) against the JAX package on
the CPU, float32, with the same bridged weights: reduced whisper-base (a
2-layer encoder of 4 heads over 16 frames, one decoder layer of 4 heads of
16 with ``ln_x`` and cross attention), every norm scale (the encoder's
``ln1``, ``ln2`` and ``enc_norm`` among them, and ``ln_x``) planted with
values drawn by numpy from a seed in both packages (the reference
initializes them to ones, which would hide a norm left out).  The frames
are the JAX package's ``SyntheticLM.frontend``, fed to both sides.

- ``encode``, ``cross_kv`` and ``cross_attention`` one by one, in float32
  and bfloat16, over 16 frames (one query chunk) and 40 (three chunks of
  ``attn_chunk`` 16: the reference pads 8 query rows, the port takes a
  short last chunk);
- the model: hidden states, prefill logits and caches (``xk``/``xv``
  included), 8 greedy decode steps, decode against prefill, the loss and
  every leaf's gradient (``enc_blocks`` included) under remat "none",
  "full" and "dots", each with neither flag, with ``flash_kernel``, with
  ``bf16_grads`` and with both (``FLAGS``), 3 train steps with the frames
  in the batch, checkpoints written by either package and restored by the
  other;
- frames in float32 for a bfloat16 model raise in both packages (never
  cast down); both packages' ``ServeEngine`` fail on the model, the port's
  before any work; ``launch.serve`` exits 1 with the port's message and
  ``launch.train --reduced`` trains;
- ``SyntheticLM.frontend`` and chip_smoke.py's launch counts.

Tolerances are tests/test_torch_model.py's and tests/test_torch_train.py's:
5e-5 for hidden states, logits and caches; for the loss 1e-5 relative, for
gradients 5e-3 absolute and 1e-4 of each leaf's largest; after 3 steps
chip_smoke.py's ``update_gaps``.  The model-level checks are functions of
the arch, so that tests/test_torch_internvl2.py runs them too.
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
from repro.launch import fault as jax_fault  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.perf_flags import PerfFlags as JaxFlags  # noqa: E402
from repro.models.perf_flags import perf_flags as jax_perf_flags  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro.train import DataConfig as JaxDataConfig  # noqa: E402
from repro.train import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.train import checkpoint as jax_ck  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.fault import resume_latest  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def _load(name):
    path = Path(__file__).resolve().parents[1] / name
    spec = importlib.util.spec_from_file_location(path.stem + "_mod", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# tests/test_torch_qwen_phi3.py's helpers (plant, flat, kernel stand-ins)
checks = _load("tests/test_torch_qwen_phi3.py")
# chip_smoke.py's helpers (patches, grow_caches, launch counts)
smoke = checks.chip_smoke()
ARCH = "whisper-base"
F32 = torch.float32
TOL = 5e-5
B, S, STEPS = 2, 40, 8      # 40 tokens: flash takes them (min(128, S) | S)
FLASH = [False, True]
REMATS = ["none", "full", "dots"]
# (flash_kernel, bf16_grads) of the gradient checks.
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def jax_frontend(jcfg, step=0, batch=B):
    """The JAX package's frames or patches of ``step``, as numpy."""
    data = JaxSyntheticLM(JaxDataConfig(jcfg.vocab_size, S, batch, 0))
    return np.array(data.frontend(step, jcfg), np.float32)


def setup(arch, **changes):
    """(JAX config, port config, planted JAX params, bridged port params,
    tokens [B,S], frontend [B,N,d] as numpy)."""
    jcfg = dataclasses.replace(jax_reduced(arch), **changes)
    cfg = dataclasses.replace(reduced_config(arch), **changes)
    jparams = checks.plant(jax_init(jcfg, jax.random.PRNGKey(0)))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return jcfg, cfg, jparams, params, tokens, jax_frontend(jcfg)


def grow_jax(cache, n):
    """Room for ``n`` more tokens on the time axis of the self-attention
    leaves ``k`` and ``v``; ``xk`` and ``xv`` span the frames and stay."""
    def pad(t, axis):
        widths = [(0, 0)] * t.ndim
        widths[axis] = (0, n)
        return jnp.pad(t, widths)

    return {part: {key: {name: pad(t, 2 if part == "blocks" else 1)
                         if name in ("k", "v") else t
                         for name, t in entry.items()}
                   for key, entry in entries.items()}
            for part, entries in cache.items()}


def grow(cache, n):
    """``grow_jax`` of the port's cache tree."""
    return smoke.grow_caches(torch, cache, engine.TIME_AXIS_LEAVES, n)


# --------------------------------------------------------------------------
# the model-level checks, shared with tests/test_torch_internvl2.py
# --------------------------------------------------------------------------


def check_prefill_and_caches(arch, flash):
    """Hidden states, prefill logits and every cache leaf."""
    jcfg, cfg, jparams, params, tokens, fe = setup(arch)
    with jax_perf_flags(JaxFlags(flash_kernel=flash)):
        jh, _ = jax_tf.forward_hidden(jparams, jcfg, jnp.asarray(tokens),
                                      jnp.asarray(fe))
        jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens),
                                         jnp.asarray(fe))
    with perf_flags(PerfFlags(flash_kernel=flash)):
        h, _ = tf.forward_hidden(params, cfg, torch.from_numpy(tokens),
                                 torch.from_numpy(fe))
        logits, cache = model_lib.prefill(params, cfg,
                                          torch.from_numpy(tokens),
                                          torch.from_numpy(fe))
    assert h.shape == (B, smoke.patches(cfg) + S, cfg.d_model)
    assert checks.err(jh, h) < TOL and checks.err(jlogits, logits) < TOL
    jflat, mine = checks.flat_jax(jcache), checks.flat(cache)
    assert set(mine) == set(jflat)
    for path, arr in jflat.items():
        assert tuple(mine[path].shape) == arr.shape, path
        assert checks.err(arr, mine[path]) < TOL, path
    return mine


def check_greedy_decode(arch, flash):
    """A prefill and 8 greedy decode steps at ``cache_len`` P + S + step:
    the same tokens, logits and caches."""
    jcfg, cfg, jparams, params, tokens, fe = setup(arch)
    with jax_perf_flags(JaxFlags(flash_kernel=flash)):
        jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens),
                                         jnp.asarray(fe))
    with perf_flags(PerfFlags(flash_kernel=flash)):
        logits, cache = model_lib.prefill(params, cfg,
                                          torch.from_numpy(tokens),
                                          torch.from_numpy(fe))
    jcache, cache = grow_jax(jcache, STEPS), grow(cache, STEPS)
    jdecode = jax.jit(lambda p, t, c, n: jax_tf.decode_step(p, jcfg, t, c, n))
    jtok, tok = jnp.argmax(jlogits, axis=-1), torch.argmax(logits, dim=-1)
    start = smoke.patches(cfg) + S
    for step in range(STEPS):
        assert np.array_equal(np.asarray(jtok), tok.numpy()), step
        jlogits, jcache = jdecode(jparams, jtok[:, None], jcache,
                                  start + step)
        logits, cache = model_lib.decode_step(params, cfg, tok[:, None],
                                              cache, start + step)
        assert checks.err(jlogits, logits) < TOL, step
        jtok, tok = jnp.argmax(jlogits, axis=-1), torch.argmax(logits, dim=-1)
    assert np.array_equal(np.asarray(jtok), tok.numpy())
    mine = checks.flat(cache)
    for path, arr in checks.flat_jax(jcache).items():
        assert tuple(mine[path].shape) == arr.shape, path
        assert checks.err(arr, mine[path]) < TOL, path


def check_decode_equals_prefill(arch):
    """tests/test_models_smoke.py's invariant, in the port: the prefill of
    S - 1 tokens, then a decode step of the last at P + S - 1, gives the
    logits of the prefill of all S (within that test's 2e-4), and the
    reference's decode step's within 5e-5."""
    jcfg, cfg, jparams, params, tokens, fe = setup(arch)
    t, f = torch.from_numpy(tokens), torch.from_numpy(fe)
    full, _ = model_lib.prefill(params, cfg, t, f)
    _, cache = model_lib.prefill(params, cfg, t[:, :S - 1], f)
    pos = smoke.patches(cfg) + S - 1
    logits, _ = model_lib.decode_step(params, cfg, t[:, S - 1:],
                                      grow(cache, 1), pos)
    assert float((logits - full).abs().max()) < 2e-4
    _, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens[:, :S - 1]),
                               jnp.asarray(fe))
    jlogits, _ = jax_tf.decode_step(jparams, jcfg,
                                    jnp.asarray(tokens[:, S - 1:]),
                                    grow_jax(jcache, 1), pos)
    assert checks.err(jlogits, logits) < TOL


def jax_batch(cfg, jcfg, step):
    """The JAX package's batch of ``step`` with its frontend, and the
    port's copy of it."""
    b, batch = checks.jax_batch(cfg, step)
    fe = JaxSyntheticLM(JaxDataConfig(cfg.vocab_size, S, B, 0)).frontend(
        step, jcfg)
    b["frontend"] = fe
    batch["frontend"] = torch.from_numpy(np.array(fe, np.float32)).to(
        getattr(torch, cfg.dtype))
    return b, batch


def _jax_loss(jcfg, jb):
    return lambda p: jax_tf.lm_loss(jax_ts.cast_params(p, jcfg.dtype), jcfg,
                                    jb["tokens"], jb["labels"],
                                    jb["frontend"])


def _jax_grads(jcfg, jb, jstate, **flags):
    with jax_perf_flags(JaxFlags(**flags)):
        jl, jg = jax.value_and_grad(_jax_loss(jcfg, jb))(jstate.params)
    return jl, checks.jax_paths(jg)


def _gap(got, want):
    return float(np.max(np.abs(got.detach().numpy() - want)))


def check_gradients(arch, remat, flash, bf16_grads):
    """The loss within 1e-5 relative; every leaf's gradient within 5e-3
    and within 1e-4 of its largest, under ``remat`` and the flags on both
    sides.  With ``bf16_grads`` the port's gradients without the flag lie
    beyond that bound, so the flag is not ignored.

    With both flags the bound of each leaf also takes the reference's own
    spread there: its gradient with the flags against its gradient with
    ``bf16_grads`` alone.  The flag rounds each block's cotangent to
    bfloat16, and the reference's Pallas kernel in interpret mode differs
    from its plain attention by ~1e-6 relative before that, so a rounding
    that falls the other way moves reduced internvl2's w2 by 1.02e-4 of
    its largest between the reference's two routes.  The port's wrapper
    takes the plain version on the CPU, so its gradients are also held
    within 1e-4 to the reference's plain route."""
    jcfg, cfg = checks.train_configs(arch, remat=remat)
    jstate, params = checks.planted_masters(jcfg, cfg)
    jb, batch = jax_batch(cfg, jcfg, 0)
    jl, jg = _jax_grads(jcfg, jb, jstate, flash_kernel=flash,
                        bf16_grads=bf16_grads)
    with perf_flags(PerfFlags(flash_kernel=flash, bf16_grads=bf16_grads)):
        loss, grads = ts.loss_and_grads(params, cfg, batch)
    grads = checks.flat(grads)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(grads) == set(jg)
    peaks = {key: float(np.max(np.abs(jg[key]))) for key in jg}
    bounds = {key: 1e-4 * peak for key, peak in peaks.items()}
    if flash and bf16_grads:
        _, jplain = _jax_grads(jcfg, jb, jstate, bf16_grads=True)
        for key, g in grads.items():
            assert _gap(g, jplain[key]) <= 1e-4 * peaks[key], key
            bounds[key] += float(np.max(np.abs(jg[key] - jplain[key])))
    for key, g in grads.items():
        gap = _gap(g, jg[key])
        assert peaks[key] > 0, key
        assert gap < 5e-3 and gap <= bounds[key], (key, gap, peaks[key])
    if bf16_grads:
        with perf_flags(PerfFlags(flash_kernel=flash)):
            _, plain = ts.loss_and_grads(params, cfg, batch)
        assert any(_gap(g, jg[k]) > bounds[k]
                   for k, g in checks.flat(plain).items())
    return grads


def check_three_train_steps(arch, remat, flash):
    """Losses within 1e-5 relative and parameters within ``update_gaps``'
    bounds after 3 AdamW steps, each batch with its frontend."""
    jcfg, cfg = checks.train_configs(arch, remat=remat)
    jstate, params = checks.planted_masters(jcfg, cfg)
    with jax_perf_flags(JaxFlags(flash_kernel=flash)):
        jb, _ = jax_batch(cfg, jcfg, 0)
        g1 = checks.jax_paths(jax.grad(_jax_loss(jcfg, jb))(jstate.params))
        jstep = jax.jit(jax_ts.make_train_step(
            jcfg, jax_ts.default_opt_cfg(jcfg, total_steps=3)))
        ocfg = ts.default_opt_cfg(cfg, total_steps=3)
        step_fn = ts.make_train_step(cfg, ocfg)
        state = ts.TrainState(params, opt.init_opt_state(params, ocfg))
        lrs = []
        for k in range(3):
            jb, batch = jax_batch(cfg, jcfg, k)
            jstate, jmet = jstep(jstate, jb)
            with perf_flags(PerfFlags(flash_kernel=flash)):
                state, met = step_fn(state, batch)
            assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
                1e-5 * abs(float(jmet["loss"]))
            lrs.append(met["lr"])
    want = {k: torch.from_numpy(v.copy())
            for k, v in checks.jax_paths(jstate.params).items()}
    g1 = {k: torch.from_numpy(v.copy()) for k, v in g1.items()}
    tight, loose, held = smoke.update_gaps(
        checks.flat(state.params), want, g1, lrs)
    assert tight <= 1 and loose <= 1, (tight, loose)
    assert held > 0.25


def _keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def check_checkpoints_both_ways(arch, tmp_path):
    """A train state after one step with the frontend in the batch, written
    by the JAX package and restored by the port, and the other way: every
    leaf (the new ones among them) equal, ``.opt.step`` 1."""
    jcfg, cfg = checks.train_configs(arch)
    ocfg, jocfg = ts.default_opt_cfg(cfg), jax_ts.default_opt_cfg(jcfg)
    jstate = jax_ts.init_train_state(jcfg, jax.random.PRNGKey(0), jocfg)
    jstate, _ = jax.jit(jax_ts.make_train_step(jcfg, jocfg))(
        jstate, jax_batch(cfg, jcfg, 0)[0])
    jax_ck.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    state, start = resume_latest(str(tmp_path / "jax"),
                                 ts.init_train_state_shape(cfg, ocfg),
                                 device="cpu")
    assert start == 1 and state.opt.step == 1
    got, want = ck._flatten(state), _keyed(jstate)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k], got[k].dtype)), k

    state = ts.init_train_state(cfg, torch.Generator().manual_seed(0), ocfg,
                                device="cpu")
    state, _ = ts.make_train_step(cfg, ocfg)(state, jax_batch(cfg, jcfg,
                                                              0)[1])
    ck.save_checkpoint(str(tmp_path / "port"), 1, state)
    template = jax.eval_shape(lambda: jax_ts.init_train_state(
        jcfg, jax.random.PRNGKey(0), jocfg))
    jstate, start = jax_fault.resume_latest(str(tmp_path / "port"), template)
    assert start == 1
    got, want = _keyed(jstate), ck._flatten(state)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    return set(want)


def check_launch_train(arch, capsys):
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


def check_launch_counts(arch, monkeypatch, serve_want, step_want):
    """``serve_launches`` and ``step_launches`` of chip_smoke.py count what
    the model launches, the frontend given: a prefill and a decode step,
    and a train step under remat "full", with the kernel routes stood in."""
    _, cfg, _, params, tokens, fe = setup(arch)
    launches = checks.kernel_stand_ins(monkeypatch)
    with perf_flags(PerfFlags(flash_kernel=True)):
        _, cache = model_lib.prefill(params, cfg, torch.from_numpy(tokens),
                                     torch.from_numpy(fe))
        model_lib.decode_step(params, cfg, torch.zeros(B, 1, dtype=torch.long),
                              grow(cache, 1), smoke.patches(cfg) + S)
    want = {k: v for k, v in smoke.serve_launches(cfg, 1, 1).items() if v}
    assert launches == want == serve_want
    launches.clear()
    full = dataclasses.replace(cfg, remat="full")
    jcfg = dataclasses.replace(jax_reduced(arch), remat="full")
    with perf_flags(PerfFlags(flash_kernel=True)):
        ts.loss_and_grads(params, full, jax_batch(cfg, jcfg, 0)[1])
    want = {k: v for k, v in smoke.step_launches(full).items() if v}
    assert launches == want == step_want


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


def test_reduced_layout_and_planted_leaves():
    """Reduced whisper keeps the encoder (2 layers, 4 heads of 16, d_ff 64,
    16 frames) and the decoder's cross attention; the tree is the
    reference's; every norm scale is planted (none is one)."""
    _, cfg, jparams, params, _, fe = setup(ARCH)
    assert (cfg.n_layers, cfg.encoder.n_layers, cfg.encoder.source_len) == \
        (1, 2, 16)
    assert fe.shape == (B, 16, 64)
    assert set(params) == {"embed", "blocks", "rem", "final_norm", "lm_head",
                           "enc_blocks", "enc_norm"}
    assert set(params["blocks"]["0"]) == {"ln1", "ln2", "ln_x", "mixer",
                                          "xattn", "mlp"}
    assert set(params["enc_blocks"]) == {"ln1", "ln2", "mixer", "mlp"}
    assert set(params["enc_blocks"]["mlp"]) == {"w1", "w2"}
    assert params["enc_blocks"]["mixer"]["wq"].shape == (2, 64, 64)
    assert set(checks.flat(params)) == set(checks.flat_jax(jparams))
    planted = checks.planted_leaves(jparams)
    # ln1, ln2, ln_x; the encoder's ln1 and ln2; final_norm and enc_norm
    assert len(planted) == 3 + 2 + 2
    assert "['enc_norm']['scale']" in planted
    mine = checks.flat(params)
    for key in planted:
        assert not torch.any(mine[key] == 1), key


@pytest.mark.parametrize("source_len", [16, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_cross_kv_and_cross_attention_match_jax(dtype, source_len):
    """One by one against the reference's: ``encode`` over ``source_len``
    frames (40: three query chunks of 16, the reference's padded), then
    ``cross_kv`` of its output and ``cross_attention`` of 40 decoder rows
    over them.  float32 within 5e-5; bfloat16 within 2e-2 of the largest
    value (the kernels' bf16 tolerance)."""
    enc = dataclasses.replace(jax_reduced(ARCH).encoder,
                              source_len=source_len)
    jcfg, cfg, jparams, params, _, _ = setup(ARCH, encoder=enc, dtype=dtype)
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((B, source_len, 64)).astype(np.float32)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jenc = jax_tf.encode(jparams, jcfg, jnp.asarray(frames, jdt))
    mine = tf.encode(params, cfg, torch.from_numpy(frames).to(tdt))
    jx = jax.tree.map(lambda a: a[0], jparams["blocks"]["0"]["xattn"])
    px = {k: v[0] for k, v in params["blocks"]["0"]["xattn"].items()}
    jk, jv = jax_attn.cross_kv(jx, jenc, 4, 16)
    k, v = attn_mod.cross_kv(px, mine, 4, 16)
    jy = jax_attn.cross_attention(jx, jnp.asarray(x, jdt), jk, jv, jcfg)
    y = attn_mod.cross_attention(px, torch.from_numpy(x).to(tdt), k, v, cfg)
    for want, got in ((jenc, mine), (jk, k), (jv, v), (jy, y)):
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        tol = TOL if dtype == "float32" else \
            2e-2 * float(jnp.max(jnp.abs(want.astype(jnp.float32))))
        assert checks.err(want.astype(jnp.float32), got) < tol


def test_encoder_reads_no_positions_and_no_causal_mask():
    """Moving the last frame moves the encoder's output at the first frame
    (no causal mask); reversing the frames reverses the output (no
    positions), as the reference's."""
    _, cfg, _, params, _, fe = setup(ARCH)
    f = torch.from_numpy(fe)
    out = tf.encode(params, cfg, f)
    moved = f.clone()
    moved[:, -1] += 1.0
    assert float((tf.encode(params, cfg, moved)[:, 0] - out[:, 0]).abs()
                 .max()) > 1e-3
    rev = tf.encode(params, cfg, f.flip(1))
    assert float((rev.flip(1) - out).abs().max()) < 1e-5


@pytest.mark.parametrize("flash", FLASH)
def test_prefill_and_caches_match(flash):
    mine = check_prefill_and_caches(ARCH, flash)
    assert mine["['blocks']['0']['xk']"].shape == (1, B, 16, 4, 16)


@pytest.mark.parametrize("flash", FLASH)
def test_greedy_decode_matches(flash):
    check_greedy_decode(ARCH, flash)


def test_decode_equals_prefill():
    check_decode_equals_prefill(ARCH)


@pytest.mark.parametrize("flash,bf16_grads", FLAGS)
@pytest.mark.parametrize("remat", REMATS)
def test_lm_loss_gradients_match_jax(remat, flash, bf16_grads):
    """The encoder's leaves among them: remat checkpoints the decoder's
    periods with the encoder's output as an input, so its gradient flows
    back through every recompute."""
    grads = check_gradients(ARCH, remat, flash, bf16_grads)
    assert any(k.startswith("['enc_blocks']") for k in grads)


@pytest.mark.parametrize("remat,flash", [("full", True), ("none", False)])
def test_three_train_steps_match_jax(remat, flash):
    check_three_train_steps(ARCH, remat, flash)


def test_checkpoints_both_ways(tmp_path):
    keys = check_checkpoints_both_ways(ARCH, tmp_path)
    assert ".params['enc_norm']['scale']" in keys
    assert ".opt.m['blocks']['0']['xattn']['wq']" in keys


def test_frames_in_another_dtype_raise_in_both_packages():
    """float32 frames for a bfloat16 model: the reference's scan refuses
    them (TypeError), and so does the port's encoder, rather than cast them
    down; frames in the model dtype pass."""
    jcfg, cfg, jparams, _, tokens, fe = setup(ARCH, dtype="bfloat16")
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    with pytest.raises(TypeError):
        jax_tf.prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(fe))
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    with pytest.raises(TypeError, match="frames in torch.float32"):
        model_lib.prefill(params, cfg, torch.from_numpy(tokens),
                          torch.from_numpy(fe))
    with pytest.raises(ValueError, match="needs its frames"):
        model_lib.prefill(params, cfg, torch.from_numpy(tokens))
    logits, _ = model_lib.prefill(params, cfg, torch.from_numpy(tokens),
                                  torch.from_numpy(fe).to(torch.bfloat16))
    assert torch.isfinite(logits).all()


def test_both_engines_fail_on_an_encoder_decoder_model(capsys):
    """The reference's engine prefills tokens alone and fails in ``encode``;
    the port's refuses the model when it is made; ``launch.serve`` exits 1
    with the port's message."""
    jcfg, cfg, jparams, params, _, _ = setup(ARCH)
    jeng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=2, max_seq_len=64, monitor=False))
    jeng.submit(jax_engine.Request(0, np.arange(4, dtype=np.int32)))
    with pytest.raises(AttributeError):
        jeng.run()
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        engine.ServeEngine(cfg, params, engine.EngineConfig(
            device="cpu", monitor=False))
    rc = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--peak-flops", "1e12", "--mem-total-gb", "16"])
    assert rc == 1
    assert "encoder-decoder model needs frames" in capsys.readouterr().err


@pytest.mark.parametrize("arch", [ARCH, "internvl2-2b", "llsc-100m"])
def test_synthetic_frontend(arch):
    """``SyntheticLM.frontend``: frames of ``source_len`` (whisper) or
    patches of ``frontend_len`` (internvl2), standard normal in the model
    dtype, fixed by (seed, step); None without a frontend.  The Trainer
    puts them in every batch."""
    cfg = get_config(arch)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 2, 3))
    fe = data.frontend(5, cfg)
    if cfg.frontend == "none":
        assert fe is None
        return
    n = {"whisper-base": 1500, "internvl2-2b": 256}[arch]
    assert fe.shape == (2, n, cfg.d_model) and fe.dtype == torch.bfloat16
    assert torch.equal(fe, data.frontend(5, cfg))
    assert not torch.equal(fe, data.frontend(6, cfg))
    assert abs(float(fe.float().std()) - 1) < 0.05
    small = reduced_config(arch)
    trainer = Trainer(small, TrainerConfig(batch_size=2, seq_len=8,
                                           device="cpu", monitor_every=0))
    batch = trainer._batch(0)
    assert batch["frontend"].dtype == F32
    assert torch.equal(batch["frontend"], trainer.data.frontend(0, small))


def test_launch_train_on_the_cpu(capsys):
    check_launch_train(ARCH, capsys)


def test_launch_counts_of_chip_smoke(monkeypatch):
    """Reduced: flash 1 (the decoder's self-attention; the encoder and the
    cross attention take chunked attention, as the reference's) and
    RMSNorm 2 x 2 + 1 in the encoder and 3 + 1 in the decoder a prefill,
    3 + 1 a decode step; a train step under remat "full" runs the decoder
    layer's kernels twice and the encoder's once.  At full width and
    depth: 6 flash and 32 RMSNorm a prefill, 19 a decode step; 12 flash
    and 50 RMSNorm a train step."""
    check_launch_counts(ARCH, monkeypatch,
                        {"flash_attention": 1, "rmsnorm": 5 + 4 + 4},
                        {"flash_attention": 2, "rmsnorm": 5 + 6 + 1})
    big = get_config(ARCH)
    assert {k: v for k, v in smoke.serve_launches(big, 1, 0).items() if v} == \
        {"flash_attention": 6, "rmsnorm": 32}
    assert {k: v for k, v in smoke.serve_launches(big, 0, 1).items() if v} == \
        {"rmsnorm": 19}
    assert {k: v for k, v in smoke.step_launches(big).items() if v} == \
        {"flash_attention": 12, "rmsnorm": 50}
