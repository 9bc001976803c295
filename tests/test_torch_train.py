"""The port's training against the JAX package's on reduced llsc-100m, on
the CPU: the chunked loss, the gradients of ``lm_loss`` with respect to
the float32 masters (flash path on and off, float32 and bfloat16), one
AdamW update and its schedule, the weight-decay mask, and three train
steps (reduced llsc-100m, mamba2-370m, granite-moe-1b-a400m and
jamba-1.5-large-398b, whose moments are bfloat16; ``remat`` "none" and
"full"),
each on the same weights (the reference's float32 masters, carried across
by the bridge) and the JAX package's own batches.  Then ``cfg.remat``
against itself (gradients bit for bit, launch counts, the serve paths),
the port's own data generator, ``Trainer.run`` and ``launch.train`` on
the CPU.

Tolerances, each the reference's own where it has one: 1e-5 for the loss
in float32; 5e-3 absolute for float32 gradients
(tests/test_flash_integration.py), and 1e-4 of each leaf's largest
gradient, since a mean loss over B * S tokens has gradients far below 5e-3;
2e-2 of each leaf's largest gradient in bfloat16 (the kernels' bf16
tolerance, tests/test_kernels.py); 1e-6 for one AdamW update; after N
steps, parameters held by chip_smoke.py's ``update_gaps``, the bounds its
phase 13 holds the card to: where the step-1 gradient is at least 1e-2 of
its leaf's largest, within 1e-2 * (lr_1 + ... + lr_N) plus the rounding of
the stored parameters; elsewhere within 2 * (lr_1 + ... + lr_N) + 1e-6,
the bound of Adam's sign-like first updates on elements whose gradient is
near 0 (where the two sides may take opposite signs).
"""
import dataclasses
import importlib.util
import math
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.perf_flags import PerfFlags as JaxFlags  # noqa: E402
from repro.models.perf_flags import perf_flags as jax_perf_flags  # noqa: E402
from repro.train import DataConfig as JaxDataConfig  # noqa: E402
from repro.train import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import _guard, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernel  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402
from repro_torch.monitor import JobRegistry  # noqa: E402
from repro_torch.train import (DataConfig, SyntheticLM, Trainer,  # noqa: E402
                               TrainerConfig)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

F32 = torch.float32
B, S = 2, 64        # S a multiple of min(128, S): the flash gate holds
JAMBA = "jamba-1.5-large-398b"
ARCHS = ["llsc-100m", "mamba2-370m", "granite-moe-1b-a400m", JAMBA]


def _two_layers(arch):
    """Two layers, or for jamba its reduced period of 8, the fewest that
    holds its attention layer and a whole period for ``_remat``."""
    return 8 if arch == JAMBA else 2


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch only in main)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _configs(dtype="float32", arch="llsc-100m", **changes):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype=dtype, **changes)
    cfg = dataclasses.replace(reduced_config(arch), dtype=dtype, **changes)
    return jcfg, cfg


def _masters(jcfg, cfg, seed=0):
    """The reference's float32 masters, as JAX and as the port's tree."""
    jstate = jax_ts.init_train_state(jcfg, jax.random.PRNGKey(seed),
                                     jax_ts.default_opt_cfg(jcfg))
    params = from_jax_params(jax.tree.map(np.asarray, jstate.params), cfg,
                             "cpu", dtype=F32)
    return jstate, params


def _jax_batch(cfg, step, batch=B, seq=S):
    b = JaxSyntheticLM(JaxDataConfig(cfg.vocab_size, seq, batch, 0)).batch(
        step)
    return b, {k: torch.from_numpy(np.asarray(v).astype(np.int64))
               for k, v in b.items()}


def _paths(tree, path=()):
    """{keystr: leaf} of a nested dict, keyed as jax.tree_util.keystr."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, path + (k,)))
        return out
    return {"".join(f"[{k!r}]" for k in path): tree}


def _jax_paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t(x):
    return x.detach().to(F32).numpy()


# --------------------------------------------------------------------------
# (a) the chunked loss
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [True, False])
def test_chunked_ce_loss_matches_jax(tied):
    """S = 50 is no multiple of loss_chunk (32), so the last chunk is padded
    with -1 labels; a quarter of the labels are -1 as well.  float32,
    1e-5."""
    jcfg, cfg = _configs(tie_embeddings=tied)
    rng = np.random.default_rng(3)
    d, V, seq = cfg.d_model, cfg.vocab_size, 50
    params = {"embed": rng.standard_normal((V, d), dtype=np.float32) * 0.1}
    if not tied:
        params["lm_head"] = rng.standard_normal((d, V),
                                                dtype=np.float32) * 0.1
    hidden = rng.standard_normal((B, seq, d), dtype=np.float32)
    labels = rng.integers(0, V, (B, seq))
    labels[rng.random((B, seq)) < 0.25] = -1
    want = jax_tf.chunked_ce_loss(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
        jnp.asarray(hidden), jnp.asarray(labels, jnp.int32))
    got = tf.chunked_ce_loss({k: torch.from_numpy(v)
                              for k, v in params.items()}, cfg,
                             torch.from_numpy(hidden),
                             torch.from_numpy(labels))
    assert got.dtype == F32
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_chunked_ce_loss_of_no_valid_label_is_zero():
    """The mean divides by max(count, 1), as the reference's."""
    _, cfg = _configs()
    hidden = torch.randn(1, 8, cfg.d_model)
    params = {"embed": torch.randn(cfg.vocab_size, cfg.d_model)}
    loss = tf.chunked_ce_loss(params, cfg, hidden,
                              torch.full((1, 8), -1, dtype=torch.int64))
    assert float(loss) == 0.0


# --------------------------------------------------------------------------
# (b) gradients of lm_loss with respect to the float32 masters
# --------------------------------------------------------------------------


def _grads(jcfg, cfg, flash, *, aux_weights=None, bf16_grads=False):
    jstate, params = _masters(jcfg, cfg)
    jb, batch = _jax_batch(cfg, 0)

    def jloss(p):
        return jax_tf.lm_loss(jax_ts.cast_params(p, jcfg.dtype), jcfg,
                              jb["tokens"], jb["labels"],
                              aux_weights=aux_weights)

    with jax_perf_flags(JaxFlags(flash_kernel=flash, bf16_grads=bf16_grads)):
        jl, jg = jax.value_and_grad(jloss)(jstate.params)
    with perf_flags(PerfFlags(flash_kernel=flash, bf16_grads=bf16_grads)):
        loss, grads = ts.loss_and_grads(params, cfg, batch,
                                        aux_weights=aux_weights)
    return float(jl), _jax_paths(jg), float(loss), _paths(grads)


def _worst_share(grads, jg):
    """The worst over leaves of max |grad - jax grad| / max |jax grad|."""
    return max(float(np.max(np.abs(_t(g) - jg[k])))
               / float(np.max(np.abs(jg[k]))) for k, g in grads.items())


@pytest.mark.parametrize("flash", [False, True])
def test_lm_loss_gradients_match_jax_float32(flash):
    """Each leaf within 5e-3 absolute and within 1e-4 of its largest
    gradient; the test prints each leaf's largest and the worst ratio."""
    jcfg, cfg = _configs()
    jl, jg, loss, grads = _grads(jcfg, cfg, flash)
    assert abs(loss - jl) <= 1e-5 * abs(jl)
    assert set(grads) == set(jg)
    worst = 0.0
    for key, g in grads.items():
        assert g.dtype == F32 and tuple(g.shape) == jg[key].shape, key
        err = float(np.max(np.abs(_t(g) - jg[key])))
        peak = float(np.max(np.abs(jg[key])))
        print(f"{key}: max |jax grad| {peak:.3e}, max |grad - jax| {err:.3e}")
        worst = max(worst, err / peak)
        assert err < 5e-3, (key, err)
        assert err <= 1e-4 * peak, (key, err, peak)
    print(f"worst |grad - jax grad| / max|jax grad| over leaves: {worst:.3e}")


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("aux_weights", [None, (0.01, 1e-3)])
def test_granite_lm_loss_gradients_match_jax(aux_weights, n_layers):
    """Reduced granite-moe-1b-a400m in float32, flash on, with and without
    the MoE auxiliary losses: the loss within 1e-5 relative, each leaf's
    gradient within 5e-3 and 1e-4 of its largest; the aux losses change
    the router's gradients beyond that."""
    jcfg, cfg = _configs(arch="granite-moe-1b-a400m", n_layers=n_layers)
    jl, jg, loss, grads = _grads(jcfg, cfg, True, aux_weights=aux_weights)
    assert abs(loss - jl) <= 1e-5 * abs(jl)
    assert set(grads) == set(jg)
    for key, g in grads.items():
        err = float(np.max(np.abs(_t(g) - jg[key])))
        peak = float(np.max(np.abs(jg[key])))
        assert err < 5e-3 and err <= 1e-4 * peak, (key, err, peak)
    if aux_weights is not None:
        _, jg0, loss0, _ = _grads(jcfg, cfg, True)
        assert loss > loss0
        key = "['blocks']['0']['mlp']['router']"
        assert float(np.max(np.abs(jg0[key] - jg[key]))) > \
            1e-3 * float(np.max(np.abs(jg[key])))


@pytest.mark.parametrize("aux_weights", [None, (0.01, 1e-3)])
def test_jamba_lm_loss_gradients_match_jax(aux_weights):
    """Reduced jamba (attention on slot 4, Mamba-2 elsewhere, MoE on the odd
    slots) in float32, flash on, with and without the MoE auxiliary
    losses: the loss within 1e-5 relative, each leaf's gradient within
    5e-3 and 1e-4 of its largest."""
    jcfg, cfg = _configs(arch=JAMBA)
    jl, jg, loss, grads = _grads(jcfg, cfg, True, aux_weights=aux_weights)
    assert abs(loss - jl) <= 1e-5 * abs(jl)
    assert set(grads) == set(jg)
    for key, g in grads.items():
        err = float(np.max(np.abs(_t(g) - jg[key])))
        peak = float(np.max(np.abs(jg[key])))
        assert err < 5e-3 and err <= 1e-4 * peak, (key, err, peak)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["llsc-100m", "mamba2-370m",
                                  "granite-moe-1b-a400m"])
def test_bf16_grads_match_jax(arch, remat):
    """The ``bf16_grads`` flag in float32, on both sides: every block's
    output cotangent rounded to bf16.  Each leaf's gradient within 1e-4 of
    its largest of the reference's under the flag; the port's gradients
    without the flag lie beyond that, so the flag is not ignored (and
    under remat "full" it acts in the recompute too)."""
    jcfg, cfg = _configs(arch=arch, n_layers=2, remat=remat)
    jl, jg, loss, grads = _grads(jcfg, cfg, True, bf16_grads=True)
    _, _, loss0, grads0 = _grads(jcfg, cfg, True)
    assert abs(loss - jl) <= 1e-5 * abs(jl) and loss == loss0
    flagged, unflagged = _worst_share(grads, jg), _worst_share(grads0, jg)
    print(f"worst share: with the flag {flagged:.3e}, without {unflagged:.3e}")
    assert flagged <= 1e-4 < unflagged


@pytest.mark.parametrize("flash", [False, True])
def test_lm_loss_gradients_match_jax_bfloat16(flash):
    """bf16 compute: ``cast_params`` makes the stacked ln1/ln2 scales bf16
    and leaves final_norm's scale float32, on both sides.  Each leaf within
    2e-2 of its largest gradient."""
    jcfg, cfg = _configs("bfloat16")
    jl, jg, loss, grads = _grads(jcfg, cfg, flash)
    assert abs(loss - jl) <= 2e-2 * abs(jl)
    worst = 0.0
    for key, g in grads.items():
        assert g.dtype == F32, key
        peak = float(np.max(np.abs(jg[key])))
        ratio = float(np.max(np.abs(_t(g) - jg[key]))) / peak
        worst = max(worst, ratio)
        assert ratio <= 2e-2, (key, ratio)
    print(f"worst |grad - jax grad| / max|jax grad| over leaves: {worst:.3e}")


def test_cast_params_keeps_one_dimensional_leaves_float32():
    """The trap of the reference's ``cast_params``: ndim > 1 decides, so the
    stacked [n_periods, d] norm scales become bf16, final_norm's [d] not."""
    jcfg, cfg = _configs("bfloat16")
    _, params = _masters(jcfg, cfg)
    cast = _paths(ts.cast_params(params, "bfloat16"))
    assert cast["['blocks']['0']['ln1']['scale']"].dtype == torch.bfloat16
    assert cast["['blocks']['0']['mixer']['wq']"].dtype == torch.bfloat16
    assert cast["['final_norm']['scale']"].dtype == F32
    jstate, _ = _masters(jcfg, cfg)
    jcast = jax_ts.cast_params(jstate.params, "bfloat16")
    jdt = {jax.tree_util.keystr(p): str(a.dtype) for p, a in
           jax.tree_util.tree_flatten_with_path(jcast)[0]}
    assert {k: str(v.dtype).split(".")[1] for k, v in cast.items()} == jdt


def test_cast_params_makes_mamba_float32_leaves_bf16_as_jax_does():
    """Training casts every float32 leaf of more than one dimension, so the
    stacked A_log, D and dt_bias [n_periods, H] enter the forward in bf16
    on both sides (serving keeps them float32); every leaf's dtype equals
    the reference's."""
    jcfg, cfg = _configs("bfloat16", arch="mamba2-370m")
    jstate, params = _masters(jcfg, cfg)
    cast = _paths(ts.cast_params(params, "bfloat16"))
    jcast = jax_ts.cast_params(jstate.params, "bfloat16")
    jdt = {jax.tree_util.keystr(p): str(a.dtype) for p, a in
           jax.tree_util.tree_flatten_with_path(jcast)[0]}
    assert {k: str(v.dtype).split(".")[1] for k, v in cast.items()} == jdt
    for name in ("A_log", "D", "dt_bias"):
        assert cast[f"['blocks']['0']['mixer'][{name!r}]"].dtype == \
            torch.bfloat16


def test_mamba_bfloat16_scan_inputs_take_the_reference_dtypes(monkeypatch):
    """bf16 compute on reduced mamba2-370m, the masters cast by
    ``cast_params`` on both sides: the SSD scan takes dt (dt_raw + the bf16
    dt_bias) in float32 and A = -exp(A_log) in bf16, as the reference's
    ``mamba2_forward`` does, and the loss agrees within 2e-2.  Gradients
    are held in float32 (``test_three_train_steps_match_jax``): in bf16
    those of D and dt_bias are sums with cancellation, rounded at other
    places by the two frameworks."""
    seen = {"jax": [], "torch": []}

    def spy(side, fn):
        def wrapped(x, dt, A, *rest, **kw):
            seen[side].append((str(dt.dtype).split(".")[-1],
                               str(A.dtype).split(".")[-1]))
            return fn(x, dt, A, *rest, **kw)
        return wrapped

    monkeypatch.setattr(jax_ssm, "ssd_chunked",
                        spy("jax", jax_ssm.ssd_chunked))
    monkeypatch.setattr(ssm_mod, "ssd_chunked",
                        spy("torch", ssm_mod.ssd_chunked))
    jcfg, cfg = _configs("bfloat16", arch="mamba2-370m")
    jl, _, loss, _ = _grads(jcfg, cfg, False)
    assert seen["torch"] and set(seen["torch"]) == set(seen["jax"]) == {
        ("float32", "bfloat16")}
    assert abs(loss - jl) <= 2e-2 * abs(jl)


# --------------------------------------------------------------------------
# (c) AdamW and its schedule; (d) the weight-decay mask
# --------------------------------------------------------------------------


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # unclipped, clipped
def test_adamw_update_matches_jax(grad_scale):
    jcfg, cfg = _configs()
    jstate, params = _masters(jcfg, cfg)
    rng = np.random.default_rng(5)
    jp = jstate.params
    draw = {k: rng.standard_normal(v.shape, dtype=np.float32)
            for k, v in _jax_paths(jp).items()}
    treedef = jax.tree_util.tree_structure(jp)
    keys = list(_jax_paths(jp))

    def jtree(fn):
        return jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(fn(draw[k])) for k in keys])

    def ttree(fn):
        flat = {k: torch.from_numpy(np.asarray(fn(draw[k]))) for k in keys}
        return _unpaths(params, flat)

    grads = (lambda a: a * grad_scale)
    m = (lambda a: a * 0.01)
    v = (lambda a: np.abs(a) * 1e-4)
    ocfg = jax_opt.AdamWConfig(warmup_steps=4, total_steps=20)
    jnew, jst, jmet = jax_opt.adamw_update(
        jp, jtree(grads), jax_opt.AdamWState(jnp.int32(6), jtree(m),
                                             jtree(v)), ocfg)
    pcfg = opt.AdamWConfig(warmup_steps=4, total_steps=20)
    new, st, met = opt.adamw_update(params, ttree(grads),
                                    opt.AdamWState(6, ttree(m), ttree(v)),
                                    pcfg)
    assert st.step == 7 == int(jst.step)
    assert math.isclose(met["lr"], float(jmet["lr"]), rel_tol=1e-6)
    assert math.isclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                        rel_tol=1e-6)
    for mine, theirs in ((new, jnew), (st.m, jst.m), (st.v, jst.v)):
        want = _jax_paths(theirs)
        for key, t in _paths(mine).items():
            assert t.dtype == F32
            np.testing.assert_allclose(_t(t), want[key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)


def _unpaths(like, flat):
    """``flat`` ({keystr: tensor}) arranged as ``like``."""
    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        return flat["".join(f"[{k!r}]" for k in path)]
    return build(like, ())


def test_lr_schedule_matches_jax():
    ocfg = jax_opt.AdamWConfig(warmup_steps=10, total_steps=50)
    pcfg = opt.AdamWConfig(warmup_steps=10, total_steps=50)
    for step in (1, 10, 30, 50):     # 1, warmup, mid-decay, total
        want = float(jax_opt.lr_schedule(ocfg, jnp.int32(step)))
        assert math.isclose(opt.lr_schedule(pcfg, step), want, rel_tol=1e-6)
    assert math.isclose(opt.lr_schedule(pcfg, 1), 3e-4 / 10)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_jax(arch):
    """Over every leaf of the full-size tree (shapes only): the mask reads
    the reference's key string, so A_log, D, dt_bias and every norm scale
    are not decayed, and conv_b is."""
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k),
                            jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): jax_opt._decay_mask(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    from repro_torch.configs import get_config

    spec = tf.param_spec(get_config(arch))
    got = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            got["".join(f"[{k!r}]" for k in path)] = opt._decay_mask(path)

    walk(spec, ())
    assert got == want
    assert not all(got.values()) and any(got.values())


# --------------------------------------------------------------------------
# (e) three train steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, remat):
    """Losses within 1e-5 relative, parameters within ``update_gaps``'
    bounds, with ``cfg.remat`` the same on both sides; an optimizer that
    does not step, or steps the wrong way, fails those bounds.  The
    moments are in the config's ``opt_dtype``: bfloat16 for jamba."""
    _three_steps(*_configs(arch=arch, remat=remat))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_granite_train_steps_with_aux_losses_match_jax(remat):
    """Two stacked MoE layers, ``make_train_step(aux_weights=(0.01,
    1e-3))`` on both sides, as the previous test."""
    _three_steps(*_configs(arch="granite-moe-1b-a400m", remat=remat,
                           n_layers=2), aux_weights=(0.01, 1e-3))


def _three_steps(jcfg, cfg, aux_weights=None):
    jstate, params = _masters(jcfg, cfg)
    p0 = {k: v.clone() for k, v in _paths(params).items()}
    jb, batch = _jax_batch(cfg, 0)
    g1 = _jax_paths(jax.grad(lambda p: jax_tf.lm_loss(
        p, jcfg, jb["tokens"], jb["labels"], aux_weights=aux_weights))(
            jstate.params))
    jstep = jax.jit(jax_ts.make_train_step(jcfg, jax_ts.default_opt_cfg(
        jcfg, total_steps=3), aux_weights=aux_weights))
    ocfg = ts.default_opt_cfg(cfg, total_steps=3)
    step_fn = ts.make_train_step(cfg, ocfg, aux_weights=aux_weights)
    state = ts.TrainState(params, opt.init_opt_state(params, ocfg))
    lrs = []
    for k in range(3):
        jb, batch = _jax_batch(cfg, k)
        jstate, jmet = jstep(jstate, jb)
        state, met = step_fn(state, batch)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
            1e-5 * abs(float(jmet["loss"]))
        lrs.append(met["lr"])
    want = {k: torch.from_numpy(v.copy()) for k, v in
            _jax_paths(jstate.params).items()}
    g1 = {k: torch.from_numpy(v.copy()) for k, v in g1.items()}
    got = _paths(state.params)
    assert all(t.dtype == F32 for t in got.values())
    moment = getattr(torch, cfg.opt_dtype)
    assert all(t.dtype == moment for tree in (state.opt.m, state.opt.v)
               for t in tf.leaves(tree))
    assert state.opt.step == 3
    update_gaps = _chip_smoke().update_gaps
    tight, loose, held = update_gaps(got, want, g1, lrs)
    print(f"tight {tight:.3e} on {held:.2%} of the elements, loose "
          f"{loose:.3e}")
    assert tight <= 1 and loose <= 1, (tight, loose)
    assert held > 0.25
    # planted faults: no step at all, and every step's sign flipped
    flipped = {k: 2 * p0[k] - want[k] for k in want}
    for fault in (p0, flipped):
        assert update_gaps(fault, want, g1, lrs)[0] > 10


# --------------------------------------------------------------------------
# (e') cfg.remat against itself
# --------------------------------------------------------------------------


def _kernel_stand_ins(monkeypatch):
    """Stand in for the card: every kernel wrapper counts its launch and
    runs the plain version (after the wrapper's own autograd guard), and
    ``kernels.ops`` takes the kernel route for CPU tensors."""
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
    stand_in(rn, "gated_rmsnorm", "gated_rmsnorm", ref.gated_rmsnorm_ref)
    stand_in(ssd_kernel, "ssd_intra_chunk", "ssd_intra_chunk",
             ref.ssd_intra_chunk_ref)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    return launches


def _forward_launches(cfg):
    """The block-level kernels one forward of every layer launches: by each
    layer's mixer, flash or the gated norm and the SSD block, and ln1, and
    ln2 where the block has an FFN (the reduced mamba has one)."""
    slots = list(zip(cfg.layer_pattern, cfg.mlp_pattern))
    out = {}
    for kind, mlp_kind in slots * cfg.n_periods + slots[:cfg.n_remainder]:
        for name in (("gated_rmsnorm", "ssd_intra_chunk") if kind == "ssm"
                     else ("flash_attention",)):
            out[name] = out.get(name, 0) + 1
        ffn = mlp_kind == "moe" or cfg.d_ff > 0
        out["rmsnorm"] = out.get("rmsnorm", 0) + (2 if ffn else 1)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_gradients_of_none_bit_for_bit(arch, monkeypatch):
    """Two layers (jamba: its period of 8), the kernel routes stood in:
    "full" and "dots" (and the ``remat_dots`` flag) give the loss and the
    gradients of "none" bit for bit, and launch every block-level forward
    kernel twice a step (once in the forward, once in the backward's
    recompute); the final norm, outside the periods, once."""
    launches = _kernel_stand_ins(monkeypatch)
    _, base = _configs(arch=arch, n_layers=_two_layers(arch))
    params = ts.init_train_state(base, torch.Generator().manual_seed(0),
                                 ts.default_opt_cfg(base), device="cpu").params
    batch = SyntheticLM(DataConfig(base.vocab_size, S, B, 0)).batch(0)
    per_forward = _forward_launches(base)
    out = {}
    for remat, flags in (("none", ""), ("full", ""), ("dots", ""),
                         ("full", "remat_dots")):
        launches.clear()
        cfg = dataclasses.replace(base, remat=remat)
        with perf_flags(PerfFlags.parse("flash_kernel," + flags)):
            loss, grads = ts.loss_and_grads(params, cfg, batch,
                                            aux_weights=(0.01, 1e-3))
        runs = 1 if remat == "none" else 2
        want = {k: n * runs for k, n in per_forward.items()}
        want["rmsnorm"] += 1
        assert launches == want, (remat, flags, launches)
        out[remat, flags] = (loss, _paths(grads))
    loss0, g0 = out["none", ""]
    for key, (loss, g) in out.items():
        assert torch.equal(loss, loss0), key
        assert all(torch.equal(g[k], g0[k]) for k in g0), key


def test_remat_recompute_takes_the_forward_routes_on_another_thread():
    """On the card the autograd engine runs the backward, and with it the
    recompute of each period, on its own device thread, where the forward
    thread's PerfFlags are not set.  The recompute must still take the
    forward's routes (flash attention here): a backward run from another
    thread gives the gradients of one run on the forward's thread."""
    _, cfg = _configs(n_layers=2, remat="full")
    params = ts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                 ts.default_opt_cfg(cfg), device="cpu").params
    batch = SyntheticLM(DataConfig(cfg.vocab_size, S, B, 0)).batch(0)
    with perf_flags(PerfFlags(flash_kernel=True)):
        _, want = ts.loss_and_grads(params, cfg, batch)
        masters = tf._tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = model_lib.lm_loss(ts.cast_params(masters, cfg.dtype), cfg,
                                 batch["tokens"], batch["labels"])
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, list(tf.leaves(masters)))
        except RuntimeError as e:
            out["error"] = e

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and "error" not in out, out.get("error")
    assert all(torch.equal(g, w) for g, w in
               zip(out["grads"], tf.leaves(want)))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_leaves_the_serve_paths_alone(arch, monkeypatch):
    """Prefill and decode record no graph, so ``_remat`` is never entered
    and the prefill logits are the same whatever ``cfg.remat`` says."""
    _, base = _configs(arch=arch, n_layers=_two_layers(arch))
    params = model_lib.init_params(base, torch.Generator().manual_seed(0),
                                   device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab_size, (1, 24)))

    def no_remat(*_a, **_k):
        raise AssertionError("the serve path entered _remat")

    monkeypatch.setattr(tf, "_remat", no_remat)
    logits = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        logits[remat], caches = model_lib.prefill(params, cfg, tokens)
        model_lib.decode_step(params, cfg, tokens[:, :1], caches, 24)
    assert torch.equal(logits["full"], logits["none"])
    assert torch.equal(logits["dots"], logits["none"])


# --------------------------------------------------------------------------
# (f) the port's data
# --------------------------------------------------------------------------


def test_synthetic_lm_structure_and_zipf_marginal():
    data = SyntheticLM(DataConfig(vocab_size=512, seq_len=255, batch_size=64,
                                  seed=3))
    b = data.batch(7)
    tokens, labels = b["tokens"], b["labels"]
    assert tokens.shape == labels.shape == (64, 255)
    assert torch.equal(data.batch(7)["tokens"], tokens)       # (seed, step)
    assert not torch.equal(data.batch(8)["tokens"], tokens)
    other = SyntheticLM(DataConfig(512, 255, 64, seed=4)).batch(7)
    assert not torch.equal(other["tokens"], tokens)
    assert torch.equal(labels[:, :-1], tokens[:, 1:])         # shifted by one
    full = torch.cat([tokens, labels[:, -1:]], dim=1)         # [B, S + 1]
    half = 256 // 2
    assert torch.equal(full[:, half:2 * half], full[:, :half])
    # rank 1 (token 0) of Zipf 1.1 over 512, in the first halves only
    # (the second halves repeat them): within 5 standard deviations
    p0 = 1.0 / sum(1.0 / r ** 1.1 for r in range(1, 513))
    n = full[:, :half].numel()
    freq = float((full[:, :half] == 0).sum()) / n
    assert abs(freq - p0) <= 5 * math.sqrt(p0 * (1 - p0) / n), (freq, p0)
    assert int(full.max()) < 512 and int(full.min()) >= 0


# --------------------------------------------------------------------------
# (g) Trainer and launch.train on the CPU
# --------------------------------------------------------------------------


def test_trainer_runs_on_the_cpu_and_publishes():
    cfg = reduced_config("llsc-100m")
    tcfg = TrainerConfig(steps=3, batch_size=2, seq_len=32, device="cpu",
                         job_name="test:trainer", peak_flops=1e12,
                         mem_total_gb=16.0)
    trainer = Trainer(cfg, tcfg)
    out = trainer.run()
    assert len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"])
    assert [h["step"] for h in trainer.history] == [0, 1, 2]
    pub = JobRegistry.global_registry().entries()["test:trainer"]
    assert pub.duty_cycle > 0 and pub.hbm_total_gb == 16.0
    assert pub.hbm_used_gb > 0 and pub.n_devices == 1
    assert out["state"].opt.step == 3
    with pytest.raises(ValueError, match="peak_flops and mem_total_gb"):
        Trainer(cfg, dataclasses.replace(tcfg, peak_flops=None))


def test_launch_train_on_the_cpu(capsys):
    rc = launch_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                            "--batch", "2", "--seq", "64", "--peak-flops",
                            "1e12", "--mem-total-gb", "16", "--flags",
                            "flash_kernel"])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in
              out.split("[launch.train] losses:")[1].splitlines()[0].split()]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "[launch.train] done: steps=3 final_loss=" in out
    pub = JobRegistry.global_registry().entries()["train:llsc-100m-reduced"]
    assert 0 < pub.duty_cycle


def test_launch_train_usage_errors(capsys):
    assert launch_train.main(["--flags", "no_such_flag"]) == 2
    assert launch_train.main(["--arch", "no-such-arch"]) == 2
    assert launch_train.main(["--device", "cpu", "--reduced"]) == 2
    assert launch_train.main(["--steps", "0"]) == 2
    capsys.readouterr()


def test_launch_train_mamba2_on_the_cpu(capsys):
    rc = launch_train.main(["--arch", "mamba2-370m", "--reduced", "--device",
                            "cpu", "--steps", "3", "--batch", "2", "--seq",
                            "32", "--peak-flops", "1e12", "--mem-total-gb",
                            "16"])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in
              out.split("[launch.train] losses:")[1].splitlines()[0].split()]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "start_step=0" in out
    pub = JobRegistry.global_registry().entries()[
        "train:mamba2-370m-reduced"]
    assert 0 < pub.duty_cycle


@pytest.mark.parametrize("remat", ["none", "full"])
def test_launch_train_granite_on_the_cpu(remat, monkeypatch, capsys):
    """Reduced granite-moe-1b-a400m, flash on, with the config's remat
    ("none" in the reduced config) and with "full"; the published duty's
    model FLOPs are those of the active parameters."""
    from repro_torch.configs import base as configs_base

    if remat == "full":
        reduced = configs_base.reduced_config
        monkeypatch.setattr(launch_train, "reduced_config", lambda cfg: (
            dataclasses.replace(reduced(cfg), remat="full")))
    rc = launch_train.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                            "--device", "cpu", "--steps", "3", "--batch",
                            "2", "--seq", "32", "--peak-flops", "1e12",
                            "--mem-total-gb", "16", "--flags",
                            "flash_kernel"])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in
              out.split("[launch.train] losses:")[1].splitlines()[0].split()]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    pub = JobRegistry.global_registry().entries()[
        "train:granite-moe-1b-a400m-reduced"]
    cfg = reduced_config("granite-moe-1b-a400m")
    active = model_lib.count_params_analytic(cfg, True)
    assert active < model_lib.count_params(cfg)
    assert pub.achieved_flops == pytest.approx(
        6 * active * 2 * 32 / pub.step_time_s)


def test_launch_train_crash_at_0_injects_no_crash(tmp_path, capsys):
    """0 is the reference's "no crash" (it builds the injector only if
    ``args.crash_at``): every step runs and the launcher exits 0."""
    rc = launch_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                            "--batch", "2", "--seq", "32", "--peak-flops",
                            "1e12", "--mem-total-gb", "16", "--crash-at",
                            "0", "--ckpt-dir", str(tmp_path / "ck")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[launch.train] done: steps=3 " in out and "start_step=0" in out
    assert len(out.split("[launch.train] losses:")[1].splitlines()[0]
               .split()) == 3


def test_launch_train_crashes_and_resumes(tmp_path, capsys):
    """``--crash-at 5`` exits 1 with the injected failure after the
    checkpoints of steps 2 and 4; the same command again resumes from step
    4 and ends at the uninterrupted run's loss."""
    args = ["--reduced", "--device", "cpu", "--steps", "8", "--batch", "2",
            "--seq", "32", "--peak-flops", "1e12", "--mem-total-gb", "16"]
    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    assert launch_train.main(args + ckpt + ["--crash-at", "5"]) == 1
    assert "error: injected node failure at step 5" in \
        capsys.readouterr().err
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step-000000002", "step-000000004"]
    assert launch_train.main(args + ckpt) == 0
    resumed = capsys.readouterr().out
    assert launch_train.main(args) == 0
    whole = capsys.readouterr().out

    def done(out):
        line = out.split("[launch.train] done: ")[1].splitlines()[0]
        return dict(kv.split("=") for kv in line.split())

    assert done(resumed)["start_step"] == "4"
    assert done(whole)["start_step"] == "0"
    assert math.isclose(float(done(resumed)["final_loss"]),
                        float(done(whole)["final_loss"]), rel_tol=1e-4)
    assert launch_train.main(args + ckpt + ["--ckpt-every", "0"]) == 2
