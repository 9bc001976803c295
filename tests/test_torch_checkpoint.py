"""The port's checkpoints, crash injection and resume against the JAX
package's, on the CPU: counterparts of tests/test_checkpoint_fault.py and
of test_train_extras.py::test_async_checkpoint_trainer; a train state
written by either package restored by the other, leaf for leaf
(``.opt.step`` included); the async save's snapshot invariant; and the
port's copies of ``ElasticResizePlan`` and ``CrashInjector`` against the
originals.  The train states are reduced llsc-100m, reduced
mamba2-370m, reduced granite-moe-1b-a400m (its float32 router among
the leaves) and reduced jamba-1.5-large-398b, whose moments are bfloat16:
stored as float32 and restored as bfloat16 by either package.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.launch import fault as jax_fault  # noqa: E402
from repro.train import checkpoint as jax_ck  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models.transformer import leaves  # noqa: E402
from repro_torch.launch.fault import (CrashInjector,  # noqa: E402
                                      ElasticResizePlan, StragglerDetector,
                                      resume_latest)
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

F32 = torch.float32
ARCHS = ["llsc-100m", "mamba2-370m", "granite-moe-1b-a400m",
         "jamba-1.5-large-398b"]


def _tc(**changes):
    """The reference tests' small run: 8 steps of 2 x 32 tokens on the CPU,
    nothing published or logged."""
    base = dict(steps=8, batch_size=2, seq_len=32, ckpt_every=2, log_every=0,
                monitor_every=0, device="cpu")
    return TrainerConfig(**{**base, **changes})


# --------------------------------------------------------------------------
# counterparts of tests/test_checkpoint_fault.py
# --------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    state = {"a": torch.arange(6, dtype=F32).reshape(2, 3),
             "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    ck.save_checkpoint(str(tmp_path), 5, state)
    template = {"a": torch.empty(2, 3, device="meta"),
                "b": {"c": torch.empty(4, dtype=torch.bfloat16,
                                       device="meta")}}
    restored, meta = ck.restore_checkpoint(str(tmp_path), 5, template,
                                           device="cpu")
    assert meta["step"] == 5
    assert torch.equal(restored["a"], state["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], state["b"]["c"])
    with np.load(tmp_path / "step-000000005" / "arrays.npz") as zf:
        assert sorted(zf.files) == ["['a']", "['b']['c']"]
        assert zf["['b']['c']"].dtype == np.float32   # bf16 stored as f32


def test_retention(tmp_path):
    state = {"a": torch.zeros(2)}
    for step in range(6):
        ck.save_checkpoint(str(tmp_path), step, state, keep=3)
    assert ck.list_checkpoints(str(tmp_path)) == [3, 4, 5]


def test_latest_ignores_torn_tmp(tmp_path):
    state = {"a": torch.zeros(2)}
    ck.save_checkpoint(str(tmp_path), 1, state)
    os.makedirs(tmp_path / ".tmp-step-2")  # simulated torn write
    assert ck.latest_step(str(tmp_path)) == 1


def test_shape_mismatch_rejected(tmp_path):
    ck.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)},
                              device="cpu")
    with pytest.raises(KeyError, match="checkpoint missing"):
        ck.restore_checkpoint(str(tmp_path), 1, {"b": torch.zeros(2)},
                              device="cpu")


def test_crash_restart_resumes_and_matches(tmp_path):
    """Deterministic data + restart => the uninterrupted final loss."""
    cfg = reduced_config("llsc-100m")
    ref = Trainer(cfg, _tc()).run(resume=False)

    ckpt_dir = str(tmp_path / "ck")
    t1 = Trainer(cfg, _tc(ckpt_dir=ckpt_dir), crash=CrashInjector(5))
    with pytest.raises(RuntimeError, match="injected node failure at step 5"):
        t1.run(resume=False)
    assert ck.latest_step(ckpt_dir) == 4

    out = Trainer(cfg, _tc(ckpt_dir=ckpt_dir)).run(resume=True)
    assert out["start_step"] == 4
    assert out["final_loss"] == pytest.approx(ref["final_loss"], rel=1e-4)
    assert out["state"].opt.step == 8
    assert ck.list_checkpoints(ckpt_dir) == [4, 6, 8]


def test_straggler_detection():
    det = StragglerDetector(slow_factor=1.5)
    for _ in range(10):
        for host in ("host-0", "host-1", "host-2", "host-3"):
            det.record(host, 1.0)
        det.record("host-slow", 2.5)
    reports = det.stragglers()
    assert [r.host for r in reports] == ["host-slow"]
    assert reports[0].factor == pytest.approx(2.5, rel=0.05)


def test_no_false_stragglers():
    det = StragglerDetector(slow_factor=1.5)
    for _ in range(10):
        for i in range(4):
            det.record(f"h{i}", 1.0 + 0.05 * i)
    assert det.stragglers() == []


def test_resume_latest_empty(tmp_path):
    state, step = resume_latest(str(tmp_path / "none"), {"a": torch.zeros(2)},
                                device="cpu")
    assert state is None and step == 0


# --------------------------------------------------------------------------
# the async save (counterpart of test_async_checkpoint_trainer)
# --------------------------------------------------------------------------


def test_async_checkpoint_trainer(tmp_path):
    cfg = reduced_config("llsc-100m")
    t = Trainer(cfg, _tc(steps=6, ckpt_dir=str(tmp_path), async_ckpt=True))
    out = t.run(resume=False)
    ck.wait_pending_checkpoints()
    steps = ck.list_checkpoints(str(tmp_path))
    assert 6 in steps and len(steps) >= 2
    template = ts.init_train_state_shape(cfg, t.opt_cfg)
    state, meta = ck.restore_checkpoint(str(tmp_path), 6, template,
                                        device="cpu")
    assert meta["step"] == 6 and state.opt.step == 6
    got, want = ck._flatten(state), ck._flatten(out["state"])
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def _slow_savez(monkeypatch):
    """np.savez that waits for ``release`` before writing, so that a save
    is in flight while the test goes on."""
    release = threading.Event()
    savez = np.savez

    def wait_then_save(*args, **kw):
        assert release.wait(timeout=60)
        return savez(*args, **kw)

    monkeypatch.setattr(np, "savez", wait_then_save)
    return release


def test_async_save_holds_the_state_it_was_given(tmp_path, monkeypatch):
    """A train step runs while the save of its input state is in flight:
    the file holds the saved step's values, since a step builds new tensors
    and leaves the state it was given as it was.  An update in place (the
    planted fault) would reach the file, so the check can fail."""
    cfg = reduced_config("llsc-100m")
    ocfg = ts.default_opt_cfg(cfg)
    state = ts.init_train_state(cfg, torch.Generator().manual_seed(0), ocfg,
                                device="cpu")
    step_fn = ts.make_train_step(cfg, ocfg)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2, 0)).batch(0)
    state, _ = step_fn(state, batch)
    saved = {k: v.copy() for k, v in ck._flatten(state).items()}
    template = ts.init_train_state_shape(cfg, ocfg)

    release = _slow_savez(monkeypatch)
    ck.save_checkpoint_async(str(tmp_path / "a"), 1, state)
    later, _ = step_fn(state, batch)        # while the save is in flight
    release.set()
    ck.wait_pending_checkpoints()
    got = ck._flatten(ck.restore_checkpoint(str(tmp_path / "a"), 1,
                                            template, device="cpu")[0])
    assert got.keys() == saved.keys()
    assert all(np.array_equal(got[k], saved[k]) for k in saved)
    assert not np.array_equal(ck._flatten(later)[".params['embed']"],
                              saved[".params['embed']"])

    release.clear()
    ck.save_checkpoint_async(str(tmp_path / "b"), 1, state)
    state.params["embed"].add_(1.0)         # the planted in-place update
    release.set()
    ck.wait_pending_checkpoints()
    got = ck._flatten(ck.restore_checkpoint(str(tmp_path / "b"), 1,
                                            template, device="cpu")[0])
    assert not np.array_equal(got[".params['embed']"],
                              saved[".params['embed']"])


def test_async_save_error_is_raised_by_wait(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    ck.save_checkpoint_async(str(blocker), 1, {"a": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait_pending_checkpoints()
    ck.wait_pending_checkpoints()           # the error is raised once


# --------------------------------------------------------------------------
# one file format: each package restores the other's train state
# --------------------------------------------------------------------------


def _jax_state(arch):
    """The JAX package's train state of reduced ``arch`` after one step."""
    jcfg = jax_reduced(arch)
    ocfg = jax_ts.default_opt_cfg(jcfg)
    state = jax_ts.init_train_state(jcfg, jax.random.PRNGKey(0), ocfg)
    batch = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in SyntheticLM(
        DataConfig(jcfg.vocab_size, 16, 2, 0)).batch(0).items()}
    state, _ = jax.jit(jax_ts.make_train_step(jcfg, ocfg))(state, batch)
    return jcfg, ocfg, state


def _keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_written_state_restores_in_the_port(arch, tmp_path):
    """Parameters and moments equal the bridge of the JAX state's, in the
    port's dtypes (the moments in the config's ``opt_dtype``); ``.opt.step``
    comes back as the int 1."""
    _, _, jstate = _jax_state(arch)
    jax_ck.save_checkpoint(str(tmp_path), 1, jstate)
    cfg = reduced_config(arch)
    template = ts.init_train_state_shape(cfg, ts.default_opt_cfg(cfg))
    state, start = resume_latest(str(tmp_path), template, device="cpu")
    assert start == 1
    assert state.opt.step == 1 and type(state.opt.step) is int
    moment = getattr(torch, cfg.opt_dtype)
    assert all(t.dtype == moment for tree in (state.opt.m, state.opt.v)
               for t in leaves(tree))
    for mine, theirs in ((state.params, jstate.params),
                         (state.opt.m, jstate.opt.m),
                         (state.opt.v, jstate.opt.v)):
        bridged = from_jax_params(jax.tree.map(np.asarray, theirs), cfg,
                                  "cpu", dtype=F32)
        got, want = ck._flatten(mine), ck._flatten(bridged)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_port_written_state_restores_in_jax(arch, tmp_path):
    """The JAX package restores the port's file into a ``jax.eval_shape``
    template: every leaf equal, the moments in the config's ``opt_dtype``,
    ``.opt.step`` an int32 1."""
    cfg = reduced_config(arch)
    ocfg = ts.default_opt_cfg(cfg)
    state = ts.init_train_state(cfg, torch.Generator().manual_seed(0), ocfg,
                                device="cpu")
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2, 0)).batch(0)
    state, _ = ts.make_train_step(cfg, ocfg)(state, batch)
    ck.save_checkpoint(str(tmp_path), 1, state)

    jcfg = jax_reduced(arch)
    template = jax.eval_shape(lambda: jax_ts.init_train_state(
        jcfg, jax.random.PRNGKey(0), jax_ts.default_opt_cfg(jcfg)))
    jstate, start = jax_fault.resume_latest(str(tmp_path), template)
    assert start == 1
    got, want = _keyed(jstate), ck._flatten(state)
    assert got.keys() == want.keys()
    assert got[".opt.step"].dtype == np.int32 and int(got[".opt.step"]) == 1
    for k in want:
        arr = got[k]
        if k.startswith((".opt.m", ".opt.v")):
            assert arr.dtype.name == cfg.opt_dtype, k
            arr = arr.astype(np.float32)
        assert arr.dtype == want[k].dtype and np.array_equal(arr, want[k]), k


# --------------------------------------------------------------------------
# the rest of launch/fault.py against the originals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("factor,min_tasks", [(0.5, 1), (0.25, 3), (1.5, 1),
                                              (0.0, 2)])
def test_elastic_resize_plan_copy(factor, min_tasks):
    mine = ElasticResizePlan("alice", factor=factor, min_tasks=min_tasks)
    theirs = jax_fault.ElasticResizePlan("alice", factor=factor,
                                         min_tasks=min_tasks)
    for n in (1, 2, 3, 7, 8, 64, 1000):
        assert mine.shrink(n) == theirs.shrink(n), n


@pytest.mark.parametrize("at", [None, 0, 3])
def test_crash_injector_copy(at):
    """The same steps raise the same message, once."""
    def fired(inj):
        out = []
        for step in list(range(5)) * 2:
            try:
                inj.maybe_crash(step)
            except RuntimeError as e:
                out.append(str(e))
        return out

    got = fired(CrashInjector(at))
    assert got == fired(jax_fault.CrashInjector(at))
    assert got == ([] if at is None else
                   [f"injected node failure at step {at}"])
