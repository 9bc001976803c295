"""chip_smoke.py on the CPU: its check that a profiler trace of the device
holds every record of the calls it traced (``trace_losses``), on made-up
traces; its phase list; the launch arithmetic of phase 55's sampled serve;
phase 57's inputs; and phase 59's dry-run probe."""
import importlib.util
from pathlib import Path

import pytest


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(**counts):
    """Activities (name, us, start, end) with ``counts[name]`` of each."""
    return [(name, 1.0, 0, 1) for name, n in counts.items()
            for _ in range(n)]


@pytest.mark.parametrize("counts, lost", [
    ({}, True),                             # the trace is empty
    ({"kernel": 100}, False),               # one launch a call
    ({"kernel": 99}, True),                 # one record gone
    ({"memset": 100, "kernel": 100}, False),
    ({"memset": 150, "kernel": 50}, True),  # the total is still 200
    ({"mul": 300, "add": 100}, False),      # one name three times a call
])
def test_trace_losses(counts, lost):
    assert _chip_smoke().trace_losses(_trace(**counts), 100) is lost


def _docstring_phases(mod):
    """The numbers of the docstring's phase list, in order."""
    import re

    return [int(m.group(1)) for m in re.finditer(r"^(\d+)\. ", mod.__doc__,
                                                 re.M)]


def test_phase_list_runs_1_to_59_with_the_summary_last():
    """The docstring lists phases 1-60 in order; main prints the phases
    55-59 through ``phase_clock`` and the summary last, as 60."""
    import inspect

    mod = _chip_smoke()
    assert _docstring_phases(mod) == list(range(1, 61))
    src = inspect.getsource(mod.main)
    for phase in (55, 56, 57, 58, 59):
        assert f"phase_clock(seconds, {phase}, " in src
    assert src.index("=== 60. summary") > src.index("phase_clock(seconds, 59")
    assert '"serve llsc-100m, sampled"' in src


def test_sampled_serve_launches_as_serve_launches_says(monkeypatch):
    """Phase 55's arithmetic on reduced llsc-100m on the CPU, each kernel
    wrapper counting its launch and running its plain version: a sampled
    serve through 4 slots launches exactly ``serve_launches`` (sampling
    adds no kernel), as a greedy one does."""
    torch = pytest.importorskip("torch")
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import _guard, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import model as model_lib
    from repro_torch.models.perf_flags import PerfFlags, perf_flags
    from repro_torch.serve import engine

    cs = _chip_smoke()
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
    cfg = reduced_config("llsc-100m")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    for ecfg in ({}, cs.SAMPLING):
        launches.clear()
        eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
            slots=4, max_seq_len=64, device="cpu", monitor=False, **ecfg))
        for r in cs.make_requests(engine, cfg.vocab_size, 8, seed=1,
                                  lens=(16, 32), new=8):
            eng.submit(r)
        with perf_flags(PerfFlags(flash_kernel=True)):
            stats = eng.run()
        want = cs.serve_launches(cfg, len(eng.prefill_s), stats["steps"])
        assert launches == {k: v for k, v in want.items() if v}
        assert want["flash_attention"] == cfg.n_layers * 8
        assert stats["requests"] == 8


def test_a2a_inputs_are_granite_experts_at_full_width():
    torch = pytest.importorskip("torch")
    mod = _chip_smoke()
    spec, params, x = mod.a2a_inputs(torch)
    assert (spec.n_experts, spec.top_k, spec.d_ff_expert,
            spec.capacity_factor) == (32, 8, 512, 8.0)
    assert tuple(x.shape) == mod.A2A_SHAPE == (4, 32, 1024)
    assert tuple(params["w2"].shape) == (32, 512, 1024)
    for shape in mod.A2A_MESHES:
        assert shape[0] * shape[1] == mod.A2A_WORLD
        assert spec.n_experts % shape[1] == 0
        assert x.shape[0] % shape[0] == 0 and x.shape[1] % shape[1] == 0


def test_dry_run_probe_counts_phase_11s_step(tmp_path):
    """Phase 59's probe on the CPU, as the card runs it: llsc-100m's train
    step at 8 x 256 on a one-rank group; its arguments are the bytes of a
    TrainState and an int32 batch built on the CPU, its FLOPs above 6 N D
    (remat "full" recomputes the blocks' forward, and attention adds its
    own), and no group outlives it."""
    import json

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.train import train_step as ts

    mod = _chip_smoke()
    out = tmp_path / "cost.json"
    assert mod.dry_run_probe(out) == 0
    assert not torch.distributed.is_initialized()
    cost = json.loads(out.read_text())
    cfg = get_config("llsc-100m")
    _, S, B, _ = mod.DRY_RUN_SHAPE
    state = ts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                ts.default_opt_cfg(cfg), device="cpu")
    built = sum(t.numel() * t.element_size()
                for t in torch.utils._pytree.tree_flatten(state)[0]
                if isinstance(t, torch.Tensor)) + 2 * B * S * 4
    assert cost["memory_analysis"]["argument_size_in_bytes"] == built
    mf = model_lib.model_flops(cfg, B * S, training=True)
    assert 1 < cost["flops"] / mf < 2
    assert cost["collective"] == dict.fromkeys(cost["collective"], 0.0)
    assert cost["probe"] == f"full-depth(P={cfg.n_periods})"
