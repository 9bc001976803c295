"""The port's ServeEngine against the JAX package's on reduced llsc-100m,
reduced mamba2-370m and reduced granite-moe-1b-a400m, fp32, greedy, with
the same bridged weights: requests of ragged prompt and output lengths
through 2 slots (and, for granite, 3 slots, whose decode tokens form one
group that drops tokens) give identical completions, token for token,
and the engine publishes to the port's LLload registry."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402
from repro_torch.monitor import JobRegistry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

CPU_FIGURES = dict(peak_flops=1e12, mem_total_gb=16.0)


def _requests(mod, vocab):
    rng = np.random.default_rng(11)
    return [mod.Request(i, rng.integers(0, vocab, 8 + 4 * (i % 2))
                        .astype(np.int32), max_new_tokens=4 + i % 3)
            for i in range(6)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_reduced("llsc-100m")
    cfg = reduced_config("llsc-100m")
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def jax_completions(weights):
    jcfg, _, jparams, _ = weights
    eng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=2, max_seq_len=64, monitor=False))
    for r in _requests(jax_engine, jcfg.vocab_size):
        eng.submit(r)
    eng.run()
    return {c.request_id: c.tokens for c in eng.completions}


@pytest.mark.parametrize("flash", [False, True])
def test_completions_identical_to_jax(weights, jax_completions, flash):
    _, cfg, _, params = weights
    job = f"serve-parity-{flash}"
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=2, max_seq_len=64, job_name=job, device="cpu", **CPU_FIGURES))
    for r in _requests(engine, cfg.vocab_size):
        eng.submit(r)
    with perf_flags(PerfFlags(flash_kernel=flash)):
        stats = eng.run()
    mine = {c.request_id: c.tokens for c in eng.completions}
    assert mine == jax_completions
    assert stats["requests"] == 6
    assert stats["tokens"] == sum(len(t) for t in mine.values())
    assert len(eng.prefill_s) == 6 and len(eng.decode_s) == stats["steps"]

    pub = JobRegistry.global_registry().entries()[job]
    assert pub.n_devices == 1 and pub.step_time_s > 0
    assert pub.hbm_total_gb == 16.0 and pub.hbm_used_gb > 0
    assert 0 < pub.duty_cycle
    assert len(eng.controller.history) == stats["steps"]
    assert stats["decision"].nppn in (1, 2, 4, 8)
    JobRegistry.global_registry().remove(job)


def test_slots_that_fill_their_cache_match_jax(weights):
    """A request that runs its slot's cache full retires while the other
    slot goes on decoding; the retired slot's row must not be written past
    the end (JAX clamps the write)."""
    jcfg, cfg, jparams, params = weights
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (10, 4)]
    news = (30, 12)

    jeng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=2, max_seq_len=16, monitor=False))
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=2, max_seq_len=16, device="cpu", monitor=False))
    for i, (p, n) in enumerate(zip(prompts, news)):
        jeng.submit(jax_engine.Request(i, p, max_new_tokens=n))
        eng.submit(engine.Request(i, p, max_new_tokens=n))
    jeng.run()
    eng.run()
    theirs = {c.request_id: c.tokens for c in jeng.completions}
    mine = {c.request_id: c.tokens for c in eng.completions}
    assert mine == theirs
    assert len(mine[0]) == 16 - 10 + 1      # stopped by the full cache


@pytest.fixture(scope="module")
def mamba_weights():
    jcfg = jax_reduced("mamba2-370m")
    cfg = reduced_config("mamba2-370m")
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


def test_mamba_completions_identical_to_jax(mamba_weights):
    """Prompts of 2 tokens (shorter than the conv), 10 tokens and 40 tokens
    (three chunks of 16) through 2 slots: each refill copies the conv and
    ssd state rows whole into a slot another request used before."""
    jcfg, cfg, jparams, params = mamba_weights
    rng = np.random.default_rng(12)
    lens = (2, 10, 40, 10, 2, 40)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    jeng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=2, max_seq_len=64, monitor=False))
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=2, max_seq_len=64, device="cpu", monitor=False))
    for i, prompt in enumerate(prompts):
        jeng.submit(jax_engine.Request(i, prompt, max_new_tokens=5 + i % 3))
        eng.submit(engine.Request(i, prompt, max_new_tokens=5 + i % 3))
    jeng.run()
    stats = eng.run()
    theirs = {c.request_id: c.tokens for c in jeng.completions}
    mine = {c.request_id: c.tokens for c in eng.completions}
    assert mine == theirs
    assert stats["requests"] == len(lens)
    assert [len(mine[i]) for i in range(len(lens))] == \
        [5 + i % 3 for i in range(len(lens))]


@pytest.fixture(scope="module", params=[4.0, 1.25])
def granite_weights(request):
    """Reduced granite-moe-1b-a400m at capacity factor 4 (reduced_config's:
    nothing drops) and 1.25 (the full config's)."""
    def moe_cf(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=request.param))

    jcfg = moe_cf(jax_reduced("granite-moe-1b-a400m"))
    cfg = moe_cf(reduced_config("granite-moe-1b-a400m"))
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("slots,flash", [(2, False), (2, True), (3, True)])
def test_granite_completions_identical_to_jax(granite_weights, slots,
                                              flash, monkeypatch):
    """Through 2 slots each decode row is a group of its own; through 3
    the rows form one group of 3 tokens, in which a free slot's token
    competes for capacity with the live ones, as in the reference (at
    factor 1.25 the capacity is 1 and tokens drop)."""
    jcfg, cfg, jparams, params = granite_weights
    jeng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=slots, max_seq_len=64, monitor=False))
    job = f"serve-granite-{slots}-{flash}"
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=slots, max_seq_len=64, job_name=job, device="cpu",
        **CPU_FIGURES))
    for r in _requests(jax_engine, jcfg.vocab_size):
        jeng.submit(r)
    for r in _requests(engine, cfg.vocab_size):
        eng.submit(r)
    jeng.run()
    decode_drops = []
    positions = moe._positions

    G = moe._pick_groups(slots, 1)
    T = slots // G

    def spy(e_flat, E):
        pos = positions(e_flat, E)
        if e_flat.shape == (G, T * cfg.moe.top_k):       # a decode step
            decode_drops.append(int((pos >= moe.capacity(T, cfg.moe)).sum()))
        return pos

    monkeypatch.setattr(moe, "_positions", spy)
    with perf_flags(PerfFlags(flash_kernel=flash)):
        stats = eng.run()
    theirs = {c.request_id: c.tokens for c in jeng.completions}
    mine = {c.request_id: c.tokens for c in eng.completions}
    assert mine == theirs and stats["requests"] == 6
    drops = slots == 3 and cfg.moe.capacity_factor < 4
    assert decode_drops and (sum(decode_drops) > 0) == drops
    pub = JobRegistry.global_registry().entries()[job]
    assert 0 < pub.duty_cycle
    JobRegistry.global_registry().remove(job)


def test_cpu_engine_needs_device_figures(weights):
    _, cfg, _, params = weights
    with pytest.raises(ValueError, match="peak_flops"):
        engine.ServeEngine(cfg, params, engine.EngineConfig(device="cpu"))
    engine.ServeEngine(cfg, params, engine.EngineConfig(device="cpu",
                                                        monitor=False))


def test_registry_aggregates_jobs():
    reg = JobRegistry()
    from repro_torch.monitor import publish_step_utilization
    publish_step_utilization("a", model_flops_per_step=1e9, step_time_s=0.01,
                             peak_flops=1e12, registry=reg)
    publish_step_utilization("b", model_flops_per_step=2e9, step_time_s=0.01,
                             peak_flops=1e12, registry=reg)
    agg = reg.aggregate()
    assert agg.duty_cycle == pytest.approx(0.3)
    assert agg.achieved_flops == pytest.approx(3e11)
    reg.remove("a")
    assert set(reg.entries()) == {"b"}


@pytest.mark.parametrize("arch,reduced", [("llsc-100m", False),
                                          ("llsc-100m", True),
                                          ("mamba2-370m", False),
                                          ("granite-moe-1b-a400m", False)])
def test_card_duty_peak_follows_the_model_dtype(arch, reduced):
    """On a card the engine and the trainer measure their duty against the
    H100 peak of the model's compute dtype: bf16 on the tensor cores for
    the full configs, fp32 outside them for the float32 reduced one."""
    from repro_torch.configs import get_config
    from repro_torch.monitor import default_peak_flops
    from repro_torch.roofline import hw

    cfg = reduced_config(arch) if reduced else get_config(arch)
    want = hw.PEAK_FLOPS_FP32 if cfg.dtype == "float32" \
        else hw.PEAK_FLOPS_BF16
    assert default_peak_flops(cfg) == want
