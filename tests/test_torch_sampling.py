"""Sampling in the port's ``ServeEngine`` against the JAX package's, on the
CPU, float32, reduced llsc-100m with the same bridged weights.

jax.random's numbers cannot be reproduced in torch, so a sampled token is
held to the reference in distribution: greedy (the default) matches the
reference engine token for token; ``top_k=1`` gives greedy's tokens;
sampled tokens lie in the top k of their logits; the same (seed, step)
gives the same tokens; over 50,000 draws at a 16-token vocabulary each
token's frequency lies within 5 standard errors of the softmax of the
logits over the temperature (cut to the top k where ``top_k > 0``).
``EngineConfig`` shares the reference's fields and defaults, and
``overload_decision`` equals the reference's over the same observations.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core import overload as jax_overload  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core import overload  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ARCH = "llsc-100m"
CPU = dict(device="cpu", monitor=False)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = jax_reduced(ARCH), reduced_config(ARCH)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


def _requests(mod, vocab):
    rng = np.random.default_rng(11)
    return [mod.Request(i, rng.integers(0, vocab, 8 + 4 * (i % 2))
                        .astype(np.int32), max_new_tokens=4 + i % 3)
            for i in range(6)]


def _serve(cfg, params, **ecfg):
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=2, max_seq_len=64, **CPU, **ecfg))
    for r in _requests(engine, cfg.vocab_size):
        eng.submit(r)
    eng.run()
    return {c.request_id: c.tokens for c in eng.completions}


def test_engine_config_shares_the_reference_fields_and_defaults():
    """Every field of the reference's ``EngineConfig`` is the port's, with
    the reference's default, but ``peak_flops``: the reference's 5e10 is
    a placeholder, and the port's default (None) reads the card's
    data-sheet peak.  The port adds ``device`` and ``mem_total_gb``."""
    ref = {f.name: f.default for f in dataclasses.fields(
        jax_engine.EngineConfig)}
    mine = {f.name: f.default for f in dataclasses.fields(
        engine.EngineConfig)}
    assert set(mine) - set(ref) == {"device", "mem_total_gb"}
    assert set(ref) <= set(mine)
    for name, default in ref.items():
        if name != "peak_flops":
            assert mine[name] == default, name
    assert mine["peak_flops"] is None


def test_greedy_matches_the_reference_token_for_token(weights):
    jcfg, cfg, jparams, params = weights
    jeng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=2, max_seq_len=64, monitor=False, greedy=True))
    for r in _requests(jax_engine, jcfg.vocab_size):
        jeng.submit(r)
    jeng.run()
    want = {c.request_id: c.tokens for c in jeng.completions}
    assert _serve(cfg, params, greedy=True) == want


def test_top_k_1_gives_greedy_tokens(weights):
    _, cfg, _, params = weights
    greedy = _serve(cfg, params)
    assert _serve(cfg, params, greedy=False, top_k=1,
                  temperature=0.7, seed=5) == greedy


def test_same_seed_same_tokens_and_the_steps_drawn(weights, monkeypatch):
    """Two sampled serves of one seed agree; another seed differs.  A
    prefill draws at step 10,000,000 + its request id and a decode step at
    its count, as the reference's."""
    _, cfg, _, params = weights
    kw = dict(greedy=False, temperature=0.8, top_k=40)
    first = _serve(cfg, params, seed=0, **kw)
    assert _serve(cfg, params, seed=0, **kw) == first
    assert _serve(cfg, params, seed=1, **kw) != first
    steps = []
    draw = engine.ServeEngine.sample_generator

    def recorded(self, step):
        steps.append(step)
        return draw(self, step)

    monkeypatch.setattr(engine.ServeEngine, "sample_generator", recorded)
    assert _serve(cfg, params, seed=0, **kw) == first
    prefills = [s for s in steps if s >= 10_000_000]
    decodes = [s for s in steps if s < 10_000_000]
    assert sorted(prefills) == [10_000_000 + i for i in range(6)]
    assert decodes == list(range(len(decodes))) and decodes


@pytest.mark.parametrize("top_k", [5, 40])
def test_sampled_tokens_lie_in_the_top_k(weights, top_k):
    """At the model level, a prefill's logits and 20 steps of draws from
    them: every token is one of the top k of its row."""
    _, cfg, _, params = weights
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        greedy=False, temperature=0.8, top_k=top_k, **CPU))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 12)))
    with torch.no_grad():
        logits, _ = engine.model_lib.prefill(params, cfg, tokens)
    top = torch.topk(logits, top_k, dim=-1).indices
    seen = set()
    for step in range(20):
        tok = eng._select(logits, step)
        assert (top == tok[:, None]).any(dim=1).all()
        seen.update(tok.tolist())
    assert len(seen) > 4            # it samples, it does not argmax


@pytest.mark.parametrize("top_k", [0, 4])
def test_frequencies_follow_the_softmax(weights, top_k):
    """50,000 draws (one step's batch of rows) at a 16-token vocabulary:
    each token's frequency lies within 5 standard errors of the softmax
    of the logits over the temperature, cut to the top k."""
    n, V, temp = 50_000, 16, 0.8
    row = torch.from_numpy(np.random.default_rng(4).standard_normal(V)
                           .astype(np.float32) * 2)
    _, cfg, _, params = weights
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        greedy=False, temperature=temp, top_k=top_k, seed=9, **CPU))
    tok = eng._select(row.expand(n, V), 3)
    freq = torch.bincount(tok, minlength=V).double() / n
    scaled = row.double() / temp
    if top_k:
        keep = torch.topk(scaled, top_k).indices
        cut = torch.full_like(scaled, -math.inf)
        cut[keep] = scaled[keep]
        scaled = cut
    p = torch.softmax(scaled, dim=0)
    se = torch.sqrt(p * (1 - p) / n)
    assert torch.all((freq - p).abs() <= 5 * se + 1e-12), (freq, p)


@pytest.mark.parametrize("obs", [
    [],                                              # no observations
    [(0.10, 1.0, 16.0)] * 3,                         # headroom: step up
    [(0.99, 4.0, 16.0)] * 8,                         # saturated: back off
    [(0.30, 15.0, 16.0)],                            # memory-bound
    [(0.05, 0.2, 16.0), (0.95, 0.2, 16.0)] * 5,      # a window of 8
])
@pytest.mark.parametrize("slots", [1, 3, 4, 8])
def test_overload_decision_matches_the_reference(weights, obs, slots):
    jcfg, cfg, jparams, params = weights
    jeng = jax_engine.ServeEngine(jcfg, jparams, jax_engine.EngineConfig(
        slots=slots, monitor=False))
    eng = engine.ServeEngine(cfg, params, engine.EngineConfig(
        slots=slots, **CPU))
    for duty, used, total in obs:
        jeng.controller.observe(jax_overload.DeviceObservation(
            duty, used, total))
        eng.controller.observe(overload.DeviceObservation(duty, used, total))
    want = jax_engine.overload_decision(jeng)
    got = engine.overload_decision(eng)
    assert isinstance(got, overload.OverloadDecision)
    assert (got.nppn, got.reason) == (want.nppn, want.reason)
