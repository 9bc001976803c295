"""The port's mixture of experts (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the CPU, with the same weights (the
reference's ``init_moe``, copied through numpy) and inputs: routing in both
``norm_topk_prob`` modes, capacity and grouping, ``moe_ffn`` without drops
(against the reference's ``moe_ffn`` and ``moe_ffn_dense_reference``) and
with drops, a three-row decode group, both activations, the auxiliary
losses, and the gradients of every leaf.

Tolerances: float32 rtol 2e-4 / atol 2e-5, the reference's own
(tests/test_moe.py); bfloat16 2e-2, the kernels' bf16 tolerance
(tests/test_kernels.py); gradients within 1e-4 of each leaf's largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import MoESpec as JaxMoESpec  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import MoESpec  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import leaf_dtype  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
BF16_TOL = 2e-2
D = 16


def _specs(E=8, k=2, f=32, cf=8.0, norm=True):
    kw = dict(n_experts=E, top_k=k, d_ff_expert=f, capacity_factor=cf,
              norm_topk_prob=norm)
    return MoESpec(**kw), JaxMoESpec(**kw)


def _params(spec, jspec, dtype=jnp.float32, seed=0):
    """The reference's ``init_moe`` weights, and the port's copy in the
    dtypes of ``moe_spec`` (the router float32)."""
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), D, jspec, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    leaves = moe.moe_spec(D, spec)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        leaf_dtype(leaves[k], None, tdt)) for k, v in jp.items()}
    return jp, tp


def _x(shape, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _dropped(tp, x, spec, n_groups=None):
    """How many token-expert assignments ``moe_ffn`` drops for x."""
    B, S, d = x.shape
    G = n_groups or moe._pick_groups(B, S)
    T = B * S // G
    logits = x.reshape(G, T, d).to(torch.float32) @ tp["router"]
    _, idx = moe._route(logits, spec)
    pos = moe._positions(idx.reshape(G, -1), spec.n_experts)
    return int((pos >= moe.capacity(T, spec)).sum())


def test_moe_spec_equals_init_moe():
    """Shapes, dtypes (the router float32 in a bf16 model) and stds of the
    reference's ``init_moe``."""
    spec, jspec = _specs()
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), D, jspec, jnp.bfloat16)
    leaves = moe.moe_spec(D, spec)
    assert list(leaves) == list(jp)
    for name, arr in jp.items():
        leaf = leaves[name]
        assert leaf.shape == arr.shape, name
        assert leaf.fp32 == (arr.dtype == jnp.float32), name
        a = np.asarray(arr, np.float32)
        # a normal truncated at two std, times the leaf's std
        assert float(np.abs(a).max()) <= 2 * leaf.std * 1.01, name
        assert 0.6 * leaf.std < float(a.std()) < 1.2 * leaf.std, name


@pytest.mark.parametrize("norm", [True, False])
def test_route_matches_jax(norm):
    spec, jspec = _specs(norm=norm)
    logits = _x((64, 8), seed=2)
    jw, jidx = jax_moe._route(jnp.asarray(logits), jspec)
    w, idx = moe._route(torch.from_numpy(logits), spec)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(w), np.asarray(jw), rtol=RTOL, atol=ATOL)
    if norm:
        np.testing.assert_allclose(_np(w.sum(-1)), 1.0, rtol=1e-5)


@pytest.mark.parametrize("S", [1, 16])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 8])
def test_capacity_and_groups_match_jax(B, S):
    spec, jspec = _specs(cf=1.25)
    G = moe._pick_groups(B, S)
    assert G == jax_moe._pick_groups(B, S)
    T = B * S // G
    assert moe.capacity(T, spec) == jax_moe.capacity(T, jspec)
    # decode groups whole rows: one token a group unless B is 3
    if S == 1:
        assert G == (1 if B == 3 else B)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("B,S", [(2, 16), (4, 1), (1, 64)])
def test_moe_ffn_without_drops_matches_jax(B, S, norm, act):
    """Capacity factor 8 (E / k * 2): nothing drops, so the port equals the
    reference's ``moe_ffn`` and both dense oracles."""
    spec, jspec = _specs(cf=8.0, norm=norm)
    jp, tp = _params(spec, jspec)
    x = _x((B, S, D))
    assert _dropped(tp, torch.from_numpy(x), spec) == 0
    got = moe.moe_ffn(tp, torch.from_numpy(x), spec, act)
    want = jax_moe.moe_ffn(jp, jnp.asarray(x), jspec, act)
    dense = jax_moe.moe_ffn_dense_reference(jp, jnp.asarray(x), jspec, act)
    mine_dense = moe.moe_ffn_dense_reference(tp, torch.from_numpy(x), spec,
                                             act)
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    for a, b in ((got, want), (got, dense), (mine_dense, dense)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("n_groups", [None, 1])
def test_moe_ffn_with_drops_matches_jax(act, n_groups):
    """Capacity factor 0.5: a quarter of the assignments can be kept at
    most, so tokens drop; the port drops the same ones as the reference
    (later tokens of a group first) and differs from the dense oracle."""
    spec, jspec = _specs(cf=0.5)
    jp, tp = _params(spec, jspec)
    x = _x((2, 32, D), seed=3)
    xt = torch.from_numpy(x)
    dropped = _dropped(tp, xt, spec, n_groups)
    assert dropped > 0
    got = moe.moe_ffn(tp, xt, spec, act, n_groups=n_groups)
    want = jax_moe.moe_ffn(jp, jnp.asarray(x), jspec, act, n_groups=n_groups)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    dense = moe.moe_ffn_dense_reference(tp, xt, spec, act)
    assert float((got - dense).abs().max()) > 1e-2
    print(f"{dropped} of {2 * 32 * spec.top_k} assignments dropped")


def test_decode_group_of_three_rows_competes_as_jax():
    """Three decode rows form one group of 3 tokens (capacity 1 at factor
    1.25): a later row loses an expert an earlier row took, so row 2's
    output depends on rows 0 and 1, as in the reference, while row 0's
    does not depend on the later rows."""
    spec, jspec = _specs(cf=1.25)
    jp, tp = _params(spec, jspec)
    x = _x((3, 1, D), seed=4)
    xt = torch.from_numpy(x)
    assert moe._pick_groups(3, 1) == 1 and moe.capacity(3, spec) == 1
    assert _dropped(tp, xt, spec) > 0
    got = moe.moe_ffn(tp, xt, spec)
    np.testing.assert_allclose(
        _np(got), np.asarray(jax_moe.moe_ffn(jp, jnp.asarray(x), jspec)),
        rtol=RTOL, atol=ATOL)
    alone = [moe.moe_ffn(tp, xt[i:i + 1], spec) for i in range(3)]
    assert torch.allclose(got[0], alone[0][0], rtol=RTOL, atol=ATOL)
    assert float((got[2] - alone[2][0]).abs().max()) > 1e-3


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_ffn_bfloat16_matches_jax(act, cf):
    """bf16 tokens and experts, the router float32 on both sides: within
    2e-2, with and without drops."""
    spec, jspec = _specs(cf=cf)
    jp, tp = _params(spec, jspec, jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["w1"].dtype == torch.bfloat16
    x = _x((2, 32, D), seed=5)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(torch.bfloat16)
    got = moe.moe_ffn(tp, xt, spec, act)
    want = jax_moe.moe_ffn(jp, xj, jspec, act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("norm", [True, False])
def test_aux_losses_match_jax(norm):
    spec, jspec = _specs(norm=norm)
    jp, tp = _params(spec, jspec)
    x = _x((2, 16, D), seed=6)
    jlb, jz = jax_moe.moe_aux_losses(jp, jnp.asarray(x), jspec)
    lb, z = moe.moe_aux_losses(tp, torch.from_numpy(x), spec)
    assert lb.dtype == z.dtype == torch.float32
    np.testing.assert_allclose(float(lb), float(jlb), rtol=1e-5)
    np.testing.assert_allclose(float(z), float(jz), rtol=1e-5)


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_gradients_match_jax(act, cf):
    """d sum(moe_ffn(x)^2) with respect to x and every leaf (router, w1,
    w3, w2) against ``jax.grad``, with and without drops: each within 1e-4
    of its largest gradient.  A dropped assignment has no gradient."""
    spec, jspec = _specs(cf=cf)
    jp, tp = _params(spec, jspec)
    x = _x((2, 16, D), seed=7)

    def jloss(p, xs):
        return jnp.sum(jax_moe.moe_ffn(p, xs, jspec, act) ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    (moe.moe_ffn(tp, xt, spec, act) ** 2).sum().backward()
    if act == "gelu":       # w3 is not read: no gradient, jax's is zero
        assert tp["w3"].grad is None and not np.any(np.asarray(jg["w3"]))
    pairs = [(name, tp[name].grad, jg[name]) for name in jp
             if tp[name].grad is not None]
    pairs.append(("x", xt.grad, jgx))
    for name, g, want in pairs:
        want = np.asarray(want)
        peak = float(np.abs(want).max())
        err = float(np.abs(_np(g) - want).max())
        print(f"{name}: max |jax grad| {peak:.3e}, max |grad - jax| {err:.3e}")
        assert peak > 0 and err <= 1e-4 * peak, (name, err, peak)


def test_router_stays_float32_in_serving_and_is_cast_in_training():
    """Reduced granite in bf16: the bridge and ``init_params`` keep the
    router float32 and everything else of the MoE bf16, as the reference's
    ``init_params``; training's ``cast_params`` casts the stacked router
    [1, d, E] to bf16 on both sides."""
    from repro.configs import reduced_config as jax_reduced
    from repro.models import init_params as jax_init
    from repro.train import train_step as jax_ts
    from repro_torch.bridge import from_jax_params
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as model_lib
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(reduced_config("granite-moe-1b-a400m"),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jax_reduced("granite-moe-1b-a400m"),
                               dtype="bfloat16")
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    bridged = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    drawn = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    for tree in (bridged, drawn):
        mlp = tree["blocks"]["0"]["mlp"]
        for name, arr in jparams["blocks"]["0"]["mlp"].items():
            want = torch.float32 if arr.dtype == jnp.float32 \
                else torch.bfloat16
            assert mlp[name].dtype == want, name
        assert mlp["router"].dtype == torch.float32
        assert mlp["w1"].dtype == torch.bfloat16
    masters = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                              dtype=torch.float32)
    cast = ts.cast_params(masters, "bfloat16")["blocks"]["0"]["mlp"]
    jcast = jax_ts.cast_params(jparams, "bfloat16")["blocks"]["0"]["mlp"]
    assert cast["router"].dtype == torch.bfloat16
    assert jcast["router"].dtype == jnp.bfloat16
