"""The port's Mamba-2 module (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU, float32, the counterparts of
tests/test_ssm.py.  Inputs come from numpy seeds and go to both sides.

Tolerance 2e-4, the reference's own for the chunked SSD (tests/test_ssm.py,
tests/test_kernels.py:90): the chunked form sums in another order than the
sequential one.  The conv is 1e-5, as tests/test_ssm.py holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _data(b=2, s=32, h=4, p=8, g=2, n=4, seed=0):
    """numpy x, dt (softplus of a normal), A (<0), B, C, as tests/test_ssm.py
    draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    A = -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.5)
    B = rng.standard_normal((b, s, g, n), dtype=np.float32)
    C = rng.standard_normal((b, s, g, n), dtype=np.float32)
    return x, dt.astype(np.float32), A.astype(np.float32), B, C


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(mine, theirs, **tol):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(theirs),
                               **(tol or TOL))


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_chunked_matches_sequential_and_jax(chunk):
    data = _data()
    y_c, st_c = ssm.ssd_chunked(*_t(data), chunk=chunk)
    y_r, st_r = ssm.ssd_reference(*_t(data))
    jy, jst = jax_ssm.ssd_chunked(*_j(data), chunk=chunk)
    _close(y_c, y_r.numpy())
    _close(st_c, st_r.numpy())
    _close(y_c, jy)
    _close(st_c, jst)


def test_sequential_reference_matches_jax():
    data = _data(s=12)
    y, st = ssm.ssd_reference(*_t(data))
    jy, jst = jax_ssm.ssd_reference(*_j(data))
    _close(y, jy)
    _close(st, jst)


def test_padding_path():
    """s not a multiple of the chunk takes the pad branch."""
    data = _data(s=21)
    y_c, st_c = ssm.ssd_chunked(*_t(data), chunk=8)
    y_r, st_r = ssm.ssd_reference(*_t(data))
    jy, _ = jax_ssm.ssd_chunked(*_j(data), chunk=8)
    assert y_c.shape == (2, 21, 4, 8)
    _close(y_c, y_r.numpy())
    _close(st_c, st_r.numpy())
    _close(y_c, jy)


def test_initial_state_continuation():
    """SSD over [0:s1] then [s1:] with the carried state == the full
    sequence, and equal to JAX's continuation."""
    x, dt, A, B, C = _t(_data(s=32))
    s1 = 16
    y_a, state = ssm.ssd_chunked(x[:, :s1], dt[:, :s1], A, B[:, :s1],
                                 C[:, :s1], chunk=8)
    y_b, _ = ssm.ssd_chunked(x[:, s1:], dt[:, s1:], A, B[:, s1:], C[:, s1:],
                             chunk=8, initial_state=state)
    y_full, _ = ssm.ssd_chunked(x, dt, A, B, C, chunk=8)
    _close(torch.cat([y_a, y_b], 1), y_full.numpy())
    jx, jdt, jA, jB, jC = _j(_data(s=32))
    _, jstate = jax_ssm.ssd_chunked(jx[:, :s1], jdt[:, :s1], jA, jB[:, :s1],
                                    jC[:, :s1], chunk=8)
    jy_b, _ = jax_ssm.ssd_chunked(jx[:, s1:], jdt[:, s1:], jA, jB[:, s1:],
                                  jC[:, s1:], chunk=8, initial_state=jstate)
    _close(y_b, jy_b)


def test_decode_step_matches_chunked_tail():
    x, dt, A, B, C = _t(_data(s=16))
    y_full, st_full = ssm.ssd_chunked(x, dt, A, B, C, chunk=8)
    _, st_prefix = ssm.ssd_chunked(x[:, :-1], dt[:, :-1], A, B[:, :-1],
                                   C[:, :-1], chunk=8)
    y_t, st_t = ssm.ssd_decode_step(st_prefix, x[:, -1], dt[:, -1], A,
                                    B[:, -1], C[:, -1])
    _close(y_t, y_full[:, -1].numpy())
    _close(st_t, st_full.numpy())
    jx, jdt, jA, jB, jC = _j(_data(s=16))
    jy_t, jst_t = jax_ssm.ssd_decode_step(jnp.asarray(st_prefix.numpy()),
                                          jx[:, -1], jdt[:, -1], jA,
                                          jB[:, -1], jC[:, -1])
    _close(y_t, jy_t)
    _close(st_t, jst_t)


def test_conv_decode_matches_full_and_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 6), dtype=np.float32)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    b = rng.standard_normal(6, dtype=np.float32)
    full = ssm.causal_conv(*_t((x, w, b)))
    _close(full, jax_ssm.causal_conv(*_j((x, w, b))), rtol=1e-5, atol=1e-5)
    state = torch.zeros(2, 3, 6)
    outs = []
    for t in range(10):
        y, state = ssm.conv_decode_step(state, torch.from_numpy(x[:, t]),
                                        *_t((w, b)))
        outs.append(y)
    _close(torch.stack(outs, 1), full.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L", [1, 5, 16])
def test_segsum_matches_jax(L):
    x = np.random.default_rng(L).standard_normal((3, L)).astype(np.float32)
    mine = ref.segsum(torch.from_numpy(x))
    theirs = np.asarray(jax_ssm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isinf(mine.numpy()), np.isinf(theirs))
    fin = np.isfinite(theirs)
    np.testing.assert_allclose(mine.numpy()[fin], theirs[fin], rtol=1e-5,
                               atol=1e-5)
    assert torch.exp(mine).isfinite().all()      # -inf -> 0, never NaN


# --------------------------------------------------------------------------
# The mixer on reduced mamba2 (fp32), with bridged weights
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixer():
    import jax

    jcfg = jax_reduced("mamba2-370m")
    cfg = reduced_config("mamba2-370m")
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["0"]["mixer"])
    tp = {k: v[0] for k, v in params["blocks"]["0"]["mixer"].items()}
    # perturb the deterministic leaves so that they matter in the test
    rng = np.random.default_rng(6)
    for name in ("conv_b", "D", "dt_bias", "norm"):
        noise = rng.standard_normal(tp[name].shape).astype(np.float32) * 0.1
        tp[name] = tp[name] + torch.from_numpy(noise)
        jp[name] = jp[name] + jnp.asarray(noise)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("S", [2, 10, 40])
def test_mamba2_forward_matches_jax(mixer, S):
    """S=2 is shorter than the conv (left-padded tail), 40 spans three
    chunks of 16."""
    jcfg, cfg, jp, tp = mixer
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model),
                                                 dtype=np.float32)
    y, (tail, state) = ssm.mamba2_forward(tp, torch.from_numpy(x), cfg)
    jy, (jtail, jstate) = jax_ssm.mamba2_forward(jp, jnp.asarray(x), jcfg)
    assert y.shape == (2, S, cfg.d_model) and tail.shape == jtail.shape
    _close(y, jy)
    _close(tail, jtail)
    _close(state, jstate)


def test_mamba2_decode_matches_jax_and_updates_views_in_place(mixer):
    jcfg, cfg, jp, tp = mixer
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32)
    _, (tail, state) = ssm.mamba2_forward(tp, torch.from_numpy(x[:, :8]), cfg)
    jy_full, _ = jax_ssm.mamba2_forward(jp, jnp.asarray(x), jcfg)
    # the cache as the engine holds it: views into a larger tensor
    conv_buf = torch.zeros((3,) + tuple(tail.shape))
    ssd_buf = torch.zeros((3,) + tuple(state.shape))
    conv_buf[1].copy_(tail)
    ssd_buf[1].copy_(state)
    y, conv_v, ssd_v = ssm.mamba2_decode(tp, torch.from_numpy(x[:, 8:9]), cfg,
                                         conv_buf[1], ssd_buf[1])
    jy, jconv, jssd = jax_ssm.mamba2_decode(
        jp, jnp.asarray(x[:, 8:9]), jcfg, jnp.asarray(tail.numpy()),
        jnp.asarray(state.numpy()))
    _close(y, jy)
    _close(y[:, 0], jy_full[:, -1])          # decode == the next position
    _close(conv_buf[1], jconv)
    _close(ssd_buf[1], jssd)
    assert conv_v.data_ptr() == conv_buf[1].data_ptr()
    assert ssd_v.data_ptr() == ssd_buf[1].data_ptr()
    assert not conv_buf[0].any() and not ssd_buf[2].any()
