"""The port's kernel layer on the CPU: the plain versions against the JAX
package's Pallas kernels (interpret mode) and oracles, the CPU routing of
``kernels.ops`` and its differentiable card routes (with stand-ins for the
wrappers), the wrappers' refusals, and the nvcc build recipe.

Tolerances are the reference's own (tests/test_kernels.py): 2e-5 in
float32, 2e-2 in bfloat16 for the norms and attention; 2e-4 for the SSD
intra-chunk block (float32), whose sums run in another order.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import gated_rmsnorm as jax_gated  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.ssd import ssd_intra_chunk as jax_ssd  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels import _build, _guard, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.models import layers  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, name, scale=1.0, shift=0.0):
    """The same values as a torch and a jax array in dtype ``name``."""
    a = (rng.standard_normal(shape, dtype=np.float32) * scale + shift)
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


# The sweep of tests/test_kernels.py, then llsc-100m's prefill shapes.
FLASH_CASES = [
    (1, 2, 1, 128, 64, 64, 64, True),
    (2, 4, 2, 128, 32, 32, 64, True),
    (1, 4, 4, 256, 64, 128, 128, True),
    (2, 8, 2, 64, 128, 64, 64, True),
    (1, 2, 2, 128, 32, 64, 64, False),
    (1, 12, 12, 128, 64, 128, 128, True),
    (1, 12, 12, 256, 64, 128, 128, True),
]


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,S,D,bq,bk,causal", FLASH_CASES)
def test_attention_plain_matches_pallas_kernel(B, H, Hk, S, D, bq, bk, causal,
                                               name):
    rng = np.random.default_rng(S + D + H)
    tq, jq = _pair(rng, (B, H, S, D), name)
    tk, jk = _pair(rng, (B, Hk, S, D), name)
    tv, jv = _pair(rng, (B, Hk, S, D), name)
    mine = ops.flash_attention(tq, tk, tv, causal=causal)
    kern = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                     interpret=True)
    oracle = jax_ref.attention_ref(jq, jk, jv, causal=causal)
    assert mine.dtype == DTYPES[name][0] and mine.shape == (B, H, S, D)
    np.testing.assert_allclose(_np(mine), _np(kern), **_tol(name))
    np.testing.assert_allclose(_np(mine), _np(oracle), **_tol(name))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_attention_bshd_matches_jax_adapter(name):
    rng = np.random.default_rng(7)
    tq, jq = _pair(rng, (2, 128, 4, 32), name)
    tk, jk = _pair(rng, (2, 128, 2, 32), name)
    tv, jv = _pair(rng, (2, 128, 2, 32), name)
    mine = ops.flash_attention_bshd(tq, tk, tv, causal=True)
    theirs = jax_ops.flash_attention_bshd(jq, jk, jv, causal=True,
                                          block_q=64, block_k=64)
    np.testing.assert_allclose(_np(mine), _np(theirs), **_tol(name))


# The sweep of tests/test_kernels.py, then a decode step's and a prefill's
# rows of llsc-100m.
RMS_CASES = [(32, 128), (33, 256), (7, 64), (4, 768), (256, 768)]


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", RMS_CASES)
def test_rmsnorm_plain_matches_pallas_kernel(rows, d, name):
    rng = np.random.default_rng(rows * d)
    tx, jx = _pair(rng, (rows, d), name)
    ts, js = _pair(rng, (d,), name, scale=0.1, shift=1.0)
    mine = ops.rmsnorm(tx, ts)
    kern = jax_rmsnorm(jx, js, interpret=True)
    oracle = jax_ref.rmsnorm_ref(jx, js)
    assert mine.dtype == DTYPES[name][0]
    np.testing.assert_allclose(_np(mine), _np(kern), **_tol(name))
    np.testing.assert_allclose(_np(mine), _np(oracle), **_tol(name))


# The reference's shape (tests/test_kernels.py), then mamba2-370m's decode
# step (4 slots) and a 320-token prefill.
GATED_CASES = [(4, 16, 128), (4, 1, 2048), (1, 320, 2048)]


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GATED_CASES)
def test_gated_rmsnorm_plain_matches_pallas_kernel(shape, name):
    rng = np.random.default_rng(sum(shape))
    ty, jy = _pair(rng, shape, name)
    tz, jz = _pair(rng, shape, name)
    ts, js = _pair(rng, shape[-1:], name, scale=0.1, shift=1.0)
    mine = ops.gated_rmsnorm(ty, tz, ts)
    kern = jax_gated(jy, jz, js, interpret=True)
    oracle = jax_ref.gated_rmsnorm_ref(jy, jz, js)
    assert mine.dtype == DTYPES[name][0] and mine.shape == shape
    np.testing.assert_allclose(_np(mine), _np(kern), **_tol(name))
    np.testing.assert_allclose(_np(mine), _np(oracle), **_tol(name))


def test_gated_rmsnorm_takes_a_strided_gate():
    """The model's gate is a slice of the projection: the plain version
    reads it as it is, with the same result as a contiguous copy."""
    proj = torch.randn(2, 5, 3 * 64)
    y = torch.randn(2, 5, 64)
    z = proj[..., 64:128]
    s = torch.rand(64) + 0.5
    assert not z.is_contiguous()
    torch.testing.assert_close(ops.gated_rmsnorm(y, z, s),
                               ops.gated_rmsnorm(y, z.contiguous(), s),
                               rtol=0, atol=0)


def _ssd_data(b, l, h, p, g, n, seed=0):
    """numpy x, dt, A, B, C drawn as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h), dtype=np.float32)))
    A = -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.3)
    B = rng.standard_normal((b, l, g, n), dtype=np.float32)
    C = rng.standard_normal((b, l, g, n), dtype=np.float32)
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


# The sweep of tests/test_kernels.py:76-80.
SSD_CASES = [(1, 32, 4, 16, 1, 8), (2, 64, 8, 32, 2, 16), (1, 16, 2, 8, 2, 4)]


@pytest.mark.parametrize("b,l,h,p,g,n", SSD_CASES)
def test_ssd_plain_matches_pallas_kernel(b, l, h, p, g, n):
    data = _ssd_data(b, l, h, p, g, n)
    mine = ops.ssd_intra_chunk(*[torch.from_numpy(a) for a in data])
    kern = jax_ssd(*[jnp.asarray(a) for a in data], interpret=True)
    oracle = jax_ref.ssd_intra_chunk_ref(*[jnp.asarray(a) for a in data])
    assert mine.dtype == torch.float32 and mine.shape == (b, l, h, p)
    np.testing.assert_allclose(_np(mine), _np(kern), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(mine), _np(oracle), rtol=2e-4, atol=2e-4)


def test_ssd_plain_matches_model_path():
    """The plain y_diag equals the chunked model path with one chunk (the
    whole sequence), where the output is the intra-chunk term alone: the
    counterpart of test_ssd_kernel_matches_model_path."""
    data = _ssd_data(1, 32, 4, 16, 1, 8, seed=1)
    mine = ops.ssd_intra_chunk(*[torch.from_numpy(a) for a in data])
    y_model, _ = jax_ssm.ssd_chunked(*[jnp.asarray(a) for a in data], chunk=32)
    np.testing.assert_allclose(_np(mine), _np(y_model), rtol=2e-4, atol=2e-4)


def test_ssd_plain_output_dtype_and_masking():
    """x's dtype by default, float32 on request; rows above the diagonal,
    where exp(cs_i - cs_j) overflows, are selected away (no NaN)."""
    x, dt, A, B, C = [torch.from_numpy(a) for a in
                      _ssd_data(1, 64, 2, 8, 1, 4, seed=2)]
    dt = dt * 50                     # cs spans thousands: exp(+) is inf
    y = ops.ssd_intra_chunk(x, dt, A * 10, B, C)
    assert torch.isfinite(y).all()
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, B, C))
    assert ops.ssd_intra_chunk(xb, dt, A, Bb, Cb).dtype == torch.bfloat16
    y32 = ops.ssd_intra_chunk(xb, dt, A, Bb, Cb, out_dtype=torch.float32)
    assert y32.dtype == torch.float32


SSD_TOL = 2e-4


def _ssd_tensor_core_emulation(terms):
    """The bf16 body of csrc/ssd.cu in plain torch at mamba2-370m's full
    width (2 chunks of 256, 32 heads of 64, one group, state 128; bf16 x,
    B, C as chip_smoke draws them): C.B from bf16 with fp32 sums, dt folded
    into W' = (C.B) exp(cs_i - cs_j) dt_j in fp32, W' split into ``terms``
    bf16 terms (each the rounding of what the terms before it left), each
    term's product with the bf16 x summed in fp32.  Returns the worst
    |emulation - ssd_intra_chunk_ref| / (tol + tol |want|)."""
    N, l, h, p, g, n = 2, 256, 32, 64, 1, 128
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((N, l, h, p), dtype=np.float32))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((N, l, h), dtype=np.float32)))
    A = -torch.exp(torch.from_numpy(
        rng.standard_normal(h, dtype=np.float32)) * 0.3)
    B, C = (torch.from_numpy(rng.standard_normal((N, l, g, n),
                                                 dtype=np.float32))
            for _ in range(2))
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    want = ref.ssd_intra_chunk_ref(x, dt, A, B, C, out_dtype=torch.float32)

    cb = torch.einsum("cign,cjgn->cgij", C.float(), B.float())  # [N,g,i,j]
    cs = ref.cumsum_f32((dt * A).transpose(1, 2), -1)            # [N,h,l]
    idx = torch.arange(l)
    keep = idx[:, None] >= idx[None, :]
    decay = torch.where(keep, cs[..., :, None] - cs[..., None, :],
                        torch.full((), -float("inf")))
    w = (cb.repeat_interleave(h // g, dim=1) * torch.exp(decay)
         * dt.transpose(1, 2)[:, :, None, :])                    # [N,h,i,j]
    y = torch.zeros(N, h, l, p)
    rest = w
    for _ in range(terms):
        term = rest.to(torch.bfloat16).float()
        rest = rest - term
        y += term @ x.float().transpose(1, 2)                    # [N,h,l,p]
    got = y.transpose(1, 2)
    err = (got - want).abs() / (SSD_TOL + SSD_TOL * want.abs())
    return float(err.max())


def test_cumsum_f32_sums_left_to_right_in_float32():
    """The plain version's cumsum takes the order of the SSD kernel's scan
    (csrc/ssd.cu::chunk_cumsum): left to right, each sum rounded to
    float32, bit for bit (PyTorch's CPU cumsum would accumulate in double).
    Its gradient is the reversed cumsum."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 256, 4), dtype=np.float32) * 0.7)
    acc, want = torch.zeros(3, 4), []
    for t in range(256):
        acc = acc + x[:, t]
        want.append(acc)
    assert torch.equal(ref.cumsum_f32(x, 1), torch.stack(want, 1))
    assert not torch.equal(torch.cumsum(x, 1), torch.stack(want, 1))
    xg = x.clone().requires_grad_()
    ref.cumsum_f32(xg, -2).sum().backward()
    rev = torch.arange(256, 0, -1, dtype=torch.float32)[None, :, None]
    assert torch.equal(xg.grad, rev.expand(3, 256, 4))


def test_ssd_tensor_core_arithmetic_meets_ssd_tol():
    """Three bf16 terms of W' keep the bf16 body within the SSD tolerance
    of the plain version, with room to spare."""
    worst = _ssd_tensor_core_emulation(3)
    assert worst <= 0.1, f"worst error / tolerance {worst:.3f}"


@pytest.mark.parametrize("terms", [1, 2])
def test_ssd_tensor_core_arithmetic_needs_three_terms(terms):
    """A single bf16 rounding of W' misses the SSD tolerance by far; two
    terms come too close to it to keep."""
    worst = _ssd_tensor_core_emulation(terms)
    assert worst > (1.0 if terms == 1 else 0.25), \
        f"{terms} terms: worst error / tolerance {worst:.3f}"


# bf16 activations with a float32 scale: the 1-D scale the reference's
# cast_params leaves in float32, applied in fp32 (repro/models/layers.py:34,
# repro/models/ssm.py:181).
@pytest.mark.parametrize("shape", [(4, 768), (2, 5, 64), (320, 2048)])
def test_norms_with_bf16_input_and_a_float32_scale_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    tx, jx = _pair(rng, shape, "bfloat16", scale=3.0)
    tz, jz = _pair(rng, shape, "bfloat16")
    ts, js = _pair(rng, shape[-1:], "float32", scale=0.1, shift=1.0)
    mine = ops.rmsnorm(tx, ts)
    theirs = jax_layers.rmsnorm({"scale": js}, jx, 1e-5)
    assert mine.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(mine), _np(theirs), **_tol("bfloat16"))
    mine = ops.gated_rmsnorm(tx, tz, ts)
    theirs = jax_ssm._gated_norm(js, jx, jz, 1e-5)
    assert mine.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(mine), _np(theirs), **_tol("bfloat16"))


def test_norm_wrappers_refuse_other_mixed_dtypes(monkeypatch):
    """The kernels take the scale in the input's dtype, or float32 with
    bfloat16 input; any other pair raises before anything is built."""
    def no_build(*_a, **_k):
        raise AssertionError("a refused call must not build or launch")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    x = torch.randn(4, 64)
    bf16_scale = torch.ones(64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        rn.rmsnorm(x, bf16_scale)
    with pytest.raises(ValueError, match="dtype"):
        rn.gated_rmsnorm(x, x, bf16_scale)
    with pytest.raises(ValueError, match="dtype"):
        rn.gated_rmsnorm(x.to(torch.bfloat16), x, torch.ones(64))
    with pytest.raises(ValueError, match="dtype"):
        rn.rmsnorm(x.to(torch.float16), torch.ones(64))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 64), (4, 1, 768)])
def test_layers_rmsnorm_matches_jax_layers(shape, name):
    rng = np.random.default_rng(3)
    tx, jx = _pair(rng, shape, name, scale=3.0)
    ts, js = _pair(rng, shape[-1:], name, scale=0.1, shift=1.0)
    mine = layers.rmsnorm({"scale": ts}, tx, 1e-5)
    theirs = jax_layers.rmsnorm({"scale": js}, jx, 1e-5)
    np.testing.assert_allclose(_np(mine), _np(theirs), **_tol(name))


@pytest.mark.parametrize("positions", ["shared", "per_row"])
def test_rope_matches_jax(positions):
    rng = np.random.default_rng(5)
    tx, jx = _pair(rng, (2, 6, 4, 16), "float32")
    if positions == "shared":
        pos = np.arange(6)
    else:
        pos = np.stack([np.arange(6) + 3, np.arange(6) + 40])
    mine = layers.apply_rope_bshd(tx, torch.from_numpy(pos), 10_000.0)
    theirs = jax_layers.apply_rope_bshd(jx, jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(_np(mine), _np(theirs), rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_route_and_launch_nothing(monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("a CPU tensor must not build or launch a kernel")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = (fa.launches, rn.launches)
    q = torch.randn(1, 2, 64, 32)
    ops.flash_attention(q, q, q)
    ops.flash_attention_bshd(q, q, q)
    ops.rmsnorm(q, torch.ones(32))
    assert (fa.launches, rn.launches) == before


def test_cpu_tensors_take_the_plain_route_for_the_mamba_kernels(
        monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("a CPU tensor must not build or launch a kernel")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = (rn.gated_launches, ssd.launches)
    y = torch.randn(3, 16)
    ops.gated_rmsnorm(y, y, torch.ones(16))
    x, dt, A, B, C = [torch.from_numpy(a) for a in
                      _ssd_data(1, 16, 2, 8, 2, 4)]
    ops.ssd_intra_chunk(x, dt, A, B, C)
    assert (rn.gated_launches, ssd.launches) == before


def test_mamba_wrappers_refuse_cpu_tensors():
    y = torch.randn(3, 16)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        rn.gated_rmsnorm(y, y, torch.ones(16))
    x, dt, A, B, C = [torch.from_numpy(a) for a in
                      _ssd_data(1, 16, 2, 8, 2, 4)]
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        ssd.ssd_intra_chunk(x, dt, A, B, C)


def test_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 2, 64, 32)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fa.flash_attention_bshd(q, q, q)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        rn.rmsnorm(q, torch.ones(32))


def test_build_recipe(monkeypatch, tmp_path):
    nvcc = str(tmp_path / "bin" / "nvcc")
    cmd = _build.nvcc_command("rmsnorm", nvcc, tmp_path / "lib.so")
    assert cmd[0] == nvcc and cmd[-1].endswith("csrc/rmsnorm.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    paths = {n: _build.library_path(n, nvcc) for n in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for n, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{n}-")
        assert (_build.CSRC / f"{n}.cu").exists()
    assert _build.library_path("rmsnorm", nvcc) == paths["rmsnorm"]
    other = str(tmp_path / "other" / "nvcc")
    assert _build.library_path("rmsnorm", other) != paths["rmsnorm"]
    # An edited header rebuilds the libraries of the sources that include
    # it, and only those.
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert {n: _build.library_path(n, nvcc) for n in _build.SOURCES} == paths
    for n in _build.SOURCES:
        assert '#include "mma.cuh"' in (csrc / f"{n}.cu").read_text()
    (csrc / "mma.cuh").write_text((csrc / "mma.cuh").read_text() + "\n")
    edited = {n: _build.library_path(n, nvcc) for n in _build.SOURCES}
    for n in _build.SOURCES:
        assert edited[n] != paths[n]
    (csrc / "extra.cuh").write_text("#pragma once\n")
    (csrc / "rmsnorm.cu").write_text('#include "extra.cuh"\n'
                                     + (csrc / "rmsnorm.cu").read_text())
    with_extra = {n: _build.library_path(n, nvcc) for n in _build.SOURCES}
    (csrc / "extra.cuh").write_text("#pragma once\n// edited\n")
    for n in _build.SOURCES:
        assert (_build.library_path(n, nvcc) != with_extra[n]) == \
            (n == "rmsnorm")


WRAPPERS = {"flash_attention": fa.flash_attention,
            "flash_attention_bshd": fa.flash_attention_bshd,
            "rmsnorm": rn.rmsnorm, "gated_rmsnorm": rn.gated_rmsnorm,
            "ssd_intra_chunk": ssd.ssd_intra_chunk}


def _grad_inputs(name):
    """CPU inputs of the kernel entry point ``name``; the second one
    requires grad."""
    q = torch.randn(1, 2, 64, 32)
    if name.startswith("flash"):
        return [q, q.clone().requires_grad_(), q]
    if name == "rmsnorm":
        return [q, torch.ones(32, requires_grad=True)]
    if name == "gated_rmsnorm":
        y = torch.randn(3, 16)
        return [y, y.clone().requires_grad_(), torch.ones(16)]
    x, dt, A, B, C = [torch.from_numpy(a) for a in
                      _ssd_data(1, 16, 2, 8, 2, 4)]
    return [x, dt.requires_grad_(), A, B, C]


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrappers_refuse_autograd(name, monkeypatch):
    """The kernels have no backward: with grad enabled, an input that
    requires grad raises before anything is built or launched.  Under
    no_grad the same call reaches the device check."""
    def no_build(*_a, **_k):
        raise AssertionError("a refused call must not build or launch")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    args = _grad_inputs(name)
    before = (fa.launches, rn.launches, rn.gated_launches, ssd.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        WRAPPERS[name](*args)
    with torch.no_grad():
        with pytest.raises(ValueError, match="not a CUDA tensor"):
            WRAPPERS[name](*args)
    assert (fa.launches, rn.launches, rn.gated_launches,
            ssd.launches) == before


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_routes_stay_differentiable(name):
    """On CPU tensors ``kernels.ops`` takes the plain versions, whose
    outputs carry a gradient back to the input that requires it."""
    args = _grad_inputs(name)
    out = getattr(ops, name)(*args)
    assert out.requires_grad
    out.float().square().sum().backward()
    g = args[1].grad
    assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0


ROUTES = {"flash_attention": ("FlashAttention", fa, "flash_attention",
                               ref.attention_ref),
          "flash_attention_bshd": ("FlashAttentionBSHD", fa,
                                   "flash_attention_bshd",
                                   ops._attention_bshd_ref),
          "rmsnorm": ("RMSNorm", rn, "rmsnorm", ref.rmsnorm_ref),
          "gated_rmsnorm": ("GatedRMSNorm", rn, "gated_rmsnorm",
                            ref.gated_rmsnorm_ref),
          "ssd_intra_chunk": ("SSDIntraChunk", ssd, "ssd_intra_chunk",
                              ref.ssd_intra_chunk_ref)}


def _route_inputs(name, dtype):
    """Inputs of the entry point ``name`` in ``dtype`` (dt and A float32,
    and the norms' scale float32 with bfloat16 input, as training gives
    them), every one requiring grad, and its keyword arguments."""
    rng = np.random.default_rng(11)

    def t(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dt).requires_grad_()

    if name == "flash_attention":
        return [t(1, 4, 64, 32), t(1, 2, 64, 32), t(1, 2, 64, 32)], {}
    if name == "flash_attention_bshd":
        return [t(1, 64, 4, 32), t(1, 64, 2, 32), t(1, 64, 2, 32)], {}
    if name == "rmsnorm":
        return [t(2, 5, 64), t(64, dt=torch.float32)], {"eps": 1e-5}
    if name == "gated_rmsnorm":
        return [t(3, 64), t(3, 64), t(64, dt=torch.float32)], {"eps": 1e-5}
    x, dt, A, B, C = [torch.from_numpy(a) for a in _ssd_data(2, 16, 4, 8, 2, 8)]
    return ([x.to(dtype).requires_grad_(), dt.requires_grad_(),
             A.requires_grad_(), B.to(dtype).requires_grad_(),
             C.to(dtype).requires_grad_()], {"out_dtype": torch.float32})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_kernel_routes_differentiate_through_the_plain_version(
        name, dtype, monkeypatch):
    """On the card an entry point whose input requires grad goes through
    its ``autograd.Function``: forward the wrapper (here standing in: the
    wrapper's own autograd guard, then the plain version), backward the
    vector-Jacobian product of the plain version.  Its gradients equal the
    plain route's, each in its input's dtype, with one launch a call; with
    no input requiring grad the Function is not entered."""
    fn_name, module, attr, plain = ROUTES[name]
    launches = []

    def stand_in(*args, **kw):
        _guard.refuse_autograd(attr, *args)
        launches.append(attr)
        return plain(*args, **kw)

    monkeypatch.setattr(module, attr, stand_in)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    inputs, kw = _route_inputs(name, dtype)
    out = getattr(ops, name)(*inputs, **kw)
    assert launches == [attr] and type(out.grad_fn).__name__ == \
        f"{fn_name}Backward"
    (0.5 * out.float().square().sum()).backward()
    got = [x.grad for x in inputs]
    twins = [x.detach().clone().requires_grad_() for x in inputs]
    (0.5 * plain(*twins, **kw).float().square().sum()).backward()
    for g, x, twin in zip(got, inputs, twins):
        assert g is not None and g.dtype == x.dtype
        assert torch.equal(g, twin.grad)
    # no input requiring grad, or grad disabled: the wrapper, no Function
    def no_function(*_a, **_k):
        raise AssertionError("the serve path must not enter the Function")

    monkeypatch.setattr(getattr(ops, fn_name), "apply", no_function)
    launches.clear()
    detached = [x.detach() for x in inputs]
    assert getattr(ops, name)(*detached, **kw).grad_fn is None
    with torch.no_grad():
        getattr(ops, name)(*inputs, **kw)
    assert launches == [attr, attr]


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda *_a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("rmsnorm")


def test_build_raises_when_nvcc_fails(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc failed for rmsnorm"):
        _build.build("rmsnorm")
    out = _build.library_path("rmsnorm", str(nvcc))
    assert not out.exists()
    assert "no sm_90a here" in out.with_suffix(".log").read_text()


def test_plain_attention_masks_like_the_reference():
    """Causal rows see only keys at or before their position."""
    q = torch.zeros(1, 1, 4, 32)
    v = torch.arange(4, dtype=torch.float32)[None, None, :, None].expand(
        1, 1, 4, 32)
    out = ref.attention_ref(q, q, v, causal=True)
    # uniform weights over keys 0..i -> mean of 0..i
    assert torch.allclose(out[0, 0, :, 0], torch.tensor([0.0, 0.5, 1.0, 1.5]))
