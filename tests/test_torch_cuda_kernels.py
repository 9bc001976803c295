"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``: they skip where CUDA is absent.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances are the reference's (tests/test_kernels.py): 2e-5 in float32,
2e-2 in bfloat16.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _close(got, want, dtype):
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hk,S,T,D,causal", [
    (1, 2, 1, 128, 128, 64, True), (2, 4, 2, 128, 128, 32, True),
    (1, 4, 4, 256, 256, 64, True), (2, 8, 2, 64, 64, 128, True),
    (1, 2, 2, 128, 128, 32, False), (1, 12, 12, 128, 128, 64, True),
    (1, 12, 12, 256, 256, 64, True), (2, 4, 2, 100, 100, 64, True),
    (1, 4, 1, 33, 70, 32, False)])
def test_flash_kernel_matches_plain(dev, B, H, Hk, S, T, D, causal, dtype):
    g = torch.Generator(device=dev).manual_seed(S * D + H)
    q = torch.randn(B, H, S, D, device=dev, generator=g).to(dtype)
    k = torch.randn(B, Hk, T, D, device=dev, generator=g).to(dtype)
    v = torch.randn(B, Hk, T, D, device=dev, generator=g).to(dtype)
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(got, ref.attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bshd_reads_strided_views(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn(2, 128, 3, 4, 64, device=dev, generator=g).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = fa.flash_attention_bshd(q, k, v, causal=True)
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(32, 128), (33, 256), (7, 64), (4, 768),
                                    (256, 768), (1, 1000)])
def test_rmsnorm_kernel_matches_plain(dev, rows, d, dtype):
    g = torch.Generator(device=dev).manual_seed(rows + d)
    x = torch.randn(rows, d, device=dev, generator=g).to(dtype)
    s = (torch.randn(d, device=dev, generator=g) * 0.1 + 1.0).to(dtype)
    got = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    _close(got, ref.rmsnorm_ref(x, s), dtype)


def test_cuda_tensors_never_take_the_plain_route(dev, monkeypatch):
    def plain(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "attention_ref", plain)
    monkeypatch.setattr(ref, "rmsnorm_ref", plain)
    q = torch.randn(1, 2, 128, 64, device=dev)
    n_fa, n_rn = fa.launches, rn.launches
    ops.flash_attention(q, q, q)
    ops.flash_attention_bshd(q, q, q)
    ops.rmsnorm(q, torch.ones(64, device=dev))
    torch.cuda.synchronize()
    assert (fa.launches - n_fa, rn.launches - n_rn) == (2, 1)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.randn(1, 2, 64, 48, device=dev)            # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.randn(1, 2, 64, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, q, q)
    x = torch.randn(8, 64, device=dev).t()               # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm(x, torch.ones(8, device=dev))
    x = torch.randn(8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):       # fp32 scale
        ops.rmsnorm(x, torch.ones(64, device=dev))
