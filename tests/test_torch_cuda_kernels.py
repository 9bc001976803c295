"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``: they skip where CUDA is absent.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances are the reference's (tests/test_kernels.py): 2e-5 in float32,
2e-2 in bfloat16; 2e-4 for the SSD intra-chunk block, computed in float32
from either input dtype, whose sums run in another order.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402

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
    (1, 4, 1, 33, 70, 32, False), (1, 12, 12, 1024, 1024, 64, True),
    (1, 4, 2, 16, 16, 64, True), (1, 4, 2, 1, 1, 64, True),
    (1, 8, 2, 320, 320, 128, True), (1, 64, 8, 256, 256, 128, True),
    # D = 16, every reduced config's head dim
    (2, 4, 2, 128, 128, 16, True), (1, 4, 1, 33, 70, 16, False),
    (2, 4, 4, 100, 100, 16, True), (1, 4, 1, 1, 1, 16, True),
    # D = 256, gemma3-1b's global layers (4 query heads, 1 KV head)
    (1, 4, 1, 256, 256, 256, True), (1, 4, 1, 640, 640, 256, True),
    (2, 4, 1, 100, 100, 256, True), (1, 4, 2, 33, 70, 256, False),
    (1, 4, 1, 1024, 1024, 256, True), (8, 4, 1, 256, 256, 256, True),
    # D = 128: qwen1.5-4b's 20 heads and phi3-medium-14b's 40 query and 10
    # KV heads (G = 4), at the serve's prefills and a train step
    (1, 20, 20, 256, 256, 128, True), (1, 40, 10, 128, 128, 128, True),
    (1, 40, 10, 256, 256, 128, True), (8, 20, 20, 256, 256, 128, True),
    # whisper-base's decoder (8 heads of 64) and internvl2-2b's 16 query and
    # 8 KV heads of 128 (G = 2) over patches and tokens, at the serves'
    # prefills and a train step
    (1, 8, 8, 128, 128, 64, True), (8, 8, 8, 256, 256, 64, True),
    (1, 16, 8, 384, 384, 128, True), (1, 16, 8, 512, 512, 128, True),
    (8, 16, 8, 512, 512, 128, True)])
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


# The Hopper body's two modes at each of its head dims: causal S = T, and
# full attention with T apart from S, over S and T in {1, 63, 65, 127, 129,
# 1000, 2048}, at G 8 (jamba's 64 query and 8 KV heads, cut to 16 and 2).
# ``_plan`` takes rows mode when the 128-row work tiles, B H ceil(S / 128),
# number at least the card's SMs; a stand-in SM count forces either mode.
WGMMA_SHAPES = [(S, S, True) for S in (1, 63, 65, 127, 129, 1000, 2048)] + [
    (1, 63, False), (63, 1, False), (65, 1000, False), (129, 2048, False),
    (2048, 127, False), (1000, 65, False), (127, 129, False)]
MODE_SMS = {"rows": 1, "split": 10 ** 9}


@pytest.mark.parametrize("S,T,causal", WGMMA_SHAPES)
@pytest.mark.parametrize("mode", ["rows", "split"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_wgmma_modes_match_plain(dev, monkeypatch, D, mode, S, T,
                                       causal):
    monkeypatch.setattr(fa, "_sm_count", lambda index: MODE_SMS[mode])
    assert fa._plan(1, 16, 2, S, T, D, torch.bfloat16,
                    MODE_SMS[mode]).mode == mode
    g = torch.Generator(device=dev).manual_seed(S + 3 * T + D)
    q = torch.randn(1, 16, S, D, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(1, 2, T, D, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(1, 2, T, D, device=dev, generator=g).to(torch.bfloat16)
    n = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == n + 1
    _close(got, ref.attention_ref(q, k, v, causal=causal), torch.bfloat16)


@pytest.mark.parametrize("mode", ["rows", "split"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_wgmma_reads_strided_views_of_one_qkv_buffer(dev, monkeypatch,
                                                           D, mode):
    """q, k and v as the model cuts them from one fused projection, [B, S,
    H + 2 Hk, D]: the tensor maps step through the buffer's strides."""
    monkeypatch.setattr(fa, "_sm_count", lambda index: MODE_SMS[mode])
    H, Hk = 16, 2
    g = torch.Generator(device=dev).manual_seed(D)
    qkv = torch.randn(2, 1000, H + 2 * Hk, D, device=dev,
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hk], qkv[:, :, H + Hk:]
    got = fa.flash_attention_bshd(q, k, v, causal=True)
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("S", [256, 1024])
def test_flash_bf16_error_is_the_rounding_of_weights_and_output(dev, S):
    """Against attention computed exactly (float64) from the same bf16
    inputs.  The bf16 body rounds two things: each weight exp(s - m) before
    the PV product, and the output.  With u = 2**-8, bf16's unit roundoff,
    the first moves an output by at most u * (P @ |V|), the second by at
    most u * |out|, so every element stays within their sum.  The RMS error
    must also stay within 0.75 u of the output's RMS: the two roundings
    alone give about 0.57 u at these shapes, and one of the two warp
    groups' weights off by 1% gives 1.0 u or more."""
    u = 2.0 ** -8
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn(1, 12, S, 64, device=dev, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True).double()
    s = q.double() @ k.double().transpose(-1, -2) * 64 ** -0.5
    above = torch.ones(S, S, dtype=torch.bool, device=dev).triu(1)
    p = torch.softmax(s.masked_fill(above, float("-inf")), dim=-1)
    want = p @ v.double()
    bound = u * (p @ v.double().abs() + want.abs()) + 1e-6
    worst = ((got - want).abs() / bound).max().item()
    rms = ((got - want).pow(2).mean() / want.pow(2).mean()).sqrt().item()
    print(f"S {S}: worst error / bound {worst:.3f}, RMS error {rms / u:.3f} u")
    assert worst <= 1, f"worst error / bound {worst:.3f}"
    assert rms <= 0.75 * u, f"RMS error {rms / u:.3f} u"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [8, 96, 512])
def test_flash_refuses_other_head_dims(dev, D, dtype):
    """A head dim outside ``HEAD_DIMS`` raises before any launch."""
    q = torch.randn(1, 2, 64, D, device=dev).to(dtype)
    n = fa.launches
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    assert fa.launches == n


def test_flash_bf16_refuses_unaligned_inputs(dev):
    """The bf16 body reads q, k, v with 16-byte copies: a view one element
    off alignment, or a sequence stride that is not a multiple of 8
    elements, raises and launches nothing."""
    buf = torch.randn(2 * 64 * 64 + 1, device=dev).to(torch.bfloat16)
    odd = buf[1:].view(1, 2, 64, 64)
    n = fa.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(odd, odd, odd)
    wide = torch.randn(1, 64, 2, 68, device=dev).to(torch.bfloat16)
    q = wide[..., :64]                        # head stride 68
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_bshd(q, q, q)
    assert fa.launches == n
    odd = torch.randn(2 * 64 * 64 + 1, device=dev)[1:].view(1, 2, 64, 64)
    got = fa.flash_attention(odd, odd, odd)   # fp32 takes any alignment
    torch.cuda.synchronize()
    _close(got, ref.attention_ref(odd, odd, odd), torch.float32)


# The test sweep, llsc-100m's and mamba2-370m's rows (vector body), then
# widths that are not a multiple of 8 elements (scalar body); then
# qwen1.5-4b's and minicpm3-4b's rows of 2560 (vector body), phi3-medium-
# 14b's of 5120 (past 4096: the scalar body) and minicpm3-4b's q_norm
# (768) and kv_norm (256) rows, at a decode step's 4 and a prefill's 256;
# whisper-base's rows of 512 (a decode step's 4, the encoder's 4 x 1500)
# and internvl2-2b's of 2048 (4, and a prefill's 256 patches and 128
# tokens).
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(32, 128), (33, 256), (7, 64), (4, 768),
                                    (256, 768), (1, 1000), (4, 1024),
                                    (320, 1024), (5, 100), (3, 101),
                                    (4, 2560), (256, 2560), (4, 5120),
                                    (256, 5120), (4, 256), (256, 256),
                                    (4, 512), (6000, 512), (4, 2048),
                                    (384, 2048)])
def test_rmsnorm_kernel_matches_plain(dev, rows, d, dtype):
    g = torch.Generator(device=dev).manual_seed(rows + d)
    x = torch.randn(rows, d, device=dev, generator=g).to(dtype)
    s = (torch.randn(d, device=dev, generator=g) * 0.1 + 1.0).to(dtype)
    got = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    _close(got, ref.rmsnorm_ref(x, s), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_reads_rows_off_alignment(dev, dtype):
    """Rows one element off 16-byte alignment take the scalar body."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(4 * 768 + 1, device=dev, generator=g).to(dtype)
    x = x[1:].view(4, 768)
    s = (torch.randn(768, device=dev, generator=g) * 0.1 + 1.0).to(dtype)
    got = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    _close(got, ref.rmsnorm_ref(x, s), dtype)


# MLA's kv_norm input: the first 256 columns of wkv_a's 288-wide output,
# rows 288 elements apart (a whole number of 16-byte vectors: the vector
# body), at a decode step's and a prefill's rows; then a row stride of 289
# (not a whole number of vectors: the scalar body).
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,d,width", [((4, 1), 256, 288),
                                          ((1, 256), 256, 288),
                                          ((3, 5), 256, 289)])
def test_rmsnorm_reads_strided_rows(dev, dtype, lead, d, width):
    g = torch.Generator(device=dev).manual_seed(width + lead[1])
    proj = torch.randn(*lead, width, device=dev, generator=g).to(dtype)
    x = proj[..., :d]
    assert not x.is_contiguous()
    s = (torch.randn(d, device=dev, generator=g) * 0.1 + 1.0).to(dtype)
    n = rn.launches
    got = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rn.launches == n + 1 and got.is_contiguous()
    _close(got, ref.rmsnorm_ref(x, s), dtype)
    _close(got, ref.rmsnorm_ref(x.contiguous(), s), dtype)


def test_strided_norm_input_never_takes_the_plain_route(dev, monkeypatch):
    """ops.rmsnorm on MLA's strided kv_norm view launches the kernel (and,
    under autograd, through its Function); rows with no single stride
    raise and launch nothing."""
    def plain(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    proj = torch.randn(2, 3, 288, device=dev)
    s = torch.ones(256, device=dev)
    monkeypatch.setattr(ref, "rmsnorm_ref", plain)
    n = rn.launches
    ops.rmsnorm(proj[..., :256], s)
    ops.rmsnorm(proj[..., :256], s.clone().requires_grad_())
    torch.cuda.synchronize()
    assert rn.launches == n + 2
    ragged = torch.randn(4, 6, 64, device=dev)[:, :5]    # rows 64 and 384 apart
    with pytest.raises(ValueError, match="no single stride"):
        ops.rmsnorm(ragged, torch.ones(64, device=dev))
    assert rn.launches == n + 2


def test_cuda_tensors_never_take_the_plain_route(dev, monkeypatch):
    def plain(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "attention_ref", plain)
    monkeypatch.setattr(ref, "rmsnorm_ref", plain)
    q = torch.randn(1, 2, 128, 64, device=dev)
    n_fa, n_rn = fa.launches, rn.launches
    ops.flash_attention(q, q, q)
    with torch.no_grad():        # no autograd, so an input may require grad
        ops.flash_attention_bshd(q, q.clone().requires_grad_(), q)
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
    x = torch.randn(8, 64, device=dev)
    n = rn.launches
    with pytest.raises(ValueError, match="dtype"):       # bf16 scale, fp32 x
        ops.rmsnorm(x, torch.ones(64, device=dev, dtype=torch.bfloat16))
    assert rn.launches == n


# bf16 activations with a float32 scale, which the reference's cast_params
# leaves on 1-D scales and applies in fp32: llsc-100m's decode rows and
# 320 rows of mamba2-370m's gated width; off 16-byte alignment by ``off``
# elements (the scalar bodies).
@pytest.mark.parametrize("rows,d,off", [(4, 768, 0), (320, 2048, 0),
                                        (4, 768, 1), (3, 101, 0)])
def test_norms_take_bf16_input_with_a_float32_scale(dev, rows, d, off):
    g = torch.Generator(device=dev).manual_seed(rows + d + off)

    def bf16_rows():
        buf = torch.randn(rows * d + off, device=dev, generator=g)
        return buf.to(torch.bfloat16)[off:].view(rows, d)

    x, z = bf16_rows(), bf16_rows()
    s = torch.randn(d, device=dev, generator=g) * 0.1 + 1.0
    got = rn.rmsnorm(x, s)
    assert got.dtype == torch.bfloat16
    _close(got, ref.rmsnorm_ref(x, s), torch.bfloat16)
    got = rn.gated_rmsnorm(x, z, s)
    assert got.dtype == torch.bfloat16
    _close(got, ref.gated_rmsnorm_ref(x, z, s), torch.bfloat16)
    torch.cuda.synchronize()


# The reference's shape, mamba2-370m's decode (4 slots) and prefill (320
# tokens) rows of 2048, jamba's decode and prefill rows of 16384 (the
# vector body at 16 and 32 warps a row), and a width past 4096 that is no
# whole number of vectors (the scalar body at 1024 threads a row).
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 16, 128), (4, 1, 2048), (1, 320, 2048),
                                   (3, 1000), (7, 64), (2, 4096),
                                   (4, 1, 16384), (1, 256, 16384), (3, 9999)])
def test_gated_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    y = torch.randn(shape, device=dev, generator=g).to(dtype)
    z = torch.randn(shape, device=dev, generator=g).to(dtype)
    s = (torch.randn(shape[-1], device=dev, generator=g) * 0.1 + 1.0).to(dtype)
    got = rn.gated_rmsnorm(y, z, s)
    torch.cuda.synchronize()
    _close(got, ref.gated_rmsnorm_ref(y, z, s), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,proj_width", [(2048, 2 * 2048 + 288),
                                          (16384, 2 * 16384 + 2 * 16 + 256)])
def test_gated_rmsnorm_reads_a_strided_gate(dev, dtype, d, proj_width):
    """The gate as the model has it: a slice of the input projection, at
    mamba2-370m's width and at jamba's, whose projection rows are 33,056
    elements apart."""
    g = torch.Generator(device=dev).manual_seed(3)
    proj = torch.randn(4, 5, proj_width, device=dev, generator=g).to(dtype)
    y = torch.randn(4, 5, d, device=dev, generator=g).to(dtype)
    z = proj[..., :d]
    s = torch.ones(d, device=dev, dtype=dtype)
    got = rn.gated_rmsnorm(y, z, s)
    torch.cuda.synchronize()
    _close(got, ref.gated_rmsnorm_ref(y, z, s), dtype)
    _close(rn.gated_rmsnorm(y[:, :1], z[:, -1:], s),
           ref.gated_rmsnorm_ref(y[:, :1], z[:, -1:], s), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_rmsnorm_reads_rows_off_alignment(dev, dtype):
    """Rows one element off 16-byte alignment, or a row stride that is not
    a whole number of 16-byte vectors, take the scalar body."""
    g = torch.Generator(device=dev).manual_seed(11)
    y = torch.randn(4 * 2048 + 1, device=dev, generator=g).to(dtype)
    y = y[1:].view(4, 2048)
    z = torch.randn(4, 2048 + 3, device=dev, generator=g).to(dtype)[:, 3:]
    s = (torch.randn(2048, device=dev, generator=g) * 0.1 + 1.0).to(dtype)
    got = rn.gated_rmsnorm(y, z, s)
    torch.cuda.synchronize()
    _close(got, ref.gated_rmsnorm_ref(y, z, s), dtype)


def _ssd_inputs(dev, N, l, h, p, g, n, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    x = randn(N, l, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(N, l, h))
    A = -torch.exp(randn(h) * 0.3)
    B, C = randn(N, l, g, n).to(dtype), randn(N, l, g, n).to(dtype)
    return x, dt, A, B, C


# (body, heads a block) that each case of the sweep below takes in bf16,
# contiguous: head dim 64 with state 16 or 128 and chunks up to 256 the
# Hopper body; other bf16 with p and n multiples of 8 the mma.sync body, two
# heads a block where the heads of a group pair up, else one; the rest the
# CUDA-core body.  In fp32 every case takes the CUDA-core body.
SSD_BF16_BODY = {
    (1, 32, 4, 16, 1, 8): ("mma", 2), (2, 64, 8, 32, 2, 16): ("mma", 2),
    (1, 16, 2, 8, 2, 4): ("fp32", 0), (3, 40, 4, 64, 1, 128): ("wgmma", 1),
    (1, 200, 4, 128, 1, 64): ("mma", 2), (2, 100, 6, 64, 2, 128): ("wgmma", 1),
    (2, 256, 32, 64, 1, 128): ("wgmma", 1),
    (1, 256, 256, 64, 1, 16): ("wgmma", 1),
    (8, 256, 32, 64, 1, 128): ("wgmma", 1), (2, 1, 4, 64, 1, 128): ("wgmma", 1),
    (1, 192, 6, 64, 3, 16): ("wgmma", 1), (3, 100, 4, 64, 2, 16): ("wgmma", 1),
    (1, 256, 4, 64, 1, 64): ("mma", 2)}


# The sweep of tests/test_kernels.py, ragged chunks (40: one key tile;
# 200 and 100: several, the last partial), p = 128, three heads a group,
# then mamba2-370m's two chunks of a 320-token prefill (the second padded)
# and jamba's chunk of 256 (256 heads of 64, state 16); then the Hopper
# body's edges: a train step's 8 chunks, one query tile alone (1 row), a
# middle tile (192: a pair and a single), state 16 ragged and in groups.
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,l,h,p,g,n", [
    (1, 32, 4, 16, 1, 8), (2, 64, 8, 32, 2, 16), (1, 16, 2, 8, 2, 4),
    (3, 40, 4, 64, 1, 128), (1, 200, 4, 128, 1, 64), (2, 100, 6, 64, 2, 128),
    (2, 256, 32, 64, 1, 128), (1, 256, 256, 64, 1, 16),
    (8, 256, 32, 64, 1, 128), (2, 1, 4, 64, 1, 128), (1, 192, 6, 64, 3, 16),
    (3, 100, 4, 64, 2, 16), (1, 256, 4, 64, 1, 64)])
def test_ssd_kernel_matches_plain(dev, N, l, h, p, g, n, dtype):
    x, dt, A, B, C = _ssd_inputs(dev, N, l, h, p, g, n, dtype, seed=l + h)
    for out_dtype in {torch.float32, dtype}:
        got = ssd.ssd_intra_chunk(x, dt, A, B, C, out_dtype=out_dtype)
        want_body = (SSD_BF16_BODY[N, l, h, p, g, n]
                     if dtype == torch.bfloat16 else ("fp32", 0))
        plan = ssd.plan(N, l, h, p, g, n, dtype)
        assert (ssd.body, ssd.heads_per_block) == want_body == (
            plan.body, plan.heads_per_block)
        want = ref.ssd_intra_chunk_ref(x, dt, A, B, C, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        tol = 2e-4 if out_dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("N,h,n", [(2, 32, 128), (1, 256, 16)])
def test_ssd_hopper_body_repeats_bit_for_bit(dev, N, h, n):
    """The Hopper body adds its consumers' partial sums in a fixed order,
    with no atomics: two calls give the same bits."""
    x, dt, A, B, C = _ssd_inputs(dev, N, 256, h, 64, 1, n, torch.bfloat16,
                                 seed=h)
    a = ssd.ssd_intra_chunk(x, dt, A, B, C, out_dtype=torch.float32)
    b = ssd.ssd_intra_chunk(x, dt, A, B, C, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ssd.body == "wgmma" and torch.equal(a, b)


@pytest.mark.parametrize("shape,dim", [((2, 2, 256, 1, 32), 2),
                                       ((2, 32, 256), -1), ((3, 200), 1)])
def test_cumsum_f32_sums_left_to_right_on_the_card(dev, shape, dim):
    """The plain version's cumsum on the card, at the mamba serve's A_cum
    shape ([b, nc, l, g, hg] along l), the SSD block's [N, h, l] and a 2-D
    tensor: bit for bit a loop of float32 adds, left to right, and the
    CPU's cumsum_f32, the order of the SSD kernel's scan."""
    g = torch.Generator(device=dev).manual_seed(len(shape))
    x = -torch.nn.functional.softplus(
        torch.randn(shape, device=dev, generator=g))
    acc, want = torch.zeros_like(x.select(dim, 0)), []
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
        want.append(acc)
    got = ref.cumsum_f32(x, dim)
    assert torch.equal(got, torch.stack(want, dim % x.dim()))
    assert torch.equal(got.cpu(), ref.cumsum_f32(x.cpu(), dim))


def test_ssd_kernel_reads_strided_views_and_selects_the_mask(dev):
    """x, B, C as slices of one buffer, as the model's conv output is; and
    decays so steep that exp above the diagonal is inf: no NaN."""
    gen = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randn(2, 64, 4 * 16 + 2 * 8, device=dev, generator=gen)
    x = buf[..., :64].reshape(2, 64, 4, 16)
    B = buf[..., 64:72].reshape(2, 64, 1, 8)
    C = buf[..., 72:].reshape(2, 64, 1, 8)
    dt = torch.full((2, 64, 4), 50.0, device=dev)
    A = -torch.arange(1, 5, device=dev, dtype=torch.float32)
    got = ssd.ssd_intra_chunk(x, dt, A, B, C)
    want = ref.ssd_intra_chunk_ref(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("h,n,off", [(32, 128, 0), (32, 128, 1),
                                     (256, 16, 0), (256, 16, 1)])
@pytest.mark.parametrize("out_dtype", DTYPES)
def test_ssd_bf16_reads_the_models_views(dev, h, n, off, out_dtype):
    """x, B, C as the model hands them over: views of one conv output with
    a row stride of h p + 2 n elements (mamba2-370m's 2304, B and C at 2048
    and 2176; jamba's 16416), which take the Hopper body; then B and C one
    element further on (``off`` 1), off 16-byte alignment, which take the
    CUDA-core body."""
    N, l, p, g = 2 if h == 32 else 1, 256, 64, 1
    gen = torch.Generator(device=dev).manual_seed(7 + off + h)
    xbc = torch.randn(N, l, h * p + 2 * g * n + off, device=dev,
                      generator=gen).to(torch.bfloat16)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    B = xbc[..., h * p + off:h * p + g * n + off].unflatten(-1, (g, n))
    C = xbc[..., h * p + g * n + off:].unflatten(-1, (g, n))
    dt = torch.nn.functional.softplus(torch.randn(N, l, h, device=dev,
                                                  generator=gen))
    A = -torch.exp(torch.randn(h, device=dev, generator=gen) * 0.3)
    got = ssd.ssd_intra_chunk(x, dt, A, B, C, out_dtype=out_dtype)
    assert ssd.body == ("fp32" if off else "wgmma")
    want = ref.ssd_intra_chunk_ref(x, dt, A, B, C, out_dtype=out_dtype)
    torch.cuda.synchronize()
    tol = 2e-4 if out_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_mamba_kernels_route_and_count(dev, monkeypatch):
    def plain(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "gated_rmsnorm_ref", plain)
    monkeypatch.setattr(ref, "ssd_intra_chunk_ref", plain)
    n_g, n_s = rn.gated_launches, ssd.launches
    y = torch.randn(4, 64, device=dev)
    ops.gated_rmsnorm(y, y, torch.ones(64, device=dev))
    ops.ssd_intra_chunk(*_ssd_inputs(dev, 1, 32, 4, 16, 1, 8, torch.float32))
    torch.cuda.synchronize()
    assert (rn.gated_launches - n_g, ssd.launches - n_s) == (1, 1)


def test_mamba_kernels_refuse_what_they_do_not_take(dev):
    y = torch.randn(4, 64, device=dev)
    with pytest.raises(ValueError, match="dtype"):          # mixed dtypes
        ops.gated_rmsnorm(y, y.to(torch.bfloat16), torch.ones(64, device=dev))
    with pytest.raises(ValueError, match="dtype"):          # bf16 scale
        ops.gated_rmsnorm(y, y, torch.ones(64, device=dev,
                                           dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):     # strided columns
        ops.gated_rmsnorm(y[:, ::2], y[:, ::2], torch.ones(32, device=dev))
    wide = torch.randn(2, 16385, device=dev)
    with pytest.raises(ValueError, match="at most 16384"):  # too wide a row
        ops.gated_rmsnorm(wide, wide, torch.ones(16385, device=dev))
    x, dt, A, B, C = _ssd_inputs(dev, 1, 32, 4, 16, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="float32"):        # bf16 dt
        ops.ssd_intra_chunk(x, dt.to(torch.bfloat16), A, B, C)
    with pytest.raises(ValueError, match="dtype"):          # B in bf16
        ops.ssd_intra_chunk(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(ValueError, match="out_dtype"):      # fp32 x, bf16 y
        ops.ssd_intra_chunk(x, dt, A, B, C, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="groups"):         # 4 heads, 3 groups
        xg, dtg, Ag, Bg, Cg = _ssd_inputs(dev, 1, 32, 4, 16, 3, 8,
                                          torch.float32)
        ops.ssd_intra_chunk(xg, dtg, Ag, Bg, Cg)
    with pytest.raises(ValueError, match="head dim"):       # p = 256
        ops.ssd_intra_chunk(*_ssd_inputs(dev, 1, 8, 2, 256, 1, 8,
                                         torch.float32))
    with pytest.raises(ValueError, match="CUDA"):           # dt on the CPU
        ops.ssd_intra_chunk(x, dt.cpu(), A, B, C)
