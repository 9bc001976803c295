"""The Hopper flash-attention forward (``csrc/flash_attention.cu``) on the
CPU: its launch plan (``kernels.flash_attention._plan``) at every config's
prefill and train shapes, the wrapper's plumbing of one plan into one
launch, and a plain-torch emulation of the bf16 bodies' arithmetic held
against the JAX kernel (interpret mode) and the fp32 oracle.

The emulation follows a plan tile by tile: the wgmma body's rows mode (each
64-row half of a 128-row tile against every KV tile) and split mode (one
64-row tile, KV tiles shared out between two warpgroups whose partial
softmaxes merge), the mma.sync body at D 16 (split by 64-key tiles, as
split mode); fp32 scores of bf16 inputs, the NEG_INF masks and the safe_m /
alpha guards, exponentials in base 2 in the wgmma body, P rounded to bf16
before PV while l sums the fp32 p, the flush by 1 / max(l, 1e-30).
Tolerance: bf16's 2e-2 (the reference's, tests/test_kernels.py).
"""
import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

import jax.numpy as jnp  # noqa: E402

NEG_INF = -1e30
TOL = dict(rtol=2e-2, atol=2e-2)
SMEM = 232448                            # a block's shared memory on sm_90


def _state(B, H, rows, D):
    return (torch.full((B, H, rows), NEG_INF), torch.zeros(B, H, rows),
            torch.zeros(B, H, rows, D))


def _tile(state, q, k, v, rows, keys, T, causal, c, exp):
    """One KV tile of the online softmax: q [B,H,r,D] (fp32 of bf16), k, v
    [B,H,n,D], ``rows`` and ``keys`` their positions, ``c`` the factor of
    the scores (scale, or scale log2(e) with ``exp`` = exp2)."""
    m_run, l_run, acc = state
    s = torch.einsum("bhrd,bhnd->bhrn", q, k) * c
    bad = keys[None, :] >= T
    if causal:
        bad = bad | (keys[None, :] > rows[:, None])
    s = torch.where(bad, torch.full_like(s, NEG_INF), s)
    m_new = torch.maximum(m_run, s.amax(-1))
    safe = torch.where(m_new <= NEG_INF, torch.zeros_like(m_new), m_new)
    alpha = torch.where(m_run <= NEG_INF, torch.zeros_like(m_run),
                        exp(m_run - safe))
    p = torch.where(s <= NEG_INF, torch.zeros_like(s), exp(s - safe[..., None]))
    l_run = alpha * l_run + p.sum(-1)
    pv = torch.einsum("bhrn,bhnd->bhrd", p.to(torch.bfloat16).float(), v)
    return m_new, l_run, acc * alpha[..., None] + pv


def _merge(a, b, exp):
    (m0, l0, acc0), (m1, l1, acc1) = a, b
    m_new = torch.maximum(m0, m1)
    safe = torch.where(m_new <= NEG_INF, torch.zeros_like(m_new), m_new)
    a0 = torch.where(m0 <= NEG_INF, torch.zeros_like(m0), exp(m0 - safe))
    a1 = torch.where(m1 <= NEG_INF, torch.zeros_like(m1), exp(m1 - safe))
    return (m_new, a0 * l0 + a1 * l1,
            a0[..., None] * acc0 + a1[..., None] * acc1)


def emulate(q, k, v, causal, plan):
    """The bf16 body of ``plan`` in plain torch: q [B,H,S,D], k, v
    [B,Hk,T,D] bf16 -> [B,H,S,D] bf16."""
    B, H, S, D = q.shape
    Hk, T = k.shape[1], k.shape[2]
    G = H // Hk
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)     # head h reads h // G
    vf = v.float().repeat_interleave(G, dim=1)
    wgmma = plan.mode in ("rows", "split")
    exp = torch.exp2 if wgmma else torch.exp
    c = D ** -0.5 * (math.log2(math.e) if wgmma else 1.0)
    bm, bk = plan.block_m, plan.block_n
    out = torch.zeros(B, H, S, D)
    n_tiles = -(-S // bm)
    for z in range(n_tiles):                       # the last tile first
        q0 = (n_tiles - 1 - z) * bm
        kv_end = min(T, q0 + bm) if causal else T
        n_kv = -(-kv_end // bk)
        # consumer groups: (first row, the KV tiles it takes)
        if plan.mode == "rows":
            groups = [(q0, range(n_kv)), (q0 + 64, range(n_kv))]
        else:
            groups = [(q0, range(0, n_kv, 2)), (q0, range(1, n_kv, 2))]
        states = []
        for r_lo, tiles in groups:
            rows = torch.arange(r_lo, r_lo + 64)
            qr = torch.zeros(B, H, 64, D)
            n = max(0, min(S, r_lo + 64) - r_lo)
            qr[:, :, :n] = qf[:, :, r_lo:r_lo + n]   # zero-filled past S
            st = _state(B, H, 64, D)
            for j in tiles:
                k0 = j * bk
                if r_lo >= S or (causal and k0 > r_lo + 63):
                    continue
                keys = torch.arange(k0, k0 + bk)
                kt = torch.zeros(B, H, bk, D)
                vt = torch.zeros(B, H, bk, D)
                m = max(0, min(T, k0 + bk) - k0)
                kt[:, :, :m] = kf[:, :, k0:k0 + m]
                vt[:, :, :m] = vf[:, :, k0:k0 + m]
                st = _tile(st, qr, kt, vt, rows, keys, T, causal, c, exp)
            states.append((r_lo, st))
        if plan.mode != "rows":
            states = [(q0, _merge(states[0][1], states[1][1], exp))]
        for r_lo, (_, l_run, acc) in states:
            n = max(0, min(S, r_lo + 64) - r_lo)
            o = acc / torch.clamp(l_run, min=1e-30)[..., None]
            out[:, :, r_lo:r_lo + n] = o[:, :, :n]
    return out.to(torch.bfloat16)


def _inputs(B, H, Hk, S, T, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, H, S, D), (B, Hk, T, D), (B, Hk, T, D))]


def _mode(mode):
    """``_plan``'s override for ``mode`` (None for the mma.sync body)."""
    return mode if mode in ("rows", "split") else None


# B, H, Hk, S, T, D, causal, mode: G 1, 2, 4 and 8; D 16, 64, 128, 256;
# ragged S and T (1, 63, 65, 129); both modes of the wgmma body.
EMU_CASES = [
    (1, 2, 2, 128, 128, 64, True, "rows"),
    (1, 2, 2, 128, 128, 64, True, "split"),
    (2, 4, 2, 65, 65, 64, True, "rows"),
    (2, 4, 2, 65, 65, 64, True, "split"),
    (1, 8, 1, 129, 129, 64, True, "split"),
    (1, 4, 1, 63, 129, 64, False, "rows"),
    (1, 4, 4, 1, 1, 64, True, "rows"),
    (1, 4, 4, 1, 65, 64, False, "split"),
    (1, 8, 2, 129, 129, 128, True, "rows"),
    (1, 8, 2, 129, 129, 128, True, "split"),
    (1, 8, 8, 63, 63, 128, True, "split"),
    (1, 8, 1, 65, 63, 128, False, "rows"),
    (1, 4, 1, 129, 129, 256, True, "rows"),
    (1, 4, 1, 129, 129, 256, True, "split"),
    (1, 4, 2, 65, 129, 256, False, "split"),
    (1, 8, 1, 1, 129, 256, False, "rows"),
    (1, 4, 1, 65, 65, 16, True, "mma"),
    (1, 4, 2, 129, 63, 16, False, "mma"),
    (1, 8, 1, 63, 63, 16, True, "mma"),
]


@pytest.mark.parametrize("B,H,Hk,S,T,D,causal,mode", EMU_CASES)
def test_emulated_body_matches_fp32_reference(B, H, Hk, S, T, D, causal,
                                              mode):
    qn, kn, vn = _inputs(B, H, Hk, S, T, D, seed=S * 7 + T + D + H)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    plan = fa._plan(B, H, Hk, S, T, D, mode=_mode(mode))
    assert plan.mode == mode
    got = emulate(q, k, v, causal, plan)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), **TOL)


# S and T dividing the JAX kernel's blocks (min(128, S)): its interpret
# mode against the emulation, both in bf16.
JAX_CASES = [
    (1, 4, 4, 128, 128, 64, True, "rows"),
    (1, 4, 2, 256, 256, 64, True, "split"),
    (1, 8, 1, 64, 64, 128, True, "rows"),
    (1, 8, 2, 128, 256, 128, False, "split"),
    (1, 4, 1, 128, 128, 256, True, "split"),
    (1, 4, 1, 256, 256, 256, True, "rows"),
    (2, 4, 2, 128, 128, 16, True, "mma"),
]


@pytest.mark.parametrize("B,H,Hk,S,T,D,causal,mode", JAX_CASES)
def test_emulated_body_matches_jax_kernel(B, H, Hk, S, T, D, causal, mode):
    qn, kn, vn = _inputs(B, H, Hk, S, T, D, seed=S + T + D)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    plan = fa._plan(B, H, Hk, S, T, D, mode=_mode(mode))
    assert plan.mode == mode
    got = emulate(q, k, v, causal, plan)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (qn, kn, vn))
    kern = jax_flash(jq, jk, jv, causal=causal, interpret=True)
    oracle = jax_ref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kern.astype(jnp.float32)), **TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(oracle.astype(jnp.float32)), **TOL)


# Every config's prefill and train shapes (PERF.md's kernel table, row 1):
# arch, B, H, Hk, S, D, and the mode the plan's rule gives on an H100.
PLAN_SHAPES = [
    ("llsc-100m", 1, 12, 12, 128, 64, "split"),
    ("llsc-100m", 1, 12, 12, 256, 64, "split"),
    ("llsc-100m", 8, 12, 12, 256, 64, "rows"),
    ("granite-moe-1b-a400m", 1, 16, 8, 128, 64, "split"),
    ("granite-moe-1b-a400m", 1, 16, 8, 256, 64, "split"),
    ("granite-moe-1b-a400m", 8, 16, 8, 256, 64, "rows"),
    ("jamba-1.5-large-398b", 1, 64, 8, 128, 128, "split"),
    ("jamba-1.5-large-398b", 1, 64, 8, 256, 128, "split"),
    ("gemma3-1b", 1, 4, 1, 256, 256, "split"),
    ("gemma3-1b", 1, 4, 1, 640, 256, "split"),
    ("gemma3-1b", 8, 4, 1, 256, 256, "split"),
    ("reduced", 1, 4, 1, 64, 16, "mma"),
    ("qwen1.5-4b", 1, 20, 20, 128, 128, "split"),
    ("qwen1.5-4b", 1, 20, 20, 256, 128, "split"),
    ("qwen1.5-4b", 8, 20, 20, 256, 128, "rows"),
    ("phi3-medium-14b", 1, 40, 10, 128, 128, "split"),
    ("phi3-medium-14b", 1, 40, 10, 256, 128, "split"),
    ("whisper-base", 1, 8, 8, 128, 64, "split"),
    ("whisper-base", 4, 8, 8, 128, 64, "split"),
    ("whisper-base", 4, 8, 8, 256, 64, "split"),
    ("whisper-base", 8, 8, 8, 256, 64, "split"),
    ("internvl2-2b", 1, 16, 8, 128, 128, "split"),
    ("internvl2-2b", 1, 16, 8, 256, 128, "split"),
    ("internvl2-2b", 1, 16, 8, 384, 128, "split"),
    ("internvl2-2b", 1, 16, 8, 512, 128, "split"),
    ("internvl2-2b", 4, 16, 8, 384, 128, "rows"),
    ("internvl2-2b", 8, 16, 8, 512, 128, "rows"),
]


@pytest.mark.parametrize("arch,B,H,Hk,S,D,mode", PLAN_SHAPES)
def test_plan_at_every_config_shape(arch, B, H, Hk, S, D, mode):
    plan = fa._plan(B, H, Hk, S, S, D)
    assert plan.mode == mode, arch
    assert 0 < plan.smem <= SMEM
    tiles = math.ceil(S / plan.block_m)        # query tiles cover every row
    assert (tiles - 1) * plan.block_m < S <= tiles * plan.block_m
    if D >= 64:
        assert plan.mode in ("rows", "split") and plan.threads == 384
        # split: a block a work tile; rows: one block an SM at most, each
        # walking the work tiles
        work = B * H * tiles
        assert plan.grid == ((work if mode == "split" else min(work, 132)),
                             1, 1)
        # the rule of the docstring
        assert (plan.mode == "rows") == (B * H * math.ceil(S / 128) >= 132)
        assert plan.stages >= 2
        assert plan.stages % 2 == 0 or plan.mode == "rows"
        # the override that times the other mode
        other = "split" if mode == "rows" else "rows"
        o = fa._plan(B, H, Hk, S, S, D, mode=other)
        assert o.mode == other and o.smem <= SMEM
    else:
        assert plan.mode == "mma" and plan.threads == 256
        assert plan.grid == (H, B, tiles)
    # fp32 takes its own body at every shape
    f = fa._plan(B, H, Hk, S, S, D, torch.float32)
    assert f.mode == "fp32" and f.grid == (-(-S // 32), H, B)
    assert f.smem <= SMEM


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("mode", ["rows", "split"])
def test_wgmma_tiles_fit_and_use_three_stages_where_they_can(D, mode):
    """Shared memory: Q, the ring, alignment slack and barriers within a
    block's 232,448 bytes; a third stage (a fourth in split mode, a pair
    for each warpgroup) only where it fits."""
    plan = fa._plan(1, 1, 1, 128, 128, D, mode=mode)
    assert plan.mode == mode and plan.smem <= SMEM
    per_stage = 2 * plan.block_n * D * 2
    step = 1 if mode == "rows" else 2
    assert plan.smem + step * per_stage > SMEM or plan.stages >= 3


def test_launch_passes_one_plan_to_one_launch(monkeypatch):
    """The wrapper makes one plan a call and passes it, after the strides,
    scale and causal flag, to one call of the C entry point; ``launches``
    counts it.  CPU tensors stand in for CUDA ones (the device context, the
    stream and the kernel are stand-ins)."""
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(fa, "_kernel", lambda: kernel)
    monkeypatch.setattr(fa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    B, H, Hk, S, D = 8, 16, 8, 512, 128
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    k = torch.zeros(B, S, Hk, D, dtype=torch.bfloat16)
    out = torch.empty_like(q)

    def bsh(t):
        return (t.stride(0), t.stride(1), t.stride(2))

    n = fa.launches
    fa._launch(q, k, k, out, (B, H, Hk, S, S, D),
               (bsh(q), bsh(k), bsh(k), bsh(out)), True, None)
    assert fa.launches == n + 1 and len(calls) == 1
    plan = fa._plan(B, H, Hk, S, S, D)
    args = calls[0]
    assert args[4:11] == (1, B, H, Hk, S, S, D)
    assert args[-11] == 1                       # causal
    assert args[-10:-1] == (fa.MODES[plan.mode], plan.block_m, plan.block_n,
                            plan.stages, plan.threads, plan.smem, *plan.grid)
    assert args[-1] == 7
    assert plan.mode == "rows"


def test_launch_raises_on_a_refused_tensor_map(monkeypatch):
    """No fallback: a negative return (the tensor maps could not be
    encoded) or a CUDA error raises, and nothing is counted."""
    monkeypatch.setattr(fa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    st = (q.stride(0), q.stride(1), q.stride(2))
    n = fa.launches
    for err, text in ((-2, "tensor maps"), (-1, "cuTensorMapEncodeTiled"),
                      (1, "CUDA error 1")):
        monkeypatch.setattr(fa, "_kernel", lambda err=err: lambda *a: err)
        with pytest.raises(RuntimeError, match=text):
            fa._launch(q, q, q, torch.empty_like(q), (1, 2, 2, 64, 64, 64),
                       (st,) * 4, True, None)
    assert fa.launches == n
