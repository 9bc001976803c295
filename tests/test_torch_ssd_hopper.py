"""The Hopper SSD intra-chunk body (``csrc/ssd.cu``,
``ssd_intra_chunk_wgmma_kernel``) on the CPU: its work split, its launch
plan at every config's shapes (the C side's rule, ``csrc/ssd_plan.h``,
built for the host with the system's C++ compiler), the wrapper's
plumbing of one call into one launch, and a plain-torch emulation of its
arithmetic held against the fp32 oracle and the JAX kernel (interpret
mode).

The emulation follows the kernel item by item: pairs of 64-row query tiles
{nq - 1 - i, i} of one (chunk, head); consumer g of a block takes the key
tiles kt = g, g + 2, ... of both tiles; C.B of a key tile in fp32 from
bf16 inputs; W' = (C.B) exp(cs_i - cs_j) dt_j (j <= i < l, else 0) formed
on the accumulator fragment and split into three bf16 terms, each placed
where the A fragment of y += W' x puts it; each consumer's partial sums,
added as consumer 0's plus consumer 1's.  cs is the fp32 left-to-right
cumsum (``ref.cumsum_f32``), as the kernel's scan.  Tolerance: SSD_TOL,
2e-4 (the reference's, tests/test_kernels.py), fp32 out.
"""
import contextlib
import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ssd_intra_chunk as jax_ssd  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import _build, ref, ssd  # noqa: E402

SSD_TOL = 2e-4
SMEM = 232448                     # a block's opt-in shared memory on sm_90
TILE = 64

# The accumulator of m64n64 (fp32, 32 registers a thread): element e of
# thread t is row 16 (t // 32) + (t % 32) // 4 + 8 ((e >> 1) & 1), column
# 8 (e >> 2) + 2 (t % 4) + (e & 1) (hopper.cuh).
_T = torch.arange(128)[:, None]
_E = torch.arange(32)[None, :]
ACC_ROW = 16 * (_T // 32) + (_T % 32) // 4 + 8 * ((_E >> 1) & 1)
ACC_COL = 8 * (_E >> 2) + 2 * (_T % 4) + (_E & 1)
# Where form_w packs element e: k-step kk, register q of the A fragment,
# half (low or high bf16 of the register).
PACK_KK = (_E >> 2) // 2
PACK_Q = 2 * ((_E >> 2) % 2) + ((_E >> 1) & 1)
PACK_HALF = _E & 1


def a_fragment_position(t, kk, q, half):
    """Row and column of the m64k16 bf16 A fragment's register q, half
    ``half``, of thread t at k-step kk: mma.m16n8k16's A fragment for warp
    t // 32's 16 rows (a0: row r, cols 2c; a1: row r + 8; a2: cols + 8;
    a3: both)."""
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * (q & 1)
    col = 16 * kk + 2 * (t % 4) + 8 * (q >> 1) + half
    return row, col


def work(N, l, h, sms=132):
    """The kernel's schedule: (block, item, consumer, chunk, head, query
    tile, key tile) for every (query tile, key tile) unit, in the order
    each consumer takes them.  Items are pairs of query tiles, the
    heaviest first; block b walks items b, b + grid, ..."""
    nq = -(-l // TILE)
    n_items = (nq + 1) // 2 * N * h
    grid = min(n_items, sms)
    out = []
    for w in range(n_items):
        pi, rest = divmod(w, N * h)
        chunk, head = divmod(rest, h)
        qhi, qlo = nq - 1 - pi, pi
        for g in (0, 1):
            for kt in range(g, qhi + 1, 2):
                out.append((w % grid, w, g, chunk, head, qhi, kt))
                if qlo < qhi and kt <= qlo:
                    out.append((w % grid, w, g, chunk, head, qlo, kt))
    return out


def _split3(w):
    """W' as three bf16 terms: each the rounding of what the terms before
    it left (form_w)."""
    hi = w.to(torch.bfloat16).float()
    mid = (w - hi).to(torch.bfloat16).float()
    lo = (w - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _w_terms(cb, cs, dt, qt, kt, l):
    """The three terms of W' of one (query tile, key tile) unit as 64 x 64
    matrices, formed on the accumulator fragment of C.B and placed where
    the A fragments put them."""
    s = cb[ACC_ROW, ACC_COL]                       # [thread, element]
    i = qt * TILE + ACC_ROW
    j = kt * TILE + ACC_COL
    keep = (j <= i) & (i < l)
    w = torch.where(keep, s * torch.exp(cs[i] - cs[j]) * dt[j],
                    torch.zeros(()))
    row, col = a_fragment_position(_T, PACK_KK, PACK_Q, PACK_HALF)
    terms = []
    for part in _split3(w):
        m = torch.zeros(TILE, TILE)
        m[row, col] = part
        terms.append(m)
    return terms


def emulate(x, dt, A, B, C):
    """The Hopper body in plain torch: x [N,l,h,p] and B, C [N,l,g,n] in
    bf16, dt [N,l,h] and A [h] fp32 -> y [N,l,h,p] fp32."""
    N, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    nq = -(-l // TILE)
    lp = nq * TILE

    def padded(t):                                 # TMA zero-fills past l
        z = torch.zeros((N, lp) + tuple(t.shape[2:]))
        z[:, :l] = t.float()
        return z

    xp, Bp, Cp = padded(x), padded(B), padded(C)
    cs_all = ref.cumsum_f32((dt * A).transpose(1, 2), -1)      # [N,h,l]
    parts = {}
    for _, w, cons, chunk, head, qt, kt in work(N, l, h):
        grp = head // hg
        qhi = nq - 1 - w // (N * h)
        l_end = min(l, (qhi + 1) * TILE)
        cs = torch.zeros(lp)
        dth = torch.zeros(lp)
        cs[:l_end] = cs_all[chunk, head, :l_end]
        dth[:l_end] = dt[chunk, :l_end, head]
        rows = slice(qt * TILE, qt * TILE + TILE)
        keys = slice(kt * TILE, kt * TILE + TILE)
        cb = Cp[chunk, rows, grp] @ Bp[chunk, keys, grp].T
        key = (chunk, head, qt, cons)
        acc = parts.get(key, torch.zeros(TILE, p))
        for term in _w_terms(cb, cs, dth, qt, kt, l):
            acc = acc + term @ xp[chunk, keys, head]
        parts[key] = acc
    y = torch.zeros(N, lp, h, p)
    for chunk in range(N):
        for head in range(h):
            for qt in range(nq):
                zero = torch.zeros(TILE, p)
                y[chunk, qt * TILE:(qt + 1) * TILE, head] = (
                    parts.get((chunk, head, qt, 0), zero)
                    + parts.get((chunk, head, qt, 1), zero))
    return y[:, :l]


def _inputs(N, l, h, p, g, n, seed):
    """numpy draws as tests/test_kernels.py draws them; x, B, C rounded to
    bf16 (float32 arrays holding bf16 values, for the JAX kernel)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, l, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((N, l, h), dtype=np.float32)))
    A = -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.3)
    B = rng.standard_normal((N, l, g, n), dtype=np.float32)
    C = rng.standard_normal((N, l, g, n), dtype=np.float32)
    x, B, C = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               for a in (x, B, C))
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


def _torch(data):
    x, dt, A, B, C = (torch.from_numpy(a) for a in data)
    return x.to(torch.bfloat16), dt, A, B.to(torch.bfloat16), \
        C.to(torch.bfloat16)


def test_w_fragments_land_where_the_accumulator_holds_them():
    """form_w packs accumulator element e of C.B into k-step e // 8,
    register ((e >> 2) % 2) 2 + ((e >> 1) & 1), half e & 1 of the A
    fragment: the entry (i, j) of W' lands at (i, j) of the product's A."""
    row, col = a_fragment_position(_T, PACK_KK, PACK_Q, PACK_HALF)
    assert torch.equal(row, ACC_ROW) and torch.equal(col, ACC_COL)
    # every entry of the 64 x 64 tile is held once
    flat = (ACC_ROW * TILE + ACC_COL).flatten()
    assert torch.equal(flat.sort().values, torch.arange(TILE * TILE))


# N, l, h: mamba2-370m's serve (a 128- and a 320-token prompt: 1 and 2
# chunks) and train step, jamba's chunk, ragged chunks of 1-4 tiles
WORK_SHAPES = [(1, 256, 32), (2, 256, 32), (8, 256, 32), (1, 256, 256),
               (3, 40, 4), (2, 100, 6), (1, 200, 4), (2, 192, 3),
               (1, 1, 2)]


@pytest.mark.parametrize("N,l,h", WORK_SHAPES)
def test_work_split_counts_every_causal_pair_once(N, l, h):
    """Across blocks and consumers every (query tile, key tile <= query
    tile) unit of every (chunk, head), and so every pair j <= i, is taken
    exactly once; consumer g takes the key tiles of parity g; the items
    are spread over at most 132 blocks."""
    nq = -(-l // TILE)
    units = work(N, l, h)
    seen = {}
    for _, _, _, chunk, head, qt, kt in units:
        seen[(chunk, head, qt, kt)] = seen.get((chunk, head, qt, kt), 0) + 1
    want = {(c, hh, qt, kt) for c in range(N) for hh in range(h)
            for qt in range(nq) for kt in range(qt + 1)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert all(kt % 2 == cons for _, _, cons, _, _, _, kt in units)
    blocks = {b for b, *_ in units}
    assert blocks == set(range(min(132, (nq + 1) // 2 * N * h)))


# N, l, h, p, g, n: full-size tiles at a few heads (one pair of 4 query
# tiles, state 128 and 16), groups of 2 and 3 heads, ragged chunks
EMU_CASES = [(1, 256, 2, 64, 1, 128), (2, 256, 2, 64, 1, 16),
             (1, 200, 4, 64, 2, 128), (3, 40, 2, 64, 1, 128),
             (2, 100, 6, 64, 2, 16), (1, 192, 3, 64, 1, 128),
             (1, 1, 2, 64, 1, 16)]


@pytest.mark.parametrize("N,l,h,p,g,n", EMU_CASES)
def test_emulated_body_matches_fp32_reference(N, l, h, p, g, n):
    x, dt, A, B, C = _torch(_inputs(N, l, h, p, g, n, seed=l + h + n))
    got = emulate(x, dt, A, B, C)
    want = ref.ssd_intra_chunk_ref(x, dt, A, B, C, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SSD_TOL,
                               atol=SSD_TOL)


def test_emulated_body_selects_before_the_product():
    """Decays so steep that exp above the diagonal is inf: the select
    keeps y finite, as the reference's."""
    x, dt, A, B, C = _torch(_inputs(1, 128, 2, 64, 1, 16, seed=3))
    dt = dt * 50
    A = A * 10
    got = emulate(x, dt, A, B, C)
    assert torch.isfinite(got).all()
    want = ref.ssd_intra_chunk_ref(x, dt, A, B, C, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SSD_TOL,
                               atol=SSD_TOL)


# chunks the JAX kernel takes whole: one pair of two tiles, a pair and a
# middle tile (192), and a ragged one
JAX_CASES = [(1, 128, 2, 64, 1, 128), (2, 192, 2, 64, 1, 16),
             (1, 100, 4, 64, 2, 16)]


@pytest.mark.parametrize("N,l,h,p,g,n", JAX_CASES)
def test_emulated_body_matches_jax_kernel(N, l, h, p, g, n):
    data = _inputs(N, l, h, p, g, n, seed=7 * l + n)
    got = emulate(*_torch(data))
    kern = jax_ssd(*[jnp.asarray(a) for a in data], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=SSD_TOL,
                               atol=SSD_TOL)


def _ssm_shapes(arch, use_reduced=False):
    """(N, l, h, p, g, n) of the SSD block at ``arch``'s serve prefills (a
    128- and a 320-token prompt, padded to whole chunks) and train step (8
    rows of one chunk)."""
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced_config(cfg)
    s = cfg.ssm
    h = s.n_heads(cfg.d_model)
    return [(N, s.chunk, h, s.head_dim, s.n_groups, s.d_state)
            for N in sorted({-(-128 // s.chunk), -(-320 // s.chunk), 8})]


@pytest.fixture(scope="module")
def plan_library(tmp_path_factory):
    """``csrc/ssd_plan.h`` built alone for the host: the C side's plan."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "no C++ compiler to build csrc/ssd_plan.h with"
    out = tmp_path_factory.mktemp("ssd_plan") / "libssd_plan.so"
    header = _build.CSRC / "ssd_plan.h"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x",
                    "c++", str(header), "-o", str(out)], check=True)
    return ctypes.CDLL(str(out))


@pytest.fixture
def host_plan(monkeypatch, plan_library):
    """``ssd.plan`` on the host-built rule, for a card of 132 SMs and the
    sm_90 opt-in shared memory."""
    monkeypatch.setattr(ssd, "_plan_entry",
                        lambda: ssd._bind_plan(plan_library))
    return functools.partial(ssd.plan, sms=132, smem_optin=SMEM)


@pytest.mark.parametrize("arch,body", [
    ("mamba2-370m", "wgmma"), ("jamba-1.5-large-398b", "wgmma")])
def test_plan_at_every_config_shape(host_plan, arch, body):
    """The main paths' shapes take the Hopper body in bf16, aligned; the
    same shapes in fp32 or off 16-byte alignment take the CUDA-core body;
    every plan's shared memory fits the opt-in."""
    for N, l, h, p, g, n in _ssm_shapes(arch):
        plan = host_plan(N, l, h, p, g, n)
        assert plan.body == body and 0 < plan.smem <= SMEM
        items = N * h * -(-(-(-l // TILE)) // 2)
        assert plan.grid == (min(items, 132), 1, 1)
        assert plan.heads_per_block == 1
        for dtype, aligned in ((torch.float32, True),
                               (torch.bfloat16, False)):
            other = host_plan(N, l, h, p, g, n, dtype, aligned)
            assert other.body == "fp32" and other.smem <= SMEM
            assert other.grid == (-(-l // 32), h, N)
            assert other.heads_per_block == 0


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_plan_of_reduced_configs_keeps_the_mma_body(host_plan, arch):
    """The reduced configs (head dim 16, state 16, chunks of 16) keep the
    mma.sync body in bf16 and the CUDA-core body in fp32."""
    for N, l, h, p, g, n in _ssm_shapes(arch, use_reduced=True):
        assert p == 16
        plan = host_plan(N, l, h, p, g, n)
        hb = 1 if (h // g) % 2 else 2
        assert plan.body == "mma" and plan.smem <= SMEM
        assert plan.grid == (-(-l // 64), h // hb, N)
        assert plan.heads_per_block == hb
        assert host_plan(N, l, h, p, g, n, torch.float32).body == "fp32"


@pytest.mark.parametrize("N,l,h,p,g,n,body", [
    (2, 256, 32, 64, 1, 128, "wgmma"), (1, 256, 256, 64, 1, 16, "wgmma"),
    (3, 40, 4, 64, 1, 128, "wgmma"), (2, 100, 6, 64, 2, 128, "wgmma"),
    (1, 200, 4, 128, 1, 64, "mma"), (1, 256, 4, 64, 1, 64, "mma"),
    (1, 257, 4, 64, 1, 128, "mma"), (2, 64, 8, 32, 2, 16, "mma"),
    (1, 512, 4, 128, 1, 256, "fp32")])
def test_plan_by_shape(host_plan, N, l, h, p, g, n, body):
    """Head dim 64 with state 16 or 128 and chunks up to 256 take the
    Hopper body; other aligned bf16 shapes the mma.sync body where its
    shared memory fits the card, else the CUDA-core body."""
    plan = host_plan(N, l, h, p, g, n)
    assert plan.body == body and plan.smem <= SMEM


def test_plan_follows_the_cards_limits(host_plan):
    """The Hopper body's grid is the card's SMs up to its work items; the
    mma.sync body needs its shared memory under the card's opt-in, else
    the call takes the CUDA-core body; a shape the kernel does not take
    has no plan."""
    assert host_plan(8, 256, 32, 64, 1, 128, sms=16).grid == (16, 1, 1)
    mma = host_plan(1, 512, 4, 128, 1, 64)
    assert mma.body == "mma"
    assert host_plan(1, 512, 4, 128, 1, 64,
                     smem_optin=mma.smem - 1).body == "fp32"
    assert host_plan(1, 640, 4, 128, 1, 64).body == "fp32"
    with pytest.raises(ValueError, match="no plan"):
        host_plan(1, 256, 6, 64, 4, 128)


def test_wgmma_shared_memory_is_the_sources(host_plan):
    """WgSsd<16> and WgSsd<128>: C tiles of two items, four ring stages,
    two merge buffers, dt and cs of two items, alignment, barriers."""
    assert host_plan(2, 256, 32, 64, 1, 128).smem == 201856
    assert host_plan(1, 256, 256, 64, 1, 16).smem == 87168


class _Stub:
    """The C entry point: records each call, writes ``plan`` (body, smem,
    grid x, y, z, heads a block) into the plan pointer and returns
    ``err``."""

    def __init__(self, err=0, plan=(2, 201856, 128, 1, 1, 1)):
        self.calls, self.err, self.plan = [], err, plan

    def __call__(self, *args):
        self.calls.append(args)
        args[-2][:] = self.plan
        return self.err


@pytest.fixture
def cpu_launch(monkeypatch):
    """``ssd._launch`` on CPU tensors: the device context, the stream and
    the kernel are stand-ins."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())

    def launch(stub, x, dt, A, B, C, out_dtype=torch.float32):
        monkeypatch.setattr(ssd, "_kernel", lambda: stub)
        out = torch.empty(x.shape, dtype=out_dtype)
        return ssd._launch(x, dt, A, B, C, out)

    return launch


def _views(N, l, h, p, g, n, off=0):
    """x, B, C as the model hands them over: views of one conv output,
    B and C ``off`` elements further on."""
    xbc = torch.zeros(N, l, h * p + 2 * g * n + off, dtype=torch.bfloat16)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    B = xbc[..., h * p + off:h * p + g * n + off].unflatten(-1, (g, n))
    C = xbc[..., h * p + g * n + off:].unflatten(-1, (g, n))
    return x, torch.zeros(N, l, h), torch.zeros(h), B, C


def test_launch_passes_one_plan_to_one_launch(cpu_launch):
    """One call of the C entry point a call, with the dtypes, the shape and
    the strides (the model's views of one conv output: row stride 2304);
    ``launches`` counts it, and ``body``, ``heads_per_block`` and
    ``launches_by_body`` take the plan the entry point reports."""
    stub = _Stub()
    N, l, h, p, g, n = 2, 256, 32, 64, 1, 128
    x, dt, A, B, C = _views(N, l, h, p, g, n)
    assert x.stride(1) == 2304
    before, by_body = ssd.launches, dict(ssd.launches_by_body)
    cpu_launch(stub, x, dt, A, B, C)
    assert ssd.launches == before + 1 and len(stub.calls) == 1
    assert ssd.launches_by_body == {**by_body,
                                    "wgmma": by_body["wgmma"] + 1}
    assert ssd.body == "wgmma" and ssd.heads_per_block == 1
    args = stub.calls[0]
    assert args[6:14] == (1, 0, N, l, h, p, g, n)
    assert args[14:23] == (*x.stride()[:3], *B.stride()[:3], *C.stride()[:3])
    assert isinstance(args[23], ctypes.Array) and len(args[23]) == 6
    assert args[24] == 7


@pytest.mark.parametrize("plan,body,hb", [
    ((0, 47104, 8, 32, 2, 0), "fp32", 0), ((1, 40960, 1, 4, 2, 2), "mma", 2)])
def test_launch_reports_the_body_the_entry_point_took(cpu_launch, plan,
                                                      body, hb):
    """Whatever body the entry point reports (the CUDA-core body of fp32
    or unaligned inputs, the mma.sync body with its heads a block) is what
    ``body``, ``heads_per_block`` and ``launches_by_body`` say."""
    x, dt, A, B, C = (t.float() for t in _views(2, 256, 32, 64, 1, 128, 1))
    by_body = dict(ssd.launches_by_body)
    cpu_launch(_Stub(plan=plan), x, dt, A, B, C)
    assert ssd.body == body and ssd.heads_per_block == hb
    assert ssd.launches_by_body == {**by_body, body: by_body[body] + 1}


def test_launch_raises_on_a_refused_tensor_map(cpu_launch):
    """No fallback: a negative return (the tensor maps could not be
    encoded) or a CUDA error (a refused launch or shared-memory size)
    raises, and nothing is counted."""
    x, dt, A, B, C = _views(1, 256, 256, 64, 1, 16)
    before = (ssd.launches, dict(ssd.launches_by_body), ssd.body)
    for err, text in ((-2, "tensor maps"), (-1, "cuTensorMapEncodeTiled"),
                      (1, "CUDA error 1")):
        with pytest.raises(RuntimeError, match=text):
            cpu_launch(_Stub(err=err), x, dt, A, B, C)
    assert (ssd.launches, ssd.launches_by_body, ssd.body) == before
