"""Sharded attention (``models/attention.py::_attention_on_shards``) on the
CPU: each device runs its share of the batch, heads, rows or keys.

* Counts, over ``"fake"`` process groups (the dry-run's ``CostCounter``):
  ``chunked_attention`` on DTensor shards where the tensor axis divides
  the query heads but not the KV heads ("heads"), where it does not
  divide the heads ("rows": each device a contiguous 1 / n of the query
  rows; padded where n does not divide them; cross attention; the banded
  path; MLA's narrower value heads), where it divides a data device's
  rows ("batch"), and for decode (heads split, the cache's time axis over
  the data axis or not): each device's FLOPs of the two attention
  products are the unsharded count / n, written out by hand below.  The
  reduced llsc-100m prefill and train step with 4 heads over 2 KV heads,
  and with 6 heads, on a (2, 4) mesh: the attention products divide by
  the 8 devices, and so does every product of the prefill.  A decode
  step whose heads the tensor axis does not divide stays whole on every
  device of it (one row cannot be split).
* Against the reference's dry-run: the same reduced prefill, train step
  and a decode step on a (2, 4) mesh, per-device FLOPs within 0.8-1.0 of
  XLA's ``cost_analysis`` on 8 host devices (a subprocess).
* Values, on gloo ranks (each its own process, as
  ``tests/test_torch_moe_a2a.py`` runs them): under ``hint_context`` on a
  (1, 4) mesh, the prefill's hidden states and logits and the loss and
  gradients of ``loss_and_grads`` equal the same model's in one process
  within 1e-5 (fp32), for 4 heads over 2 KV heads, 6 heads over 2 (by
  rows, and by batch at 4 rows), and reduced gemma3-1b with 2 heads on
  its banded path; so does one decode step of the first, its cache's
  heads replicated, its time axis over the tensor axis
  (``decode_cache_seq_shard``), and on a (2, 2) mesh with one row (the
  time axis over data); and decode attention of 4 rows of ragged lengths
  split by batch, each row's offset with its row.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeSpec, reduced_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import (NamedSharding,  # noqa: E402
                                         hint_context)
from repro_torch.models import attention as attn_mod  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _products(b, rows, keys, heads, d, dv):
    """FLOPs of the scores (q k^T) and the values' product (p v) of ``b``
    rows of ``rows`` queries against ``keys`` keys, over ``heads`` heads."""
    return 2 * b * rows * keys * heads * (d + dv)


# id -> (mesh, B, Sq, Skv, H, Hk, D, Dv, chunked_attention's keywords, q's
# spec, K's and V's spec, (b, rows, keys, heads) a device counts)
CASES = {
    # 4 heads over model 4, 2 KV heads (granite's 16 and 8 over 16)
    "heads-kv-replicated": ((2, 4), 4, 64, 64, 4, 2, 16, 16, {},
                            ("data", None, "model", None),
                            ("data", None, None, None), (2, 64, 64, 1)),
    # 6 heads over model 4 (whisper's 8, qwen1.5's 20 over 16)
    "rows": ((2, 4), 4, 64, 64, 6, 2, 16, 16, {},
             ("data", None, None, None), ("data", None, None, None),
             (2, 16, 64, 6)),
    # 4 heads over model 8 (gemma3's 4 over 16)
    "rows-1x8": ((1, 8), 4, 64, 64, 4, 4, 16, 16, {},
                 ("data", None, None, None), ("data", None, None, None),
                 (4, 8, 64, 4)),
    # whisper's encoder and cross attention: 50 rows over 4 are 13 a device
    "rows-uneven-cross": ((2, 4), 4, 50, 24, 6, 6, 16, 16,
                          {"causal": False},
                          ("data", None, None, None),
                          ("data", None, None, None), (2, 13, 24, 6)),
    # a device's 16 rows are one chunk and read its band of 16 + 16 keys
    "rows-banded": ((2, 4), 4, 64, 64, 6, 2, 16, 16,
                    {"window": 8, "banded": True},
                    ("data", None, None, None), ("data", None, None, None),
                    (2, 16, 32, 6)),
    # MLA: query and key heads of 24, value heads of 8
    "rows-mla": ((2, 4), 4, 64, 64, 6, 6, 24, 8, {},
                 ("data", None, None, None), ("data", None, None, None),
                 (2, 16, 64, 6)),
    # 8 rows a data device: each device 2 of them, every head
    "batch": ((2, 4), 16, 64, 64, 6, 2, 16, 16, {},
              ("data", None, None, None), ("data", None, None, None),
              (2, 64, 64, 6)),
    "decode-heads": ((2, 4), 4, 1, 64, 4, 2, 16, 16, {"decode": 40},
                     ("data", None, "model", None),
                     ("data", None, None, None), (2, 1, 64, 1)),
    # one row: the cache's time axis over data (context-parallel decode)
    "decode-context-parallel": ((2, 4), 1, 1, 64, 4, 2, 16, 16,
                                {"decode": 40}, (None, None, "model", None),
                                (None, "data", None, None), (1, 1, 32, 1)),
}


def _count(case):
    """FLOPs a device of ``chunked_attention`` on the DTensor shards of
    ``case`` (a value of CASES), counted by the dry-run's
    ``CostCounter``."""
    from torch.distributed.tensor.experimental import implicit_replication

    shape, B, Sq, Skv, H, Hk, D, Dv, kw, q_spec, kv_spec, _ = case
    kw = dict(kw)
    decode = kw.pop("decode", None)
    with dryrun.fake_group(shape[0] * shape[1]):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        counter = dryrun.CostCounter()
        q, k, v = counter.shard(
            (_meta(B, Sq, H, D), _meta(B, Skv, Hk, D), _meta(B, Skv, Hk, Dv)),
            (NamedSharding(mesh, q_spec), NamedSharding(mesh, kv_spec),
             NamedSharding(mesh, kv_spec)))
        if decode is not None:
            kw.update(q_offset=torch.tensor(decode),
                      kv_valid_len=torch.tensor(decode + 1))
        with hint_context(mesh), implicit_replication(), counter:
            out = attn_mod.chunked_attention(q, k, v, chunk=16, **kw)
        assert out.shape == (B, Sq, H, Dv)
    return counter.flops


@pytest.mark.parametrize("case", list(CASES))
def test_attention_counts_each_devices_share(case):
    """Before the split each device counted every head: 4x (6x, 50/13x
    for the uneven rows) these counts."""
    *_, D, Dv, _, _, _, (b, rows, keys, heads) = CASES[case]
    assert _count(CASES[case]) == _products(b, rows, keys, heads, D, Dv)


def test_a_decode_step_whose_heads_do_not_divide_stays_whole(monkeypatch):
    """6 heads over model 4, one row: no share to split, so each device
    runs every head as DTensor does, and no split is made."""
    case = ((2, 4), 4, 1, 64, 6, 2, 16, 16, {"decode": 40},
            ("data", None, None, None), ("data", None, None, None), None)
    calls = []
    monkeypatch.setattr(attn_mod, "_attention_on_shards",
                        lambda *a, **kw: calls.append(a))
    assert _count(case) == _products(2, 1, 64, 6, 16, 16)
    assert calls == []


@pytest.mark.parametrize("mask", [
    dict(causal=True, window=None, softcap=None, valid=None),
    dict(causal=True, window=5, softcap=None, valid=None),
    dict(causal=False, window=None, softcap=30.0, valid=None),
    dict(causal=True, window=None, softcap=None, valid=[40, 7]),
], ids=["causal", "window", "softcap", "valid-len"])
def test_the_reduce_softmax_equals_torch_softmax_on_one_device(mask):
    """``_attend_block``'s softmax spelled out for keys shared over devices
    (``reduce=``) is, with nothing to reduce, ``torch.softmax``'s, which
    the one-card path keeps: the two paths stay tied to 1e-6."""
    rng = np.random.default_rng(7)
    qc, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                for s in ((2, 8, 2, 3, 16), (2, 48, 2, 16), (2, 48, 2, 16)))
    q_pos, kv_pos = torch.arange(32, 40), torch.arange(48)
    valid = mask["valid"] and torch.tensor(mask["valid"])
    kw = dict(causal=mask["causal"], window=mask["window"],
              kv_valid_len=valid, softcap=mask["softcap"], scale=0.25)
    want = attn_mod._attend_block(qc, k, v, q_pos, kv_pos, **kw)
    got = attn_mod._attend_block(qc, k, v, q_pos, kv_pos,
                                 reduce=lambda t, op: t, **kw)
    assert got.shape == want.shape == (2, 8, 2, 3, 16)
    assert float((got - want).abs().max()) <= 1e-6


class _AttentionCounter(dryrun.CostCounter):
    """``CostCounter`` that also keeps the FLOPs of ``bmm``, which in the
    dense model only the attention products reach (the projections, the
    MLP and the logits are ``mm``)."""

    def __init__(self):
        super().__init__()
        self.attention = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func._overloadpacket is torch.ops.aten.bmm:
            self.attention += self.flops - before
        return out


def _reduced_llsc(H, Hk, kind, monkeypatch):
    """The counter of reduced llsc-100m (one layer, d 64, heads of 16, d_ff
    128, tied vocab 512, fp32) with H heads over Hk KV heads at B 4, S 32
    on a (2, 4) mesh."""
    cfg = dataclasses.replace(reduced_config("llsc-100m"), n_heads=H,
                              n_kv_heads=Hk)
    monkeypatch.setattr(dryrun, "CostCounter", _AttentionCounter)
    with dryrun.fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        return dryrun.count_cell(cfg, ShapeSpec("t", 32, 4, kind), mesh)


HEADS = [(4, 2), (6, 2)]


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("heads", HEADS, ids=["4-over-2", "6"])
def test_reduced_llsc_attention_products_divide_over_8_devices(
        kind, heads, monkeypatch):
    """The attention products of the prefill, and of the train step's
    forward and backward (3x), are the unsharded count / 8: before the
    split 4x these."""
    H, Hk = heads
    counter = _reduced_llsc(H, Hk, kind, monkeypatch)
    passes = 1 if kind == "prefill" else 3
    assert counter.attention == passes * _products(4, 32, 32, H, 16, 16) // 8


@pytest.mark.parametrize("heads", HEADS, ids=["4-over-2", "6"])
def test_reduced_llsc_prefill_counts_every_product_over_8_devices(
        heads, monkeypatch):
    """Every matrix product of the prefill divides by the 8 devices: the
    layer and the last position's logits."""
    H, Hk = heads
    B, S, d, Dh, F, V = 4, 32, 64, 16, 128, 512
    T = B * S
    layer = (2 * T * d * (H + 2 * Hk) * Dh + 2 * T * H * Dh * d
             + 3 * 2 * T * d * F + _products(B, S, S, H, Dh, Dh))
    counter = _reduced_llsc(H, Hk, "prefill", monkeypatch)
    assert counter.flops == (layer + 2 * B * d * V) // 8


REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax, numpy as np
from repro.configs import reduced_config
from repro.configs.shapes import ShapeSpec
from repro.launch import dryrun

mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                         ("data", "model"))
out = {}
for tag in %r:
    H, Hk, kind, S = tag.split("/")
    cfg = dataclasses.replace(reduced_config("llsc-100m"), n_heads=int(H),
                              n_kv_heads=int(Hk))
    out[tag] = dryrun._extract_cost(dryrun._compile_cell(
        cfg, ShapeSpec("t", int(S), 8, kind), mesh, unroll=True))["flops"]
print("REF " + json.dumps(out))
"""

# H/Hk/kind/S at batch 8 on a (2, 4) mesh
AGAINST_REFERENCE = ["4/2/prefill/64", "6/2/prefill/64", "4/2/decode/256",
                     "4/2/train/64", "6/2/train/64"]


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE % (AGAINST_REFERENCE,)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(ln for ln in res.stdout.splitlines() if ln.startswith("REF "))
    return json.loads(line[len("REF "):])


@pytest.mark.parametrize("tag", AGAINST_REFERENCE)
def test_flops_against_the_references_on_a_2x4_mesh(reference, tag):
    """Reduced llsc-100m with H heads over Hk KV heads against the
    reference's XLA count on 8 host devices, which splits the attention
    at these widths: port / reference within [0.8, 1.0], as
    ``test_torch_dryrun.py`` holds the (2, 2) mesh (XLA also counts
    elementwise work).  Before the split: 1.40, 1.49, 1.80, 1.30, 1.41."""
    H, Hk, kind, S = tag.split("/")
    cfg = dataclasses.replace(reduced_config("llsc-100m"), n_heads=int(H),
                              n_kv_heads=int(Hk))
    with dryrun.fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        port = dryrun.probe_costs(cfg, ShapeSpec("t", int(S), 8, kind),
                                  mesh)["flops"]
    ratio = port / reference[tag]
    print(f"{tag}: port {port:.0f} reference {reference[tag]:.0f} "
          f"({ratio:.4f})")
    assert 0.8 <= ratio <= 1.0


# --------------------------------------------------------------------------
# values on gloo ranks
# --------------------------------------------------------------------------

WORKER = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist

rank, world, store, out_path = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_flatten, tree_map
from repro_torch.configs import reduced_config
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_lib
from repro_torch.models.perf_flags import PerfFlags, perf_flags
from repro_torch.train.train_step import loss_and_grads

splits = []
real = attn_mod._attention_on_shards
def recorded(q, k, v, q_offset, kv_valid_len, shares, **kw):
    # the tensor axis's split, named by what it shares out to each device
    p = shares.q[shares.tp]
    split = ("time" if shares.tp in shares.key_dims
             else {0: "batch", 1: "rows", 2: "heads"}[p.dim])
    splits.append((split, bool(shares.key_dims)))
    return real(q, k, v, q_offset, kv_valid_len, shares, **kw)
attn_mod._attention_on_shards = recorded


def shard(tree, shardings):
    leaves, spec = tree_flatten(tree)
    shs, _ = tree_flatten(shardings, is_leaf=lambda s: isinstance(
        s, sharding.NamedSharding))
    return spec.unflatten([distribute_tensor(t, s.mesh, s.placements)
                           for t, s in zip(leaves, shs)])


def gap(a, b):
    a, b = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(a) == len(b)
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    return max(float((whole(x) - y).abs().max()) for x, y in zip(a, b))


llsc = reduced_config("llsc-100m")
six = dataclasses.replace(llsc, n_heads=6, n_kv_heads=2)
CASES = {   # name -> (config, banded, rows, the split the tensor axis makes)
    "4-over-2": (dataclasses.replace(llsc, n_kv_heads=2), False, 2, "heads"),
    "6": (six, False, 2, "rows"),
    "6-batch": (six, False, 4, "batch"),
    "gemma3-banded": (dataclasses.replace(reduced_config("gemma3-1b"),
                                          n_heads=2, n_kv_heads=1),
                      True, 2, "rows"),
}
S, T, LEN = 64, 64, 40
res = {}
mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
for name, (cfg, banded, B, split) in CASES.items():
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    batch = {"tokens": tokens,
             "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    with torch.no_grad():
        hidden = model_lib.forward_hidden(params, cfg, tokens,
                                          banded=banded)[0]
        logits = model_lib.prefill(params, cfg, tokens)[0]
    loss, grads = loss_and_grads(params, cfg, batch, banded=banded)
    dparams = shard(params, sharding.param_shardings(mesh, params))
    dbatch = shard(batch, sharding.batch_shardings(mesh, batch))
    del splits[:]
    with sharding.hint_context(mesh), implicit_replication():
        with torch.no_grad():
            res[name + "/hidden"] = gap(model_lib.forward_hidden(
                dparams, cfg, dbatch["tokens"], banded=banded)[0], hidden)
            res[name + "/logits"] = gap(model_lib.prefill(
                dparams, cfg, dbatch["tokens"])[0], logits)
        dloss, dgrads = loss_and_grads(dparams, cfg, dbatch, banded=banded)
    res[name + "/loss"] = gap(dloss, loss)
    res[name + "/grads"] = gap(dgrads, grads)
    assert splits and {s for s, _ in splits} == {split}, (name, splits)

# one decode step of 4 heads over 2 KV heads, the cache filled at random
cfg = CASES["4-over-2"][0]
params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
for name, shape, rows, flags, split in (
        ("decode", (1, 4), 2, PerfFlags(), ("heads", False)),
        ("decode-time-over-model", (1, 4), 2,
         PerfFlags(decode_cache_seq_shard=True), ("time", True)),
        ("decode-context-parallel", (2, 2), 1, PerfFlags(),
         ("heads", True))):
    g = torch.Generator().manual_seed(2)
    caches = tree_map(lambda t: torch.randn(t.shape, generator=g),
                      model_lib.init_cache(cfg, rows, T, device="cpu"))
    token = torch.randint(0, cfg.vocab_size, (rows, 1), generator=g)
    length = torch.tensor(LEN)
    want = tree_map(torch.clone, caches)
    with torch.no_grad():
        logits = model_lib.decode_step(params, cfg, token, want, length)[0]
    m = make_mesh(shape, ("data", "model"), device="cpu")
    with perf_flags(flags):
        dcaches = shard(caches, sharding.cache_shardings(m, caches))
    dparams = shard(params, sharding.param_shardings(m, params))
    dtoken = shard(token, sharding.batch_shardings(m, token))
    dlength = distribute_tensor(length, m, sharding.NamedSharding(
        m, ()).placements)
    del splits[:]
    with perf_flags(flags), sharding.hint_context(m), \
            implicit_replication(), torch.no_grad():
        dlogits = model_lib.decode_step(dparams, cfg, dtoken, dcaches,
                                        dlength)[0]
    res[name + "/logits"] = gap(dlogits, logits)
    res[name + "/caches"] = gap(dcaches, want)
    assert set(splits) == {split}, (name, splits)
# decode attention of 4 rows of ragged lengths (the engine's slots), split
# by batch: each row's offset and valid length go with its row
g = torch.Generator().manual_seed(3)
q, k, v = (torch.randn(s, generator=g) for s in
           ((4, 1, 6, 16), (4, T, 2, 16), (4, T, 2, 16)))
length = torch.tensor([LEN, 12, 63, 0])
kw = dict(q_offset=length, kv_valid_len=length + 1)
want = attn_mod.chunked_attention(q, k, v, **kw)
spec = sharding.NamedSharding(mesh, ("data",))
dq, dk, dv = (shard(t, spec) for t in (q, k, v))
del splits[:]
with sharding.hint_context(mesh), implicit_replication():
    got = attn_mod.chunked_attention(dq, dk, dv, q_offset=shard(
        length, spec), kv_valid_len=shard(length + 1, spec))
res["decode-batch-ragged/out"] = gap(got, want)
assert splits == [("batch", False)], splits
if rank == 0:
    with open(out_path, "w") as f:
        json.dump(res, f)
dist.destroy_process_group()
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")


@pytest.fixture(scope="module")
def gaps(tmp_path_factory):
    """The 4 ranks' largest gaps to the one-process model, by quantity;
    the ranks must finish within 240 s."""
    tmp = tmp_path_factory.mktemp("sharded_attention")
    world = 4
    logs = [open(tmp / f"rank-{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(tmp / "store"),
         str(tmp / "gaps.json")], env=_env(), cwd=REPO, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + 240
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [(r, p.returncode, (tmp / f"rank-{r}.log").read_text()[-3000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, bad[0]
    return json.loads((tmp / "gaps.json").read_text())


@pytest.mark.parametrize("case", ["4-over-2", "6", "6-batch",
                                  "gemma3-banded"])
@pytest.mark.parametrize("what", ["hidden", "logits", "loss", "grads"])
def test_sharded_prefill_and_gradients_match_one_process(gaps, case, what):
    assert gaps[f"{case}/{what}"] < TOL


@pytest.mark.parametrize("case", ["decode", "decode-time-over-model",
                                  "decode-context-parallel"])
@pytest.mark.parametrize("what", ["logits", "caches"])
def test_a_sharded_decode_step_matches_one_process(gaps, case, what):
    assert gaps[f"{case}/{what}"] < TOL


def test_ragged_decode_attention_split_by_batch_matches_one_process(gaps):
    assert gaps["decode-batch-ragged/out"] < TOL
