"""The port's multi-rank pieces on gloo CPU ranks, against the JAX package.

* The all-to-all MoE (``models/moe_a2a.py``) on 8 ranks, meshes (data 2,
  model 4) and (1, 8), 8 experts top-2 over x [4, 8, 16]: at capacity
  factor 8.0 (nothing drops) the output and the gradients of sum(out**2)
  lie within 2e-4 of the reference's ``moe_ffn_dense_reference``; at 1.0
  (tokens drop at both capacity stages) within 2e-4 of the reference's own
  ``moe_ffn_a2a`` run under ``jax.set_mesh`` on 8 host devices.  The
  reference runs in a subprocess (XLA locks its device count at first
  use); ``moe_ffn`` routes to the all-to-all under the ``moe_a2a`` flag
  with a mesh in the hint context, and a DTensor input gives a DTensor.
* ``shard_hint`` on a 4-rank mesh redistributes a DTensor to its hint
  (cut to the tensor's rank) and returns a plain tensor unchanged.
* ``restore_checkpoint(shardings=)`` round-trips reduced llsc-100m's train
  state onto (4, 1) and (2, 2) meshes: every leaf a DTensor with
  ``param_shardings``' placements, whose ``full_tensor()`` is the saved
  leaf.

Each rank is a process of its own; a group of ranks meets through a
``FileStore`` in the test's ``tmp_path`` and must finish within 120 s, so
that a hung collective fails its test and nothing else.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
TOL = 2e-4
MESHES = ((2, 4), (1, 8))
NAMES = ("router", "w1", "w3", "w2")

JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import MoESpec
from repro.models.moe import init_moe, moe_ffn_dense_reference
from repro.models.moe_a2a import moe_ffn_a2a

spec = MoESpec(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=8.0)
params = init_moe(jax.random.PRNGKey(0), 16, spec)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 16))
out = {"x": x, **{"p_" + k: v for k, v in params.items()}}
f = lambda p: moe_ffn_dense_reference(p, x, spec)
out["dense"] = f(params)
for k, g in jax.grad(lambda p: jnp.sum(f(p) ** 2))(params).items():
    out["dense_g_" + k] = g
for shape in [(2, 4), (1, 8)]:
    mesh = jax.make_mesh(shape, ("data", "model"))
    for cf in (8.0, 1.0):
        s = dataclasses.replace(spec, capacity_factor=cf)
        fa = lambda p: moe_ffn_a2a(p, x, s, "swiglu", mesh,
                                   fsdp_axes=("data",))
        with jax.set_mesh(mesh):
            tag = f"{shape[0]}x{shape[1]}_{cf}"
            out["a2a_" + tag] = jax.jit(fa)(params)
            grads = jax.jit(jax.grad(lambda p: jnp.sum(fa(p) ** 2)))(params)
        for k, g in grads.items():
            out[f"a2a_g_{k}_{tag}"] = g
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""

WORKER = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist

mode, rank, world, store, out_dir = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import sharding_hints as sh


def a2a():
    from repro_torch.configs.base import MoESpec
    from repro_torch.models import moe
    from repro_torch.models.moe_a2a import moe_ffn_a2a, transport
    from repro_torch.models.perf_flags import PerfFlags, perf_flags

    ref = np.load(f"{out_dir}/ref.npz")
    x = torch.from_numpy(ref["x"])
    params = {k: torch.from_numpy(ref["p_" + k]) for k in
              ("router", "w1", "w3", "w2")}
    spec8 = MoESpec(n_experts=8, top_k=2, d_ff_expert=32,
                    capacity_factor=8.0)
    res = {}
    for shape in [(2, 4), (1, 8)]:
        m = mesh_lib.make_mesh(shape, ("data", "model"), device="cpu")
        assert transport(m.get_group("model"), "cpu") == "direct"
        for cf in (8.0, 1.0):
            spec = dataclasses.replace(spec8, capacity_factor=cf)
            tag = f"{shape[0]}x{shape[1]}_{cf}"
            p = {k: v.clone().requires_grad_() for k, v in params.items()}
            y = moe_ffn_a2a(p, x, spec, "swiglu", m, fsdp_axes=("data",))
            (y ** 2).sum().backward()
            res["a2a_" + tag] = y.detach().numpy()
            for k, v in p.items():
                res[f"a2a_g_{k}_{tag}"] = v.grad.numpy()
            # moe_ffn takes the same route under the flag and a mesh
            with perf_flags(PerfFlags(moe_a2a=True)), \
                    sharding.hint_context(m), torch.no_grad():
                routed = moe.moe_ffn(params, x, spec)
            assert torch.equal(routed, y.detach()), tag
            # a DTensor in gives a DTensor out, sharded (fsdp, tp, None)
            xd = distribute_tensor(x, m, [Replicate(), Replicate()])
            with torch.no_grad():
                yd = moe_ffn_a2a(params, xd, spec, "swiglu", m,
                                 fsdp_axes=("data",))
            assert isinstance(yd, DTensor)
            assert tuple(yd.placements) == (Shard(0), Shard(1))
            assert torch.equal(yd.full_tensor(), y.detach()), tag
    if rank == 0:
        np.savez(f"{out_dir}/port.npz", **res)


def hints():
    m = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
    x = distribute_tensor(torch.arange(4 * 8 * 16, dtype=torch.float32)
                          .reshape(4, 8, 16), m, [Replicate(), Replicate()])
    plain = torch.ones(4, 8, 16)
    assert sh.shard_hint(x, "activation") is x         # no context
    with sharding.hint_context(m):                     # activation_hints
        y = sh.shard_hint(x, "activation")
        assert tuple(y.placements) == (Shard(0), Replicate())
        # "moe_dispatch" is written for [G, E, C, d]: cut to 3 dims
        z = sh.shard_hint(x, "moe_dispatch")
        assert tuple(z.placements) == (Shard(0), Shard(1))
        assert sh.shard_hint(plain, "activation") is plain
        assert sh.shard_hint(x, "no_such_hint") is x
    with sh.hint_context({"activation": ("data", "model", None)}, m):
        w = sh.shard_hint(x, "activation")
        assert tuple(w.placements) == (Shard(0), Shard(1))
        assert w.to_local().shape == (2, 4, 16)
    for t in (y, z, w):
        assert torch.equal(t.full_tensor(), x.full_tensor())
    assert sh.current_hints() is None


def restore():
    from repro_torch.configs import reduced_config
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import train_step as ts

    cfg = reduced_config("llsc-100m")
    ocfg = ts.default_opt_cfg(cfg)
    state = ts.init_train_state(cfg, torch.Generator().manual_seed(0), ocfg,
                                device="cpu")
    if rank == 0:
        ck.save_checkpoint(f"{out_dir}/ckpt", 3, state)
    dist.barrier()
    template = ts.init_train_state_shape(cfg, ocfg)
    want = ck._flatten(state)
    host = mesh_lib.make_host_mesh(device="cpu")
    assert mesh_lib.mesh_shape(host) == {"data": world, "model": 1}
    for m in (host, mesh_lib.make_mesh((2, 2), ("data", "model"),
                                       device="cpu")):
        shardings = sharding.param_shardings(m, template)
        got, meta = ck.restore_checkpoint(f"{out_dir}/ckpt", 3, template,
                                          shardings, device="cpu")
        assert meta["step"] == 3 and got.opt.step == state.opt.step
        n_split = 0
        flat_got = _tensors(got)
        flat_sh = _tensors(shardings)
        for key, t in flat_got.items():
            assert isinstance(t, DTensor), key
            assert tuple(t.placements) == flat_sh[key].placements, key
            assert np.array_equal(t.full_tensor().numpy(), want[key]), key
            n_split += t.to_local().numel() < t.numel()
        assert n_split > 0


def _tensors(node, key=""):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        out = {}
        for f in node._fields:
            out.update(_tensors(getattr(node, f), f"{key}.{f}"))
        return out
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_tensors(v, f"{key}[{k!r}]"))
        return out
    if isinstance(node, (torch.Tensor, sharding.NamedSharding)):
        return {key: node}
    return {}


{"a2a": a2a, "hints": hints, "restore": restore}[mode]()
dist.destroy_process_group()
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")


def _run_ranks(mode, world, tmp_path, timeout=120):
    """``world`` ranks of WORKER's ``mode``, each its own process; all must
    exit 0 within ``timeout`` seconds."""
    logs = [open(tmp_path / f"{mode}-{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, mode, str(r), str(world),
         str(tmp_path / f"{mode}-store"), str(tmp_path)],
        env=_env(), cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
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
    bad = [(r, p.returncode, (tmp_path / f"{mode}-{r}.log").read_text()
            [-2000:]) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, bad[0]


@pytest.fixture(scope="module")
def a2a_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("a2a")
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                          str(tmp / "ref.npz")], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    _run_ranks("a2a", 8, tmp)
    return dict(np.load(tmp / "ref.npz")), dict(np.load(tmp / "port.npz"))


def _gap(a, b):
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "1x8"])
def test_a2a_at_ample_capacity_matches_the_dense_reference(a2a_results,
                                                           shape):
    ref, port = a2a_results
    tag = f"{shape[0]}x{shape[1]}_8.0"
    assert _gap(port["a2a_" + tag], ref["dense"]) < TOL
    for k in NAMES:
        assert _gap(port[f"a2a_g_{k}_{tag}"], ref["dense_g_" + k]) < TOL, k


@pytest.mark.parametrize("shape", MESHES, ids=["2x4", "1x8"])
def test_a2a_at_capacity_1_matches_the_reference_a2a(a2a_results, shape):
    """Drops included: the reference's own all-to-all differs from the
    dense oracle here, and the port's follows it."""
    ref, port = a2a_results
    tag = f"{shape[0]}x{shape[1]}_1.0"
    assert _gap(ref["a2a_" + tag], ref["dense"]) > 1e-2      # tokens drop
    assert _gap(port["a2a_" + tag], ref["a2a_" + tag]) < TOL
    for k in NAMES:
        assert _gap(port[f"a2a_g_{k}_{tag}"],
                    ref[f"a2a_g_{k}_{tag}"]) < TOL, k


def test_a2a_applicable():
    from repro_torch.configs.base import MoESpec
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.moe_a2a import a2a_applicable

    spec = MoESpec(n_experts=8, top_k=2, d_ff_expert=32)
    m = MeshSpec({"data": 2, "model": 4})
    assert a2a_applicable((4, 8, 16), spec, m)
    assert not a2a_applicable((4, 6, 16), spec, m)          # S % tp
    assert not a2a_applicable((4, 8, 16), spec, None)
    assert not a2a_applicable((4, 8, 16), spec, MeshSpec({"data": 8}))
    assert not a2a_applicable((4, 8, 16), spec,
                              MeshSpec({"data": 1, "model": 16}))


def test_shard_hint_redistributes_a_dtensor(tmp_path):
    _run_ranks("hints", 4, tmp_path)


def test_shard_hint_outside_a_mesh_is_the_identity():
    from repro_torch.models import sharding_hints as sh

    x = torch.ones(2, 3)
    assert sh.shard_hint(x, "activation") is x
    with sh.hint_context({"activation": ("data", None)}):   # no mesh
        assert sh.shard_hint(x, "activation") is x
        assert sh.current_hints() == (None, {"activation": ("data", None)})
    assert sh.current_hints() is None


def test_restore_checkpoint_with_shardings_round_trips(tmp_path):
    _run_ranks("restore", 4, tmp_path)
