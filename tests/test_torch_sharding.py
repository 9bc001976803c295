"""The port's sharding layer against the JAX package's, on the CPU.

One subprocess with 512 host devices (``--xla_force_host_platform_
device_count``: the main pytest process keeps one) prints the reference's
specs as JSON for every ``ASSIGNED`` arch, on both production meshes, with
each of ``moe_fsdp_tp``, ``decode_cache_seq_shard`` and
``sequence_parallel`` on alone and with all off: ``param_shardings`` over
the train state (``init_train_state_shape``: the parameters and AdamW's
moments and step), ``batch_shardings`` over token, label and frontend
batches of 256, 32, 128 and 1 rows, ``cache_shardings`` over
``cache_struct`` at (128, 32768), (8, 4096) and (1, 524288), and
``activation_hints``.  The port's specs, over its own meta-device trees,
equal them leaf for leaf.  Also: ``ASSIGNED``, ``init_params_shape`` and
``cache_struct`` against the reference's ``eval_shape`` trees, the mesh
helpers on both kinds of mesh, and ``to_placements``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.archs import ASSIGNED as JAX_ASSIGNED  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.archs import ASSIGNED  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.perf_flags import PerfFlags, perf_flags  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FLAGS = ("", "moe_fsdp_tp", "decode_cache_seq_shard", "sequence_parallel")
BATCH_ROWS = (256, 32, 128, 1)
CACHES = ((128, 32768), (8, 4096), (1, 524288))

# Walks a tree of dicts and NamedTuples with "/"-joined keys: the same
# paths on both sides.
_WALK = r"""
def walk(node, fn, path=""):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(walk(v, fn, f"{path}/{k}"))
        return out
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        out = {}
        for f in node._fields:
            out.update(walk(getattr(node, f), fn, f"{path}/{f}"))
        return out
    return {path: fn(node)}


def frontend_len(cfg):
    if cfg.frontend == "patch_stub":
        return cfg.frontend_len
    if cfg.frontend == "audio_stub":
        return cfg.encoder.source_len
    return 0


def batch_shapes(cfg, B):
    out = {"tokens": (B, 64), "labels": (B, 64)}
    if frontend_len(cfg):
        out["frontend"] = (B, frontend_len(cfg), cfg.d_model)
    return out
"""
exec(_WALK)

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import sys
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.configs.archs import ASSIGNED
from repro.launch.mesh import make_production_mesh
from repro.launch.sharding import (activation_hints, batch_shardings,
                                   cache_shardings, param_shardings)
from repro.models.model import cache_struct
from repro.models.perf_flags import PerfFlags, perf_flags
from repro.train.train_step import default_opt_cfg, init_train_state_shape
""" + _WALK + r"""
FLAGS, BATCH_ROWS, CACHES = json.loads(sys.argv[1])


def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s.spec)]


out = {}
meshes = {"single-pod": make_production_mesh(),
          "multi-pod": make_production_mesh(multi_pod=True)}
for arch in ASSIGNED:
    cfg = get_config(arch)
    state = init_train_state_shape(cfg, default_opt_cfg(cfg))
    caches = {f"{B}x{T}": cache_struct(cfg, B, T) for B, T in CACHES}
    batches = {str(B): {k: jax.ShapeDtypeStruct(s, jnp.int32)
                        for k, s in batch_shapes(cfg, B).items()}
               for B in BATCH_ROWS}
    for mname, m in meshes.items():
        for flag in FLAGS:
            flags = PerfFlags(**({flag: True} if flag else {}))
            with perf_flags(flags):
                out[f"{arch}|{mname}|{flag}"] = {
                    "state": walk(param_shardings(m, state), spec),
                    "batch": {B: walk(batch_shardings(m, b), spec)
                              for B, b in batches.items()},
                    "cache": {n: walk(cache_shardings(m, c), spec)
                              for n, c in caches.items()},
                    "hints": {k: [list(e) if isinstance(e, tuple) else e
                                  for e in tuple(v)]
                              for k, v in activation_hints(m).items()},
                }
print("SPECS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT,
         json.dumps([FLAGS, BATCH_ROWS, CACHES])],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("SPECS "))
    return json.loads(line[len("SPECS "):])


def _json(spec):
    """A spec as JSON holds it: tuples of names as lists."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _port_specs(arch, m, flag):
    cfg = get_config(arch)
    state = ts.init_train_state_shape(cfg, ts.default_opt_cfg(cfg))

    def spec(s):
        return _json(s.spec)

    def meta(shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")

    with perf_flags(PerfFlags(**({flag: True} if flag else {}))):
        return {
            "state": walk(sharding.param_shardings(m, state), spec),
            "batch": {str(B): walk(sharding.batch_shardings(m, {
                k: meta(s) for k, s in batch_shapes(cfg, B).items()}), spec)
                for B in BATCH_ROWS},
            "cache": {f"{B}x{T}": walk(sharding.cache_shardings(
                m, model_lib.cache_struct(cfg, B, T)), spec)
                for B, T in CACHES},
            "hints": {k: _json(v) for k, v in
                      sharding.activation_hints(m).items()},
        }


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_equal_the_reference(reference_specs, arch):
    meshes = {"single-pod": mesh.make_production_mesh(),
              "multi-pod": mesh.make_production_mesh(multi_pod=True)}
    n_sharded = 0
    for mname, m in meshes.items():
        for flag in FLAGS:
            want = reference_specs[f"{arch}|{mname}|{flag}"]
            got = _port_specs(arch, m, flag)
            for part in ("state", "batch", "cache", "hints"):
                assert got[part] == want[part], (arch, mname, flag, part)
            n_sharded += sum(e is not None for s in got["state"].values()
                             for e in s)
    assert n_sharded > 0


def test_the_flags_change_the_specs(reference_specs):
    """Each flag changes something on some arch (so the equality above
    sees each flag act, as the reference's)."""
    for flag in FLAGS[1:]:
        assert any(reference_specs[f"{a}|single-pod|{flag}"]
                   != reference_specs[f"{a}|single-pod|"]
                   for a in ASSIGNED), flag


def test_assigned_is_the_reference_tuple():
    assert ASSIGNED == JAX_ASSIGNED


def _jax_leaves(tree):
    return walk(tree, lambda x: (tuple(x.shape), str(x.dtype)))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_init_params_shape_and_cache_struct_match_the_reference(arch):
    """Shapes and dtypes leaf for leaf, on the meta device (no memory)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)

    def mine(t):
        assert t.device.type == "meta"
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))

    assert walk(model_lib.init_params_shape(cfg), mine) == \
        _jax_leaves(jax_model.init_params_shape(jcfg))
    assert walk(model_lib.init_params_shape(cfg, torch.float32), mine) == \
        _jax_leaves(jax_model.init_params_shape(jcfg, jax.numpy.float32))
    assert walk(model_lib.cache_struct(cfg, 8, 256), mine) == \
        _jax_leaves(jax_model.cache_struct(jcfg, 8, 256))


class FakeMesh:
    """The reference tests' duck-typed mesh (no devices)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_helpers_match_the_reference(multi_pod):
    m = mesh.make_production_mesh(multi_pod=multi_pod)
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    assert dict(m.shape) == shape and m.axis_names == tuple(shape)
    fake = FakeMesh(shape)
    for mm in (m, fake):
        assert mesh.fsdp_axes(mm) == jax_mesh.fsdp_axes(fake)
        assert mesh.tp_axis(mm) == jax_mesh.tp_axis(fake)
        for axes in ("data", "model", ("data", "model"),
                     jax_mesh.fsdp_axes(fake)):
            assert mesh.axis_size(mm, axes) == jax_mesh.axis_size(fake, axes)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = mesh.make_production_mesh(multi_pod=True)
    assert sharding.to_placements((("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.to_placements(("data",), m) == \
        (Replicate(), Shard(0), Replicate())
    assert sharding.to_placements((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        sharding.to_placements((("data", "pod"),), m)
    with pytest.raises(ValueError, match="shards two"):
        sharding.to_placements(("model", "model"), m)


def test_rules_against_the_reference_by_hand():
    """The reference tests' cases: experts over model, d_model over data;
    a dim that does not divide stays replicated."""
    m = mesh.make_production_mesh()
    assert sharding._param_spec_leaf(m, "w1", (128, 2048, 768), False) == \
        ("model", "data", None)
    assert sharding._param_spec_leaf(m, "wq", (2560, 1234), False) == \
        ("data", None)
    with perf_flags(PerfFlags(moe_fsdp_tp=True)):
        assert sharding._param_spec_leaf(m, "w2", (4, 128, 768, 2048),
                                         True) == (None, None, "model",
                                                   "data")
    assert np.prod([mesh.axis_size(m, a) for a in m.axis_names]) == 256
