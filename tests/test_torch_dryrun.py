"""The port's dry-run (``launch/dryrun.py``) on the CPU, over ``"fake"``
process groups: no card, no data.

* Exact counts: one ``x @ w`` on a 16 x 16 mesh, under a tensor-parallel
  and an FSDP layout, counts the local ``mm``'s FLOPs and the bytes of the
  one all-gather by hand; the reduced llsc-100m prefill and train step on a
  (2, 2) mesh count the per-device matrix FLOPs written out below.
* Argument bytes: for every ``ASSIGNED`` arch (reduced), each of train,
  prefill and decode, on both production meshes, the shards' bytes equal
  the reference's ``NamedSharding(mesh, spec).shard_shape`` bytes over the
  same leaves (the reference in a subprocess with 512 host devices).
* Against the reference's dry-run: per-device FLOPs of the reduced
  llsc-100m prefill and train step on the port's (2, 2) fake mesh and on
  a 4-device reference mesh (XLA's ``cost_analysis`` in a subprocess)
  within 0.8 <= port / reference <= 1.0: XLA also counts elementwise and
  transcendental work, the port only matrix work.
* The CLI's JSON keys and statuses, the group's lifetime, and repair 0
  (``cumsum_f32`` on meta tensors).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (SHAPES, ShapeSpec, base,  # noqa: E402
                                 get_config, reduced_config)
from repro_torch.configs.archs import ASSIGNED  # noqa: E402
from repro_torch.kernels.ref import cumsum_f32  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import NamedSharding  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")

# The reference's result keys (repro/launch/dryrun.py run_cell).
RESULT_KEYS = {
    "arch", "shape", "multi_pod", "status", "mesh", "n_devices",
    "perf_flags", "compile_s", "probe_s", "cost_probe", "memory_analysis",
    "flops_per_device", "hbm_bytes_per_device",
    "collective_bytes_per_device", "collective_breakdown", "compute_s",
    "memory_s", "collective_s", "dominant", "model_flops_global",
    "useful_flops_ratio", "params", "params_active"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "generated_code_size_in_bytes"}

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import dataclasses, json, sys
import jax, numpy as np
from repro.configs import reduced_config
from repro.configs.archs import ASSIGNED
from repro.configs.shapes import ShapeSpec
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh

out = {"args": {}, "cost": {}}
for arch in ASSIGNED:
    cfg = reduced_config(arch)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec("t", 64, 32, kind)
        for mp in (False, True):
            mesh = make_production_mesh(multi_pod=mp)
            _, args, shs, _ = dryrun.build_cell(cfg, shape, mesh)
            total = 0
            for leaf, sh in zip(jax.tree.leaves(args), jax.tree.leaves(shs)):
                total += (int(np.prod(sh.shard_shape(leaf.shape)))
                          * np.dtype(leaf.dtype).itemsize)
            out["args"][f"{arch}|{kind}|{mp}"] = total
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
for kind in ("prefill", "train"):
    cfg = reduced_config("llsc-100m")
    c = dryrun._extract_cost(dryrun._compile_cell(
        cfg, ShapeSpec("t", 32, 4, kind), mesh, unroll=True))
    out["cost"][kind] = c
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(ln for ln in res.stdout.splitlines() if ln.startswith("REF "))
    return json.loads(line[len("REF "):])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# --------------------------------------------------------------------------
# exact counts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("w_spec", [(None, "model"), ("data", None)],
                         ids=["tp", "fsdp"])
def test_one_product_on_a_16x16_mesh(w_spec):
    """x [256,128,1024] batch over data @ w [1024,4096]: each device
    multiplies its 16 rows x 128 positions by a [1024, 256] slice of w.
    Under TP w's output columns are already over model: no collective.
    Under FSDP w's rows are over data: DTensor slices its columns over
    model locally and all-gathers the [1024, 256] slice over data."""
    with dryrun.fake_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        counter = dryrun.CostCounter()
        x, w = counter.shard(
            (_meta(256, 128, 1024), _meta(1024, 4096)),
            (NamedSharding(mesh, ("data", None, None)),
             NamedSharding(mesh, w_spec)))
        with counter:
            y = x @ w
        assert y.to_local().shape == (16, 128, 256)
    assert counter.flops == 2 * 2048 * 1024 * 256
    gathered = 1024 * 256 * 4 if w_spec == ("data", None) else 0
    assert counter.collective == {"all-reduce": 0.0,
                                  "all-gather": float(gathered),
                                  "reduce-scatter": 0.0, "all-to-all": 0.0,
                                  "collective-permute": 0.0}
    assert counter.op_counts["all-gather"] == (1 if gathered else 0)
    # the arguments' shards: x 16 rows of it, w 1/16 of it
    assert counter.argument_bytes == (16 * 128 * 1024 + 1024 * 4096 // 16) * 4
    assert not torch.distributed.is_initialized()


def _llsc_matmul_flops(kind):
    """Per-device matrix FLOPs of reduced llsc-100m (one layer, d 64, 4
    heads of 16, d_ff 128, tied vocab 512, fp32) at B 4, S 32 on a (2, 2)
    mesh: batch over data, heads, d_ff and vocab over model, so each
    product's work divides by 4.  Prefill: the layer and the last
    position's logits.  Train: the layer forward and its backward (2x),
    and the loss head's logits forward, recomputed (its checkpoint) and
    backward (2x)."""
    B, S, d, H, Dh, F, V = 4, 32, 64, 4, 16, 128, 512
    T = B * S
    qkv, wo = 2 * T * d * 3 * H * Dh, 2 * T * H * Dh * d
    mlp = 3 * 2 * T * d * F
    attn = 2 * 2 * B * H * S * S * Dh          # scores and values
    layer = qkv + wo + mlp + attn
    if kind == "prefill":
        return (layer + 2 * B * d * V) // 4
    head = 2 * T * d * V
    return (3 * layer + 4 * head) // 4


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_reduced_llsc_counts_the_per_device_matmuls(kind):
    shape = ShapeSpec("t", 32, 4, kind)
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        cost = dryrun.probe_costs(reduced_config("llsc-100m"), shape, mesh)
    assert cost["flops"] == _llsc_matmul_flops(kind)
    assert cost["probe"] == "full-depth(P=1)"
    mem = cost["memory_analysis"]
    assert set(mem) == MEMORY_KEYS
    assert mem["alias_size_in_bytes"] is None
    assert mem["generated_code_size_in_bytes"] is None
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert cost["bytes"] > 0 and sum(cost["collective"].values()) > 0


def test_full_depth_is_the_references_two_point_probe():
    """Counts are affine in the period count (the periods are identical),
    so the full depth counted directly equals the reference's two-point
    extrapolation from depths 1 and 2 (``_reduced_depth``), exactly."""
    cfg = get_config("gemma3-1b")                 # a period of 6 + 2
    shape = ShapeSpec("t", 128, 2, "prefill")
    with dryrun.fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        c = {p: dryrun.probe_costs(dryrun._reduced_depth(cfg, p), shape,
                                   mesh) for p in (1, 2, 4)}
    for key in ("flops", "bytes"):
        assert c[4][key] == c[1][key] + 3 * (c[2][key] - c[1][key])
    assert c[4]["probe"] == "full-depth(P=4)"


# Measured on the CPU: port / reference per-device FLOPs.
MEASURED_RATIO = {"prefill": 2949120 / 3111848, "train": 17039360 / 18265388}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_flops_against_the_reference(reference, kind):
    shape = ShapeSpec("t", 32, 4, kind)
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        port = dryrun.probe_costs(reduced_config("llsc-100m"), shape, mesh)
    ref = reference["cost"][kind]
    ratio = port["flops"] / ref["flops"]
    print(f"{kind}: flops port {port['flops']:.0f} ref {ref['flops']:.0f} "
          f"({ratio:.4f}); bytes port {port['bytes']:.0f} ref "
          f"{ref['bytes']:.0f}; collective port {port['collective']} "
          f"ref {ref['collective']}")
    assert 0.8 <= ratio <= 1.0
    assert ratio == pytest.approx(MEASURED_RATIO[kind], rel=1e-12)


# --------------------------------------------------------------------------
# argument bytes against the reference's shard shapes
# --------------------------------------------------------------------------


def _argument_bytes(cfg, kind, mesh):
    _, args, shardings, _ = dryrun.build_cell(cfg, ShapeSpec("t", 64, 32,
                                                             kind), mesh)
    counter = dryrun.CostCounter()
    counter.shard(args, shardings)
    return counter.argument_bytes


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single-pod", "multi-pod"])
def test_argument_bytes_equal_the_reference_shards(reference, multi_pod):
    """On the dry-run's own mesh (two pods: pod x data as one axis of 32)
    against the reference's production mesh (2 x 16 x 16)."""
    with dryrun.fake_group(512 if multi_pod else 256):
        mesh = dryrun.dry_run_mesh(multi_pod=multi_pod)
        assert mesh.mesh.numel() == (512 if multi_pod else 256)
        for arch in ASSIGNED:
            cfg = reduced_config(arch)
            for kind in KINDS:
                want = reference["args"][f"{arch}|{kind}|{multi_pod}"]
                # the reference's AdamW step is a 0-d int32 array, the
                # port's a Python int
                want -= 4 if kind == "train" else 0
                assert _argument_bytes(cfg, kind, mesh) == want, \
                    (arch, kind)


def test_the_counted_run_reports_the_argument_bytes():
    """probe_costs' argument_size_in_bytes is the shards' sum, as above."""
    cfg = reduced_config("granite-moe-1b-a400m")
    with dryrun.fake_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        want = _argument_bytes(cfg, "decode", mesh)
        cost = dryrun.probe_costs(cfg, ShapeSpec("t", 64, 32, "decode"), mesh)
    assert cost["memory_analysis"]["argument_size_in_bytes"] == want


def test_a_time_sharded_cache_takes_the_token_on_its_shards():
    """Context-parallel decode (one row): the cache's time axis shards over
    data, and the 0-d length's write runs on each device's slice, in
    place, with no collective; DTensor alone would gather the cache."""
    from torch.multiprocessing.reductions import StorageWeakRef

    from repro_torch.models.attention import _cache_write

    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        counter = dryrun.CostCounter()
        cache, new, length = counter.shard(
            (_meta(1, 64, 4, 16), _meta(1, 1, 4, 16),
             _meta(dtype=torch.int32)),
            (NamedSharding(mesh, (None, "data", "model", None)),
             NamedSharding(mesh, (None, None, "model", None)),
             NamedSharding(mesh, ())))
        with counter:
            out = _cache_write(cache, new, length)
        assert out.placements == cache.placements
        assert out.to_local().shape == (1, 32, 2, 16)
        assert StorageWeakRef(out.to_local().untyped_storage()) == \
            StorageWeakRef(cache.to_local().untyped_storage())
    assert sum(counter.collective.values()) == 0


# --------------------------------------------------------------------------
# every reduced arch and kind runs on a sharded mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_reduced_cell_is_counted(arch, kind):
    """Each cell runs on a (2, 2) mesh, and its four devices' FLOPs add up
    to one device's: no product runs replicated over the mesh but where
    the model cannot split it (gemma3-1b's one KV head: its K and V
    projections run on both model ranks, 4.54% of the step's FLOPs)."""
    shape = ShapeSpec("t", 32, 4, kind)
    cfg = reduced_config(arch)
    with dryrun.fake_group(1):
        one = dryrun.probe_costs(cfg, shape, make_mesh((1, 1), (
            "data", "model"), device="cpu"))
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        cost = dryrun.probe_costs(cfg, shape, mesh)
    assert cost["flops"] > 0 and cost["bytes"] > 0
    assert sum(cost["op_counts"].values()) > 0
    assert sum(one["op_counts"].values()) == 0
    assert 1.0 <= 4 * cost["flops"] / one["flops"] <= 1.05


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


@pytest.fixture
def reduced_arch(monkeypatch):
    cfg = reduced_config("granite-moe-1b-a400m")
    monkeypatch.setitem(base._REGISTRY, cfg.name, cfg)
    return cfg.name


def test_main_writes_the_references_keys(reduced_arch, tmp_path):
    assert dryrun.main(["--arch", reduced_arch, "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    (path,) = tmp_path.glob("*.json")
    assert path.name == f"{reduced_arch}__decode_32k__sp.json"
    res = json.loads(path.read_text())
    assert set(res) == RESULT_KEYS
    assert res["status"] == "ok" and res["n_devices"] == 256
    assert res["mesh"] == {"data": 16, "model": 16}
    assert set(res["memory_analysis"]) == MEMORY_KEYS
    assert res["cost_probe"] == "full-depth(P=1)"
    assert res["dominant"] in ("compute", "memory", "collective")
    assert not torch.distributed.is_initialized()
    # a second run finds the cell cached
    assert dryrun.main(["--arch", reduced_arch, "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0


def test_main_skips_where_the_reference_skips(tmp_path):
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import get_config as jax_get_config
    from repro.configs import shape_applicable as jax_applicable

    assert dryrun.main(["--arch", "qwen1.5-4b", "--shape", "long_500k",
                        "--both-meshes", "--out", str(tmp_path)]) == 0
    _, reason = jax_applicable(jax_get_config("qwen1.5-4b"),
                               JAX_SHAPES["long_500k"])
    for mp in ("sp", "mp"):
        res = json.loads((tmp_path / f"qwen1.5-4b__long_500k__{mp}.json")
                         .read_text())
        assert res["status"] == "skipped" and res["reason"] == reason
    skipped = [(a, s) for a in ASSIGNED for s in SHAPES
               if not dryrun.shape_applicable(get_config(a), SHAPES[s])[0]]
    assert skipped == [(a, "long_500k") for a in ASSIGNED
                       if not get_config(a).sub_quadratic]


def test_main_reports_an_error_and_exits_1(reduced_arch, tmp_path):
    assert dryrun.main(["--arch", reduced_arch, "--shape", "no_such_shape",
                        "--out", str(tmp_path)]) == 1
    res = json.loads((tmp_path / f"{reduced_arch}__no_such_shape__sp.json")
                     .read_text())
    assert res["status"] == "error" and "no_such_shape" in res["error"]


def test_the_group_is_the_dry_runs_own():
    with dryrun.fake_group(4):
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_group(4):
                pass
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------------------------
# repair 0: cumsum_f32 on tensors that are neither CUDA nor CPU
# --------------------------------------------------------------------------


def test_cumsum_f32_on_meta_tensors():
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.empty(2, 3, 256, 4, dtype=dtype, device="meta")
        for dim in (2, -1, 0):
            y = cumsum_f32(x, dim)
            assert y.device.type == "meta"
            assert y.shape == x.shape and y.dtype == torch.float32


def test_cumsum_f32_on_the_cpu_is_numpys_float32_scan():
    x = np.random.default_rng(0).standard_normal((3, 257, 5)).astype(
        np.float32)
    for dim in (0, 1, 2):
        want = np.cumsum(x, axis=dim, dtype=np.float32)
        got = cumsum_f32(torch.from_numpy(x), dim).numpy()
        assert got.tobytes() == want.tobytes()
