"""Multi-pod dry-run: run every (arch x shape) step on the production
meshes with no device, and count each device's FLOPs, bytes, collectives
and memory for the roofline (counterpart of ``repro.launch.dryrun``).

Where the reference compiles on 512 placeholder host devices and reads
XLA's ``cost_analysis`` / ``memory_analysis``, the port:

* initializes a ``"fake"`` process group of the mesh's size (256 or 512
  ranks in one process; no collective moves data) and builds the mesh
  with ``launch/mesh.py::make_mesh``, torn down when the cell ends;
* makes every parameter, optimizer, input and cache leaf a ``DTensor``
  whose local shard is a ``meta`` tensor, placed as ``param_shardings`` /
  ``batch_shardings`` / ``cache_shardings`` say, and runs the step eagerly
  under ``hint_context(mesh)``, the cell's ``perf_flags`` and
  ``implicit_replication`` (the model's constants, such as RoPE tables and
  masks, join as replicated);
* counts under :class:`CostCounter`, a ``TorchDispatchMode`` below
  DTensor: it sees the local ops DTensor issues on each device's shard,
  and only those (DTensor's sharding propagation also runs each op at the
  global shape, on fake tensors, which are not counted).

So every figure is per device.  FLOPs are ``torch.utils.flop_counter``'s
per-op formulas on the local shapes.  Bytes are each local op's inputs
plus outputs: eager PyTorch's unfused traffic, which lies above XLA's
fused ``bytes accessed``.  Collective bytes are the output bytes of
DTensor's ``_c10d_functional`` collectives, weighted as the reference's
ring convention (``roofline.analysis._COST_FACTOR``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import (SHAPES, get_config, input_specs,
                                 shape_applicable)
from repro_torch.configs.archs import ASSIGNED
from repro_torch.launch.mesh import (axis_size, fsdp_axes, make_mesh,
                                     make_production_mesh, tp_axis)
from repro_torch.launch.sharding import (NamedSharding, batch_shardings,
                                         cache_shardings, hint_context,
                                         param_shardings)
from repro_torch.models import model as model_lib
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import _COST_FACTOR, roofline
from repro_torch.train.train_step import (default_opt_cfg,
                                          init_train_state_shape,
                                          make_train_step)

# --------------------------------------------------------------------------
# Step builders: (fn, example_args, in_shardings, donate_argnums)
# --------------------------------------------------------------------------


def build_cell(cfg, shape, mesh):
    """(step, meta-tensor arguments, their shardings, donated arguments),
    as the reference's: the train step on the train state and batch, the
    prefill on the parameters and batch, one decode step on the
    parameters, ``cache_struct``, the token and a 0-d cache length."""
    specs = input_specs(cfg, shape)
    dt = getattr(torch, cfg.dtype)

    if shape.kind == "train":
        opt_cfg = default_opt_cfg(cfg)
        step = make_train_step(cfg, opt_cfg)
        state = init_train_state_shape(cfg, opt_cfg)
        batch = dict(specs)
        args = (state, batch)
        shardings = (param_shardings(mesh, state),
                     batch_shardings(mesh, batch))
        return step, args, shardings, (0,)

    params = model_lib.init_params_shape(cfg, dtype=dt)
    p_sh = param_shardings(mesh, params)

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return model_lib.prefill(params, cfg, batch["tokens"],
                                     batch.get("frontend"))
        batch = dict(specs)
        args = (params, batch)
        return prefill_fn, args, (p_sh, batch_shardings(mesh, batch)), ()

    if shape.kind == "decode":
        def serve_step(params, caches, token, cache_len):
            return model_lib.decode_step(params, cfg, token, caches,
                                         cache_len)
        caches = specs["caches"]
        args = (params, caches, specs["token"], specs["cache_len"])
        shardings = (p_sh, cache_shardings(mesh, caches),
                     batch_shardings(mesh, specs["token"]),
                     NamedSharding(mesh, ()))
        return serve_step, args, shardings, (1,)

    raise ValueError(shape.kind)


# --------------------------------------------------------------------------
# Counting
# --------------------------------------------------------------------------

_aten = torch.ops.aten

# DTensor's collectives -> the reference's collective kinds.
COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_gather_into_tensor": "all-gather",
    "_c10d_functional_autograd.reduce_scatter_tensor": "reduce-scatter",
    # a shard-to-shard redistribution (``_card_all_to_all``)
    "_dtensor.shard_dim_alltoall": "all-to-all",
}

# Ops that move no data of their own.
_FREE = {"_c10d_functional.wait_tensor",
         "_c10d_functional._wrap_tensor_autograd"}

# Matrix ops with no flop formula: a step that reaches one is refused
# rather than counted short.
_UNCOUNTED_MATMULS = {_aten.dot, _aten.vdot, _aten.mv, _aten.addmv,
                      _aten.addbmm, _aten.addr}


def _local_bytes(t: torch.Tensor) -> int:
    """Bytes a kernel reads or writes for ``t``: its elements, at most its
    storage (an expanded view reads its storage once)."""
    n = t.numel() * t.element_size()
    return min(n, t.untyped_storage().nbytes()) if n else 0


class CostCounter(TorchDispatchMode):
    """Counts the ops on DTensor local shards, and on tensors made from
    them: FLOPs, bytes, collective bytes and op counts, and the live bytes
    of their storages (arguments, outputs, peak)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collective = {k: 0.0 for k in _COST_FACTOR}
        self.op_counts = {k: 0 for k in _COST_FACTOR}
        self.argument_bytes = 0
        self.output_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = {}

    # ---- storages ---------------------------------------------------------

    def _free(self, key, n, _ref):
        self._storages.pop(key, None)
        self.live_bytes -= n

    def _track(self, t: torch.Tensor):
        """Tag ``t`` as a local shard and count its storage as live."""
        t._dryrun_local = True
        st = t.untyped_storage()
        key = id(st)
        ref = self._storages.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        self._storages[key] = weakref.ref(st, functools.partial(
            self._free, key, n))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    @staticmethod
    def _is_local(t) -> bool:
        return isinstance(t, torch.Tensor) and getattr(t, "_dryrun_local",
                                                       False)

    # ---- arguments and outputs -------------------------------------------

    def shard(self, tree, shardings):
        """``tree``'s meta tensors as DTensors placed by ``shardings`` (a
        matching tree of ``NamedSharding``), their local shards counted as
        the step's arguments; Python numbers stay as they are.  On a mesh
        of one device a shard is the whole tensor, and it stays a plain
        meta tensor: a DTensor would add only its dispatch's time."""
        from torch.distributed.tensor import DTensor, Shard

        leaves, spec = tree_flatten(tree)
        shs, _ = tree_flatten(shardings,
                              is_leaf=lambda s: isinstance(s, NamedSharding))
        assert len(leaves) == len(shs), (len(leaves), len(shs))
        out = []
        for leaf, sh in zip(leaves, shs):
            if not isinstance(leaf, torch.Tensor):
                out.append(leaf)
                continue
            if sh.mesh.size() == 1:
                t = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
                self._track(t)
                self.argument_bytes += t.untyped_storage().nbytes()
                out.append(t)
                continue
            placements = sh.placements
            local = list(leaf.shape)
            for mesh_dim, p in enumerate(placements):
                if isinstance(p, Shard):
                    local[p.dim] //= sh.mesh.size(mesh_dim)
            d = DTensor.from_local(
                torch.empty(local, dtype=leaf.dtype, device="meta"),
                sh.mesh, placements, run_check=False, shape=leaf.shape,
                stride=leaf.stride())
            before = self.live_bytes
            self._track(d._local_tensor)
            self.argument_bytes += self.live_bytes - before
            out.append(d)
        return spec.unflatten(out)

    def set_outputs(self, out):
        from torch.distributed.tensor import DTensor

        seen = set()
        for t in tree_flatten(out)[0]:
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if id(st) not in seen:
                    seen.add(id(st))
                    self.output_bytes += st.nbytes()

    # ---- the mode -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if not any(self._is_local(t) for t in ins):
            return out
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        name = func._overloadpacket._qualified_op_name.replace("::", ".")
        if name in COLLECTIVES:
            kind = COLLECTIVES[name]
            self.collective[kind] += _COST_FACTOR[kind] * sum(
                t.numel() * t.element_size() for t in outs)
            self.op_counts[kind] += 1
            return out
        if name.startswith(("_c10d_functional", "c10d")) \
                and name not in _FREE:
            raise NotImplementedError(f"uncounted collective {name}")
        packet = func._overloadpacket
        if packet in _UNCOUNTED_MATMULS:
            raise NotImplementedError(f"no flop formula for {name}")
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        if name not in _FREE and not func.is_view:
            self.bytes += sum(_local_bytes(t) for t in ins) \
                + sum(_local_bytes(t) for t in outs)
        return out


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks in this process
    (rank 0), destroyed on exit.  Raises when a group already exists: the
    dry-run's group is its own."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run needs its own process group, and "
                           "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _card_all_to_all():
    """DTensor's shard-to-shard redistribution as the cards run it.

    On a ``"cpu"`` mesh DTensor's ``shard_dim_alltoall`` falls back to
    gloo's all-gather and chunk (gloo has no all-to-all); NCCL runs
    ``_dtensor.shard_dim_alltoall``, an all-to-all of the local shard.
    Within this context every module of ``torch.distributed.tensor`` that
    holds the function calls that op instead, as DTensor does on a card
    mesh, so the counter sees and counts the all-to-all."""
    from unittest import mock

    from torch.distributed.tensor import _collective_utils

    fallback = _collective_utils.shard_dim_alltoall

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    with contextlib.ExitStack() as stack:
        for name, module in list(sys.modules.items()):
            if name.startswith("torch.distributed.tensor") and \
                    getattr(module, "shard_dim_alltoall", None) is fallback:
                stack.enter_context(mock.patch.object(
                    module, "shard_dim_alltoall", all_to_all))
        yield


def count_cell(cfg, shape, mesh) -> CostCounter:
    """Run the cell's step once on DTensor shards over ``mesh`` (a
    ``DeviceMesh`` over a ``"fake"`` group) and return its counter."""
    from torch.distributed.tensor.experimental import implicit_replication

    counter = CostCounter()
    with hint_context(mesh), _card_all_to_all():
        fn, args, shardings, _ = build_cell(cfg, shape, mesh)
        dargs = counter.shard(args, shardings)
        del args
        with implicit_replication(), counter:
            out = fn(*dargs)
        counter.set_outputs(out)
    return counter


def dry_run_mesh(*, multi_pod: bool):
    """The production mesh as a ``DeviceMesh`` over the initialized
    (``"fake"``) group: (data 16, model 16), or for two pods (data 32,
    model 16).  Every rule shards over the pod and data axes together
    (``fsdp_axes``), so they run as one axis of their product: the same
    shards, and one collective over both, as XLA runs one over its
    replica groups.  DTensor's sharding propagation on the 3-d mesh took
    some 80 times longer (reduced internvl2-2b's train step: 1277 s
    against 13 s on the CPU)."""
    spec = make_production_mesh(multi_pod=multi_pod)
    fsdp, tp = fsdp_axes(spec), tp_axis(spec)
    return make_mesh((axis_size(spec, fsdp), axis_size(spec, tp)),
                     ("data", tp), device="cpu")


def memory_analysis(counter: CostCounter) -> dict:
    """The reference's ``memory_analysis`` keys, per device: the arguments'
    and outputs' shard bytes, and the peak of live shard bytes during the
    step less the arguments; no code is generated and nothing aliases."""
    return {"argument_size_in_bytes": counter.argument_bytes,
            "output_size_in_bytes": counter.output_bytes,
            "temp_size_in_bytes": counter.peak_bytes - counter.argument_bytes,
            "alias_size_in_bytes": None,
            "generated_code_size_in_bytes": None}


def _reduced_depth(cfg, periods: int):
    return dataclasses.replace(
        cfg, name=f"{cfg.name}",
        n_layers=cfg.period * periods + cfg.n_remainder)


def probe_costs(cfg, shape, mesh) -> dict:
    """Exact per-device cost of one step at full depth, with its memory.

    The reference compiles two unrolled reduced depths and extrapolates,
    because XLA's cost analysis counts a while loop's body once.  Eager
    PyTorch has no loop body that a count sees once: every layer's ops
    run and are counted, so the full depth is counted directly."""
    counter = count_cell(cfg, shape, mesh)
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "collective": dict(counter.collective),
        "op_counts": dict(counter.op_counts),
        "probe": f"full-depth(P={cfg.n_periods})",
        "memory_analysis": memory_analysis(counter),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True, flags=None) -> dict:
    from repro_torch.models.perf_flags import PerfFlags, perf_flags

    flags = flags or PerfFlags()
    with perf_flags(flags):
        return _run_cell_inner(arch, shape_name, multi_pod=multi_pod,
                               verbose=verbose, flags=flags)


def _run_cell_inner(arch: str, shape_name: str, *, multi_pod: bool,
                    verbose: bool, flags) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}

    spec = make_production_mesh(multi_pod=multi_pod)
    n_dev = math.prod(spec.shape.values())
    t0 = time.time()
    with fake_group(n_dev):
        cost = probe_costs(cfg, shape, dry_run_mesh(multi_pod=multi_pod))
    t_probe = time.time() - t0
    mem_info = cost["memory_analysis"]

    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mf = model_lib.model_flops(cfg, n_tokens, training=(shape.kind == "train"))
    terms = roofline({"flops": cost["flops"], "bytes accessed": cost["bytes"]},
                     "", n_devices=n_dev, model_flops_global=mf)
    coll_bytes = sum(cost["collective"].values())
    terms.collective_bytes = coll_bytes
    terms.collective_s = coll_bytes / hw.LINK_BW
    terms.collective_breakdown = {**cost["collective"],
                                  "op_counts": cost["op_counts"]}
    tmap = {"compute": terms.compute_s, "memory": terms.memory_s,
            "collective": terms.collective_s}
    terms.dominant = max(tmap, key=tmap.get)

    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "mesh": dict(spec.shape),
        "n_devices": n_dev,
        "perf_flags": flags.active(),
        # nothing is compiled: the one counted run is the probe
        "compile_s": 0.0, "probe_s": round(t_probe, 2),
        "cost_probe": cost["probe"],
        "memory_analysis": mem_info,
        "flops_per_device": terms.flops,
        "hbm_bytes_per_device": terms.hbm_bytes,
        "collective_bytes_per_device": terms.collective_bytes,
        "collective_breakdown": terms.collective_breakdown,
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "model_flops_global": mf,
        "useful_flops_ratio": terms.useful_ratio,
        "params": model_lib.count_params(cfg),
        "params_active": model_lib.count_params_analytic(cfg, True),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} "
              f"({'multi' if multi_pod else 'single'}-pod {n_dev} devices): "
              f"probe {t_probe:.1f}s [{cost['probe']}]")
        print(f"  memory_analysis: {mem_info}")
        print(f"  flops/dev={terms.flops:.3e} hbm/dev={terms.hbm_bytes:.3e} "
              f"coll/dev={terms.collective_bytes:.3e}")
        print(f"  terms: compute={terms.compute_s * 1e3:.2f}ms "
              f"memory={terms.memory_s * 1e3:.2f}ms "
              f"collective={terms.collective_s * 1e3:.2f}ms "
              f"-> dominant={terms.dominant} "
              f"useful={terms.useful_ratio:.2f}")
    return result


def cells(archs=None, shapes=None):
    for arch in (archs or ASSIGNED):
        for shape_name in (shapes or list(SHAPES)):
            yield arch, shape_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--flags", default="",
                    help="comma-separated perf flags (see models/perf_flags)")
    args = ap.parse_args(argv)

    from repro_torch.models.perf_flags import PerfFlags

    flags = PerfFlags.parse(args.flags)
    suffix = ("__" + "+".join(flags.active())) if flags.active() else ""

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else None
    shapes = [args.shape] if args.shape else None
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]

    failures = []
    for arch, shape_name in cells(archs, shapes):
        for mp in meshes:
            tag = f"{arch}__{shape_name}__{'mp' if mp else 'sp'}{suffix}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[dryrun] {tag}: cached")
                continue
            try:
                res = run_cell(arch, shape_name, multi_pod=mp, flags=flags)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                res = {"arch": arch, "shape": shape_name, "multi_pod": mp,
                       "status": "error", "error": repr(e)}
                failures.append(tag)
            with open(path, "w") as f:
                json.dump(res, f, indent=2, default=str)
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        return 1
    print("[dryrun] all requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
