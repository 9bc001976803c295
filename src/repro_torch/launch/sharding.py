"""Sharding rules: parameter / optimizer / cache / batch partition specs
(counterpart of ``repro.launch.sharding``).

Strategy (the reference's):
  * 2D weight sharding — the "input" dim of every matmul weight shards over
    the FSDP axes (pod+data), the "output"/head/ff dim over the tensor axis
    (`model`) — when divisible; non-divisible dims stay replicated (GQA kv
    heads, odd head counts).
  * MoE expert weights shard experts over `model` (expert parallelism),
    d_model over FSDP; under the ``moe_fsdp_tp`` PerfFlag the experts are
    replicated and (d_model, d_ff) 2D-sharded instead.
  * Activations shard batch over FSDP; the sequence-parallel hint shards
    the sequence dim over `model` between blocks.
  * Decode caches shard batch over FSDP when divisible, else the time axis
    (batch 1: context-parallel decode); under ``decode_cache_seq_shard`` a
    cache whose heads do not divide `model` shards its time axis there.

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (major first), the
entries of the reference's ``PartitionSpec`` (which writes a tuple of one
name as the bare name; so does :func:`_spec`).  ``param_shardings``,
``batch_shardings`` and ``cache_shardings`` return trees of
:class:`NamedSharding` (mesh, spec) laid out as the tree they are given
(dicts and NamedTuples; a Python number is a leaf of spec ``()``);
``to_placements`` turns a spec into ``DTensor`` placements on a real
``DeviceMesh``.  Everything degrades gracefully: any dim not divisible by
its axis is replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.launch.mesh import axis_names, axis_size, fsdp_axes, tp_axis
from repro_torch.models.perf_flags import current as _perf


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _fits(mesh, dim: int, axes) -> bool:
    return axes is not None and dim % axis_size(mesh, axes) == 0


def _axes_or_none(mesh, dim: int, axes):
    return axes if _fits(mesh, dim, axes) else None


def _spec(*entries) -> tuple:
    """A spec as ``PartitionSpec`` holds it: a tuple of one name is the
    bare name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def to_placements(spec, mesh) -> tuple:
    """``DTensor`` placements on ``mesh`` (a ``DeviceMesh``) for ``spec``:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names, major first
    (the names of one entry in the mesh's order), ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        pos = [names.index(a) for a in
               ((entry,) if isinstance(entry, str) else entry)]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in pos:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions of {spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def _tree_map_with_keys(fn, node, keys=()):
    """``fn(keys, leaf)`` over dicts and NamedTuples, laid out as ``node``;
    ``keys`` are the dict keys and field names down to the leaf."""
    if isinstance(node, dict):
        return {k: _tree_map_with_keys(fn, v, keys + (str(k),))
                for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_tree_map_with_keys(fn, getattr(node, f),
                                                keys + (f,))
                            for f in node._fields))
    return fn(keys, node)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


class ShardingOptions:
    """Global toggles used by the perf hillclimb."""
    sequence_parallel: bool = False


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

_IN_OUT = {  # name -> which dim is the "input" (fsdp) dim for 2D weights
    "wq": 0, "wk": 0, "wv": 0, "wq_a": 0, "wq_b": 0, "wkv_a": 0,
    "wkv_b": 0, "w1": 0, "w3": 0, "in_proj": 0, "lm_head": 0,
    "wo": 1, "w2": 1, "out_proj": 1,
}


def _param_spec_leaf(mesh, name: str, shape, stacked: bool) -> tuple:
    fsdp = fsdp_axes(mesh)
    tp = tp_axis(mesh)
    core = shape[1:] if stacked else shape
    spec: list = [None] * len(core)

    if name == "embed":
        # [V, D]: vocab over model (TP softmax/gather), D over FSDP
        spec = [_axes_or_none(mesh, core[0], tp),
                _axes_or_none(mesh, core[1], fsdp)]
    elif name == "router" and len(core) == 2:
        spec = [_axes_or_none(mesh, core[0], fsdp), None]
    elif len(core) == 3 and name in ("w1", "w3"):
        if _perf().moe_fsdp_tp:
            # experts replicated; 2D-shard (d_model->fsdp, d_ff->tp)
            spec = [None, _axes_or_none(mesh, core[1], fsdp),
                    _axes_or_none(mesh, core[2], tp)]
        else:
            # MoE experts [E, D, F]: expert-parallel over model
            spec = [_axes_or_none(mesh, core[0], tp),
                    _axes_or_none(mesh, core[1], fsdp), None]
    elif len(core) == 3 and name == "w2":
        if _perf().moe_fsdp_tp:
            spec = [None, _axes_or_none(mesh, core[1], tp),
                    _axes_or_none(mesh, core[2], fsdp)]
        else:
            spec = [_axes_or_none(mesh, core[0], tp), None,
                    _axes_or_none(mesh, core[2], fsdp)]
    elif name == "conv_w":
        spec = [None, _axes_or_none(mesh, core[1], tp)]
    elif len(core) == 2 and name in _IN_OUT:
        in_dim = _IN_OUT[name]
        out_dim = 1 - in_dim
        spec[in_dim] = _axes_or_none(mesh, core[in_dim], fsdp)
        spec[out_dim] = _axes_or_none(mesh, core[out_dim], tp)
    elif len(core) >= 1 and core[-1] > 1024:
        # large 1-D (biases over big ff dims): shard over tp
        spec[-1] = _axes_or_none(mesh, core[-1], tp)

    if stacked:
        spec = [None] + spec  # leading n_periods axis
    return _spec(*spec)


def param_shardings(mesh, params_tree):
    """Tree of NamedShardings matching a params (or TrainState) tree."""

    def walk(keys, leaf):
        name = keys[-1] if keys else ""
        stacked = any(k in ("blocks", "enc_blocks") for k in keys[:-1])
        return NamedSharding(mesh, _param_spec_leaf(mesh, name, _shape(leaf),
                                                     stacked))

    return _tree_map_with_keys(walk, params_tree)


# --------------------------------------------------------------------------
# batches / caches
# --------------------------------------------------------------------------


def batch_shardings(mesh, batch_tree):
    """tokens/labels [B,S], frontend [B,P,D] -> batch over FSDP axes."""
    fsdp = fsdp_axes(mesh)

    def leaf(_, x):
        shape = _shape(x)
        if not shape:
            return NamedSharding(mesh, ())
        spec = [None] * len(shape)
        spec[0] = _axes_or_none(mesh, shape[0], fsdp)
        return NamedSharding(mesh, _spec(*spec))

    return _tree_map_with_keys(leaf, batch_tree)


def cache_shardings(mesh, cache_tree):
    fsdp = fsdp_axes(mesh)
    tp = tp_axis(mesh)
    seq_shard = _perf().decode_cache_seq_shard

    def walk(keys, leaf):
        name = keys[-1]
        stacked = "blocks" in keys[:-1]
        shape = _shape(leaf)
        spec = [None] * len(shape)
        bdim = 1 if stacked else 0
        if _fits(mesh, shape[bdim], fsdp):
            spec[bdim] = fsdp
        elif name in ("k", "v", "ckv", "krope") and len(shape) > bdim + 1 \
                and _fits(mesh, shape[bdim + 1], fsdp):
            spec[bdim + 1] = fsdp  # context-parallel decode (batch=1)
        if name in ("k", "v", "xk", "xv") and len(shape) >= bdim + 4:
            hdim = bdim + 2
            if _fits(mesh, shape[hdim], tp):
                spec[hdim] = tp
            elif seq_shard and spec[bdim + 1] is None \
                    and _fits(mesh, shape[bdim + 1], tp):
                # heads don't divide the model axis: context-parallel the
                # cache time dim instead
                spec[bdim + 1] = tp
        if name in ("ckv", "krope") and seq_shard \
                and len(shape) > bdim + 1 and spec[bdim + 1] is None \
                and _fits(mesh, shape[bdim + 1], tp):
            spec[bdim + 1] = tp
        if name == "ssd" and len(shape) >= bdim + 3:
            # [B, G, HG, P, N]: heads-per-group over tp
            if _fits(mesh, shape[bdim + 2], tp):
                spec[bdim + 2] = tp
        if name == "conv" and _fits(mesh, shape[-1], tp):
            spec[-1] = tp
        return NamedSharding(mesh, _spec(*spec))

    return _tree_map_with_keys(walk, cache_tree)


# --------------------------------------------------------------------------
# activation hints for the model interior
# --------------------------------------------------------------------------


def activation_hints(mesh) -> dict:
    fsdp = fsdp_axes(mesh)
    tp = tp_axis(mesh)
    seq = tp if (ShardingOptions.sequence_parallel
                 or _perf().sequence_parallel) else None
    moe_expert_axis = None if _perf().moe_fsdp_tp else tp
    return {
        # [B, S, D]
        "activation": _spec(fsdp, seq, None),
        # [G, E, C, d] MoE dispatch buffer: groups over FSDP; experts over
        # TP only under expert parallelism (baseline)
        "moe_dispatch": _spec(fsdp, moe_expert_axis, None, None),
        # [G, T, d] MoE combine output
        "moe_out": _spec(fsdp, None, None),
        # CE-loss head weight resharding (loss_weight_gather lever):
        # untied [D, V]: replicate D, keep V on tp; tied [V, D]: same idea
        "loss_head": _spec(None, tp),
        "loss_head_tied": _spec(tp, None),
        # [B, C, V] logits chunk
        "logits": _spec(fsdp, None, tp),
    }


def hint_context(mesh):
    from repro_torch.models.sharding_hints import hint_context as _ctx

    return _ctx(activation_hints(mesh), mesh)
