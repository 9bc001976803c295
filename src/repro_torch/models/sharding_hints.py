"""Sharding hints: model code stays mesh-agnostic (counterpart of
``repro.models.sharding_hints``).

``repro_torch.launch.sharding`` installs a hint table (name -> spec, a
tuple of ``None``, an axis name or a tuple of axis names per tensor
dimension) for the active ``DeviceMesh``; model code calls
:func:`shard_hint` at the reference's points (block boundaries, MoE
dispatch buffers, the loss head and logits).  There a ``DTensor`` is
redistributed to its table entry, as ``with_sharding_constraint`` binds an
array in the reference, and so is its gradient in the backward, as the
constraint's transpose binds the cotangent (else DTensor would hand a
partial gradient on, and the backward's products would run unsharded).
Outside a context, and for any tensor that is not a ``DTensor``, a hint
returns the tensor itself: on one card it costs a thread-local read.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

_state = threading.local()


def current_hints():
    """(mesh, hints) of the innermost :func:`hint_context`, or None."""
    return getattr(_state, "hints", None)


def hint_mesh(x):
    """The mesh of the innermost :func:`hint_context` where ``x`` is a
    ``DTensor`` and the context has one; else None."""
    state = current_hints()
    if state is None or state[0] is None:
        return None
    from torch.distributed.tensor import DTensor

    return state[0] if isinstance(x, DTensor) else None


@contextlib.contextmanager
def hint_context(hints: dict, mesh=None):
    """hints: name -> spec; with ``mesh`` (a ``DeviceMesh``), hints bind
    ``DTensor`` layouts on it."""
    prev = current_hints()
    _state.hints = (mesh, hints)
    try:
        yield
    finally:
        _state.hints = prev


def shard_hint(x, name: str):
    """``x`` redistributed to the hint ``name`` (its spec cut to
    ``x.ndim``) when ``x`` is a ``DTensor`` inside a context with a mesh;
    else ``x`` itself."""
    state = current_hints()
    if state is None:
        return x
    mesh, hints = state
    if mesh is None or not hints or name not in hints:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import to_placements

    placements = to_placements(tuple(hints[name])[: x.ndim], mesh)
    return Relayout.apply(x, mesh, placements, placements)


class Relayout(torch.autograd.Function):
    """Redistribute a ``DTensor`` to ``placements``, and its gradient to
    ``grad_placements``."""

    @staticmethod
    def forward(ctx, x, mesh, placements, grad_placements):
        ctx.mesh, ctx.grad_placements = mesh, grad_placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.grad_placements), None, None, None



def reshape(x, *shape):
    """``x.reshape(*shape)``.  For a ``DTensor`` (the dry-run's), each
    mesh dim that shards a dimension the reshape cannot carry is first
    replicated (an all-gather), and so is the gradient's on the way back:
    DTensor refuses a view of a dimension its shards split unevenly, or
    that splits a sharded dimension into a leading part the shards do not
    divide (20 heads over a model axis of 16) or merges it behind another,
    where XLA reshards on its own.  Any other tensor is reshaped as it
    is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def _carried(x, shape):
    """``x`` with every mesh dim replicated that shards a dimension the
    reshape of ``x`` to ``shape`` cannot carry."""
    from torch.distributed.tensor import Replicate, Shard

    shape = list(shape)
    if -1 in shape:
        shape[shape.index(-1)] = x.numel() // -math.prod(shape)
    starts, p = {}, 1                  # prefix product -> first dim > 1
    for size in shape:
        if size > 1:
            starts.setdefault(p, size)
        p *= size
    mesh, placements = x.device_mesh, list(x.placements)
    for dim in {pl.dim for pl in placements if isinstance(pl, Shard)}:
        n = math.prod(mesh.size(i) for i, pl in enumerate(placements)
                      if isinstance(pl, Shard) and pl.dim == dim)
        size = starts.get(math.prod(x.shape[:dim]), 1)
        if size != x.shape[dim] and (x.shape[dim] % n or size % n):
            placements = [Replicate() if isinstance(pl, Shard)
                          and pl.dim == dim else pl for pl in placements]
    if placements != list(x.placements):
        x = x.redistribute(mesh, placements)
    return x


class _Reshape(torch.autograd.Function):
    """``_carried(x).reshape``, and its gradient ``_carried`` back."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _carried(x, shape).reshape(*shape)

    @staticmethod
    def backward(ctx, g):
        return _carried(g, ctx.in_shape).reshape(ctx.in_shape), None
