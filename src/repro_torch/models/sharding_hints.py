"""Sharding hints: model code stays mesh-agnostic (counterpart of
``repro.models.sharding_hints``).

``repro_torch.launch.sharding`` installs a hint table (name -> spec, a
tuple of ``None``, an axis name or a tuple of axis names per tensor
dimension) for the active ``DeviceMesh``; model code calls
:func:`shard_hint` at the reference's points (block boundaries, MoE
dispatch buffers, the loss head and logits).  There a ``DTensor`` is
redistributed to its table entry, as ``with_sharding_constraint`` binds an
array in the reference.  Outside a context, and for any tensor that is not
a ``DTensor``, a hint returns the tensor itself: on one card it costs a
thread-local read.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def current_hints():
    """(mesh, hints) of the innermost :func:`hint_context`, or None."""
    return getattr(_state, "hints", None)


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

    spec = tuple(hints[name])[: x.ndim]
    return x.redistribute(mesh, to_placements(spec, mesh))
