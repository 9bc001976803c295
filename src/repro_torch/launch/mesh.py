"""Mesh construction (counterpart of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices.

One process cannot build a ``DeviceMesh`` of 256 ranks, so
``make_production_mesh`` returns a :class:`MeshSpec`: the axis names and
sizes, what the sharding rules read (the reference's tests use such a
``FakeMesh`` too).  ``make_mesh`` and ``make_host_mesh`` build a real
``torch.distributed.device_mesh.DeviceMesh`` over the process group the
caller has initialized.  ``fsdp_axes``, ``tp_axis`` and ``axis_size``
take either kind.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axes without devices: ``shape`` maps name -> size."""
    shape: Mapping[str, int]

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(dict(zip(axes, shape)))


def make_mesh(shape, axes, *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    initialized default process group, on ``device``'s type."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(*, device="cuda"):
    """Every rank of the process group as (data=world, model=1)."""
    import torch.distributed as dist

    return make_mesh((dist.get_world_size() if dist.is_initialized() else 1,
                      1), ("data", "model"), device=device)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """name -> size of a ``MeshSpec`` (or any mesh whose ``shape`` is a
    mapping) or a ``DeviceMesh`` (whose ``shape`` is a tuple)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def fsdp_axes(mesh) -> tuple:
    """The axes parameters/batch shard over (FSDP): pod+data when present."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def tp_axis(mesh) -> str:
    return "model"


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n
