"""Launchers and distribution (counterpart of ``repro.launch``): mesh,
sharding rules, dry-run, fault tolerance.  ``launch.dryrun`` is not
imported here, as in the reference: it is the dry-run's entry point."""
from repro_torch.launch.fault import (CrashInjector, StragglerDetector,
                                      resume_latest)
from repro_torch.launch.mesh import (axis_size, fsdp_axes, make_host_mesh,
                                     make_production_mesh, tp_axis)
from repro_torch.launch.sharding import (ShardingOptions, batch_shardings,
                                         cache_shardings, hint_context,
                                         param_shardings)

__all__ = [
    "CrashInjector", "StragglerDetector", "resume_latest", "axis_size",
    "fsdp_axes", "make_host_mesh", "make_production_mesh", "tp_axis",
    "ShardingOptions", "batch_shardings", "cache_shardings", "hint_context",
    "param_shardings",
]
