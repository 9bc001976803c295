"""Perf-iteration toggles (copy of ``repro.models.perf_flags``).

The field set is the reference's, so ``PerfFlags.parse`` accepts the same
names; the port acts on ``flash_kernel``, which routes prefill attention
through the CUDA flash kernel; ``banded_local``, which gives a local
(sliding-window) layer's prefill the banded path of ``chunked_attention``
(each query chunk reads only its band of keys), as the reference's
``_apply_mixer_full`` does; ``remat_dots``, which makes a ``cfg.remat``
other than ``"none"`` act as ``"dots"``; and ``bf16_grads``, which rounds
the cotangent of every block's output to bfloat16 in the backward
(``models/transformer.py::_BF16Cotangent``), as the reference does.  The
others act through a device mesh, as in the reference: ``moe_fsdp_tp``,
``decode_cache_seq_shard`` and ``sequence_parallel`` change the specs of
``launch/sharding.py``; ``loss_weight_gather`` gives the loss head's
weight its sharding hint; ``moe_a2a`` routes ``moe_ffn`` to the
all-to-all of ``models/moe_a2a.py`` when a mesh is in the hint context.
Defaults are all off, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class PerfFlags:
    loss_weight_gather: bool = False
    banded_local: bool = False
    decode_cache_seq_shard: bool = False
    moe_fsdp_tp: bool = False
    moe_a2a: bool = False
    sequence_parallel: bool = False
    bf16_grads: bool = False
    # Route global causal prefill attention through the flash kernel
    # (kernels/csrc/flash_attention.cu on a CUDA tensor).
    flash_kernel: bool = False
    # Rematerialize a train step's blocks keeping only the matrix products
    # (models/transformer.py::_remat) unless cfg.remat is "none".
    remat_dots: bool = False

    @classmethod
    def parse(cls, csv: str) -> "PerfFlags":
        names = [s.strip() for s in csv.split(",") if s.strip()]
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(names) - known
        if bad:
            raise ValueError(f"unknown perf flags {bad}; known: {known}")
        return cls(**{n: True for n in names})

    def active(self) -> list:
        return [f.name for f in dataclasses.fields(self)
                if getattr(self, f.name)]


def current() -> PerfFlags:
    return getattr(_state, "flags", None) or PerfFlags()


@contextlib.contextmanager
def perf_flags(flags: PerfFlags):
    prev = getattr(_state, "flags", None)
    _state.flags = flags
    try:
        yield
    finally:
        _state.flags = prev
