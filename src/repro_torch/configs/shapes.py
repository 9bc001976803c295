"""Assigned input shapes and per-(arch, shape) input specs (counterpart of
``repro.configs.shapes``).

``train_*`` shapes drive ``train_step``; ``prefill_*`` the serving
prefill; ``decode_*`` / ``long_*`` one decode step (one new token against
a KV cache of ``seq_len``).

``input_specs`` returns tensors on the ``meta`` device: the reference's
shapes and dtypes, no memory (the reference's ``ShapeDtypeStruct``
stand-ins), which the dry-run shards as DTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple:
    """(ok, reason). long_500k only for sub-quadratic families."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k-token decode cache "
                       "requires sub-quadratic attention (DESIGN.md §4)")
    return True, ""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def frontend_spec(cfg: ModelConfig, batch: int):
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "patch_stub":
        return _meta((batch, cfg.frontend_len, cfg.d_model), dt)
    if cfg.frontend == "audio_stub":
        return _meta((batch, cfg.encoder.source_len, cfg.d_model), dt)
    return None


def _text_len(cfg: ModelConfig, S: int) -> int:
    return S - (cfg.frontend_len if cfg.frontend == "patch_stub" else 0)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor inputs for the step function of ``shape.kind``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    fe = frontend_spec(cfg, B)

    if shape.kind in ("train", "prefill"):
        S_text = _text_len(cfg, S)
        specs = {"tokens": _meta((B, S_text), i32)}
        if shape.kind == "train":
            specs["labels"] = _meta((B, S_text), i32)
        if fe is not None:
            specs["frontend"] = fe
        return specs

    if shape.kind == "decode":
        from repro_torch.models.model import cache_struct

        return {
            "token": _meta((B, 1), i32),
            "caches": cache_struct(cfg, B, S),
            "cache_len": _meta((), i32),
        }
    raise ValueError(shape.kind)
