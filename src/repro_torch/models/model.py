"""Top-level model API (counterpart of ``repro.models.model``): init,
loss, prefill/decode and counting, dispatched on ``ModelConfig``."""
from __future__ import annotations

import math

import torch

from repro_torch.models import transformer

init_params = transformer.init_params


def init_params_shape(cfg, dtype=None):
    """The parameters as tensors on the ``meta`` device: shapes and dtypes
    (each leaf's, or ``dtype`` but for float32 leaves, as ``init_params``)
    and no memory, so even jamba-1.5-large-398b costs nothing (the
    reference's ``init_params_shape``, for the sharding rules and the
    dry-run)."""
    return transformer._tree_map(
        lambda leaf: torch.empty(leaf.shape, device="meta",
                                 dtype=transformer.leaf_dtype(leaf, cfg,
                                                              dtype)),
        transformer.param_spec(cfg))


forward_hidden = transformer.forward_hidden
chunked_ce_loss = transformer.chunked_ce_loss
lm_loss = transformer.lm_loss
prefill = transformer.prefill
decode_step = transformer.decode_step
init_cache = transformer.init_cache


def cache_struct(cfg, B: int, T: int):
    """A decode cache for B rows of capacity T as tensors on the ``meta``
    device (the reference's ``cache_struct``)."""
    return transformer.init_cache(cfg, B, T, device="meta")


def count_params(cfg) -> int:
    """Exact parameter count of ``init_params``, from the shapes alone."""
    return sum(math.prod(leaf.shape) for leaf in
               transformer.leaves(transformer.param_spec(cfg)))


def _moe_block_count(cfg) -> int:
    n = cfg.n_periods * sum(1 for m in cfg.mlp_pattern if m == "moe")
    n += sum(1 for m in cfg.mlp_pattern[: cfg.n_remainder] if m == "moe")
    return n


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Total params; with active_only, MoE experts count only top_k/E."""
    total = count_params(cfg)
    if not active_only or cfg.moe is None:
        return total
    spec = cfg.moe
    per_block_expert = 3 * cfg.d_model * spec.d_ff_expert  # w1,w3,w2
    if cfg.act != "swiglu":
        per_block_expert = 2 * cfg.d_model * spec.d_ff_expert
    inactive = (_moe_block_count(cfg) * (spec.n_experts - spec.top_k)
                * per_block_expert)
    return total - inactive


def model_flops(cfg, n_tokens: int, *, training: bool) -> float:
    """MODEL_FLOPS: 6·N·D (train) or 2·N·D (inference), N the active
    parameters (every one of a dense or Mamba-2 model; of a MoE model's
    experts, top_k of E)."""
    n = count_params_analytic(cfg, active_only=True)
    return (6.0 if training else 2.0) * n * n_tokens
