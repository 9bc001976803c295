"""Top-level model API (counterpart of ``repro.models.model``): init,
loss, prefill/decode and counting, dispatched on ``ModelConfig``."""
from __future__ import annotations

import math

from repro_torch.models import transformer

init_params = transformer.init_params
forward_hidden = transformer.forward_hidden
chunked_ce_loss = transformer.chunked_ce_loss
lm_loss = transformer.lm_loss
prefill = transformer.prefill
decode_step = transformer.decode_step
init_cache = transformer.init_cache


def count_params(cfg) -> int:
    """Exact parameter count of ``init_params``, from the shapes alone."""
    return sum(math.prod(leaf.shape) for leaf in
               transformer.leaves(transformer.param_spec(cfg)))


def model_flops(cfg, n_tokens: int, *, training: bool) -> float:
    """MODEL_FLOPS: 6·N·D (train) or 2·N·D (inference); every parameter of
    a dense or Mamba-2 model is active."""
    return (6.0 if training else 2.0) * count_params(cfg) * n_tokens
