"""Train step: loss -> grad -> AdamW, with bf16 compute and float32 master
parameters (counterpart of ``repro.train.train_step``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.transformer import (_tree_map, leaf_dtype, leaves,
                                            param_spec)
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, init_opt_state)

F32 = torch.float32


class TrainState(NamedTuple):
    params: dict          # float32 masters
    opt: AdamWState


def init_train_state(cfg, generator: torch.Generator, opt_cfg: AdamWConfig,
                     *, device="cuda") -> TrainState:
    """float32 masters drawn from ``generator`` (a CPU generator) on
    ``device``, and zero moments."""
    params = model_lib.init_params(cfg, generator, device=device, dtype=F32)
    return TrainState(params, init_opt_state(params, opt_cfg))


def init_train_state_shape(cfg, opt_cfg: AdamWConfig) -> TrainState:
    """The train state's structure, shapes and dtypes as tensors on the
    ``meta`` device (the reference's ``init_train_state_shape``): the
    template ``restore_checkpoint`` fills."""
    params = _tree_map(
        lambda leaf: torch.empty(leaf.shape, dtype=leaf_dtype(leaf, cfg, F32),
                                 device="meta"), param_spec(cfg))
    return TrainState(params, init_opt_state(params, opt_cfg))


def cast_params(params, dtype):
    """float32 leaves with more than one dimension in ``dtype``; the others
    as they are.  So the stacked ``ln1``/``ln2`` scales [n_periods, d] take
    the model dtype while ``final_norm``'s [d] stays float32, as the
    reference's ``cast_params`` leaves them; the MoE router [n_periods, d,
    E], an fp32 leaf, takes it too, and ``moe_ffn`` lifts it back to
    float32."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return _tree_map(
        lambda p: p.to(dt) if p.dtype == F32 and p.dim() > 1 else p, params)


def loss_and_grads(params, cfg, batch, *, banded=False, aux_weights=None):
    """(loss, gradients with respect to the float32 masters ``params``) of
    ``lm_loss`` (with the batch's ``frontend`` embeddings where it has
    them, ``banded``, and the MoE auxiliary losses at ``aux_weights``) on
    the masters cast by ``cast_params``; the gradients are float32 and
    laid out as ``params``."""
    masters = _tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model_lib.lm_loss(cast_params(masters, cfg.dtype), cfg,
                             batch["tokens"], batch["labels"],
                             batch.get("frontend"), banded=banded,
                             aux_weights=aux_weights)
    # a leaf the forward does not read (ln2 of a block without FFN) gets a
    # zero gradient, as jax.grad gives it
    grads = iter(torch.autograd.grad(loss, list(leaves(masters)),
                                     materialize_grads=True))
    return loss.detach(), _tree_map(lambda _: next(grads), params)


def make_train_step(cfg, opt_cfg: AdamWConfig, *, banded: bool = False,
                    aux_weights=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds ``tokens`` and ``labels`` [B,S] on the state's device, and the
    metrics are ``loss``, ``grad_norm`` (0-d tensors) and ``lr``.  A model
    with a stub frontend takes its embeddings as the batch's ``frontend``.
    ``banded`` gives local layers the banded attention path (``lm_loss``).
    ``aux_weights=(lb, z)`` enables the MoE load-balance / router-z
    auxiliary losses (ST-MoE defaults: (0.01, 1e-3))."""

    def train_step(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(state.params, cfg, batch, banded=banded,
                                     aux_weights=aux_weights)
        new_params, new_opt, metrics = adamw_update(
            state.params, grads, state.opt, opt_cfg)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt), metrics

    return train_step


def default_opt_cfg(cfg, total_steps: int = 10_000) -> AdamWConfig:
    return AdamWConfig(moment_dtype=cfg.opt_dtype, total_steps=total_steps)
