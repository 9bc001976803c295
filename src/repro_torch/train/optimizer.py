"""AdamW with global-norm clipping and a warmup-cosine schedule
(counterpart of ``repro.train.optimizer``).

Parameters are a nested dict of float32 master tensors, as the model's
tree; the moments are a tree of the same shape in ``moment_dtype``.  The
update is functional: it returns new trees and leaves its inputs as they
were, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.transformer import leaves

F32 = torch.float32


class AdamWState(NamedTuple):
    step: int
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to ``min_lr_ratio``; step 1 already has
    ``lr / warmup_steps``."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _map(fn, *trees, path=()):
    """``fn(path, *leaves)`` over nested dicts of one layout; ``path`` is
    the tuple of keys down to the leaf."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees), path=path + (k,))
                for k in trees[0]}
    return fn(path, *trees)


def init_opt_state(params, cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(_path, p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(0, _map(zeros, params), _map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, taken in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in leaves(tree)))


def _decay_mask(path) -> bool:
    """No weight decay on norms, biases, scalars.  The patterns match the
    reference's string of the last key, ``['scale']`` or ``['D']``, and
    ``'D'`` with its quotes is one of them, so they are matched against
    that string, not against the bare key."""
    name = f"[{path[-1]!r}]" if path else ""
    return not any(s in name for s in ("scale", "norm", "bias", "A_log",
                                       "dt_bias", "'D'"))


def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics); ``metrics`` holds the
    gradients' global norm (a 0-d tensor) and the step's learning rate."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    dt = getattr(torch, cfg.moment_dtype)

    def upd(path, p, g, m, v):
        g = g.to(F32) * scale
        m2 = cfg.b1 * m.to(F32) + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.to(F32) + (1 - cfg.b2) * torch.square(g)
        update = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if _decay_mask(path):
            update = update + cfg.weight_decay * p.to(F32)
        p2 = p.to(F32) - lr * update
        return p2.to(p.dtype), m2.to(dt), v2.to(dt)

    out = _map(upd, params, grads, state.m, state.v)
    new_params, new_m, new_v = (_map(lambda _path, t: t[i], out)
                                for i in range(3))
    return new_params, AdamWState(step, new_m, new_v), \
        {"grad_norm": gnorm, "lr": lr}
