"""Synthetic deterministic data (counterpart of ``repro.train.data``).

Token streams with Zipf 1.1 marginals over the vocabulary and a copied
half (the second half of each row repeats the first), so that losses are
not degenerate; ``batch(step)`` is random access and fully determined by
(seed, step).  The draws come from a ``torch.Generator`` seeded from
(seed, step), so they are the port's own: jax.random's numbers cannot be
reproduced, and the parity tests feed the JAX package's batches to both
sides.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0


class SyntheticLM:
    """Infinite deterministic batch source; ``batch(step)`` is random
    access."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self.probs = torch.from_numpy(probs / probs.sum())

    def batch(self, step: int, device="cpu") -> dict:
        """{"tokens", "labels"} [B,S] int64 on ``device``: ``labels`` is
        ``tokens`` shifted by one."""
        B, S = self.cfg.batch_size, self.cfg.seq_len
        seed = np.random.SeedSequence([self.cfg.seed, step]).generate_state(
            1, dtype=np.uint64)[0]
        gen = torch.Generator().manual_seed(int(seed))
        tokens = torch.multinomial(self.probs, B * (S + 1), replacement=True,
                                   generator=gen).view(B, S + 1)
        half = (S + 1) // 2
        tokens[:, half:2 * half] = tokens[:, :half]
        tokens = tokens.to(device)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
