"""Synthetic deterministic data (counterpart of ``repro.train.data``).

Token streams with Zipf 1.1 marginals over the vocabulary and a copied
half (the second half of each row repeats the first), so that losses are
not degenerate; ``batch(step)`` is random access and fully determined by
(seed, step), and ``frontend(step, ...)``, the stub frontend's patches or
frames, by (seed + 7919, step) and the device.  The draws come from a
``torch.Generator`` seeded from those, so they are the port's own:
jax.random's numbers cannot be reproduced, and the parity tests feed the
JAX package's batches and frames to both sides.
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


def _generator(seed: int, step: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


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
        tokens = torch.multinomial(self.probs, B * (S + 1), replacement=True,
                                   generator=_generator(self.cfg.seed, step)
                                   ).view(B, S + 1)
        half = (S + 1) // 2
        tokens[:, half:2 * half] = tokens[:, :half]
        tokens = tokens.to(device)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def frontend(self, step: int, cfg_model, device="cpu"):
        """The stub frontend's embeddings of ``step``, standard normal in
        the model dtype, drawn on ``device`` (a card's numbers are not the
        CPU's): [B, frontend_len, d] patches for ``patch_stub``,
        [B, source_len, d] frames for ``audio_stub``; None for a model
        without a frontend."""
        if cfg_model.frontend == "patch_stub":
            n = cfg_model.frontend_len
        elif cfg_model.frontend == "audio_stub":
            n = cfg_model.encoder.source_len
        else:
            return None
        x = torch.randn((self.cfg.batch_size, n, cfg_model.d_model),
                        generator=_generator(self.cfg.seed + 7919, step,
                                             device), device=device)
        return x.to(getattr(torch, cfg_model.dtype))
