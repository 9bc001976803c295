"""Batched serving engine with overload-aware admission (counterpart of
``repro.serve.engine``).

The engine runs fixed-capacity decode *slots* (continuous batching: each
slot has its own cache length; finished slots are refilled from the queue
between steps).  Each decode step publishes its achieved utilization to the
LLload job registry, and the :class:`OverloadController` watches the duty
cycle to propose the next slot count 1 -> 2 -> 4 -> 8, as LLSC steps
tasks per GPU.  Decoding is greedy by default; with ``greedy=False`` each
token is drawn from the softmax of the logits over ``temperature``,
cut to the ``top_k`` largest where ``top_k > 0``, by the Gumbel-max rule
(jax.random.categorical's) with a ``torch.Generator`` on the engine's
device seeded from (``seed``, step) as ``train/data.py`` seeds its draws:
the step is 10,000,000 + the request id for a prefill's token and the
decode step's count for a decode step, as the reference's.  jax.random's
numbers cannot be reproduced, so a sampled token is the reference's in
distribution, not in value.

Requests are tokens only, as the reference's: a ``patch_stub`` model
(internvl2) is served as a text-only LM, and an encoder-decoder model
(whisper), which needs frames to encode, is refused; it is served at the
model level (``model.prefill(params, cfg, tokens, frames)``, then
``decode_step``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.overload import (DeviceObservation, OverloadController,
                                       OverloadDecision)
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import leaves
from repro_torch.monitor import device_figures, publish_step_utilization
from repro_torch.train.data import _generator

F32 = torch.float32

# cache leaves with a time axis (attention's k and v, MLA's latent ckv and
# rope key krope); the others (conv, ssd) are per-row states
TIME_AXIS_LEAVES = ("k", "v", "ckv", "krope")


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    submitted_s: float = 0.0


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: List[int]
    prompt_len: int
    latency_s: float = 0.0


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4                # concurrent decode streams (NPPN analog)
    max_seq_len: int = 256
    greedy: bool = True           # False: temperature/top-k sampling
    temperature: float = 1.0
    top_k: int = 0                # 0 = full distribution
    seed: int = 0
    job_name: str = "serve"
    monitor: bool = True
    device: str = "cuda"
    # Device figures for the duty cycle and the controller.  On a card they
    # default to the H100 data-sheet peak for the model's dtype
    # (``monitor.default_peak_flops``) and the card's memory; on the
    # CPU there is no device figure, so a monitored engine needs both.
    peak_flops: Optional[float] = None
    mem_total_gb: Optional[float] = None


class ServeEngine:
    """Single-device engine; slots decode in lockstep with per-slot lengths."""

    def __init__(self, cfg, params, ecfg: EngineConfig):
        if cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.name}: ServeEngine takes token prompts only, and an "
                "encoder-decoder model needs frames to encode; serve it at "
                "the model level (prefill with frames, then decode_step)")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = resolve_device(ecfg.device)
        for t in leaves(params):
            if t.device.type != self.device.type:
                raise ValueError(f"params on {t.device}, engine on "
                                 f"{self.device}")
        self.peak_flops, self.mem_total_gb = device_figures(
            self.device, cfg, ecfg.peak_flops, ecfg.mem_total_gb,
            monitored=ecfg.monitor, job="engine")
        self.queue: deque = deque()
        self.completions: List[Completion] = []
        self.controller = OverloadController()
        self._flops_per_token = model_lib.model_flops(cfg, 1, training=False)
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []

    def submit(self, req: Request):
        req.submitted_s = time.perf_counter()
        self.queue.append(req)

    def sample_generator(self, step: int) -> torch.Generator:
        """The generator of ``step``'s draw, on the engine's device."""
        return _generator(self.ecfg.seed, step, self.device)

    def _select(self, logits, step: int) -> torch.Tensor:
        """Greedy argmax or temperature/top-k sampling. logits [B, V]."""
        ecfg = self.ecfg
        if ecfg.greedy:
            return torch.argmax(logits, dim=-1)
        scaled = logits.to(F32) / max(ecfg.temperature, 1e-6)
        idx = None
        if ecfg.top_k > 0:
            scaled, idx = torch.topk(scaled, ecfg.top_k, dim=-1)
        u = torch.rand(scaled.shape, dtype=F32, device=scaled.device,
                       generator=self.sample_generator(step))
        gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(F32).tiny)))
        choice = torch.argmax(scaled + gumbel, dim=-1)
        if idx is None:
            return choice
        return torch.gather(idx, 1, choice[:, None])[:, 0]

    def _mem_used_gb(self, caches) -> float:
        if self.device.type == "cuda":
            return torch.cuda.max_memory_allocated(self.device) / 1e9
        # on the CPU: the bytes the engine holds (weights and caches)
        return sum(t.numel() * t.element_size()
                   for tree in (self.params, caches)
                   for t in leaves(tree)) / 1e9

    # ------------------------------------------------------------------
    def _prefill_one(self, req: Request, caches, slot: int):
        """Prefill one request and splice its cache rows into slot ``slot``
        by leaf name, as the reference does: ``k`` and ``v`` (``ckv`` and
        ``krope`` for MLA) fill the time axis up to the prompt length and
        are zeroed past it; ``conv`` and
        ``ssd`` states are copied whole.  Returns (prompt_len,
        first_token): the first generated token comes from the prefill
        logits (re-feeding the last prompt token through decode would
        update SSM states twice)."""
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None]
        logits, new = model_lib.prefill(self.params, self.cfg, tokens)
        first_tok = int(self._select(logits, 10_000_000 + req.request_id)[0])
        S = tokens.shape[1]
        for part in ("blocks", "rem"):
            b_ax = 1 if part == "blocks" else 0
            for key, entry in new[part].items():
                for name, src in entry.items():
                    row = caches[part][key][name].select(b_ax, slot)
                    src_row = src.select(b_ax, 0)
                    if name in TIME_AXIS_LEAVES:
                        # the time axis follows the batch axis
                        row.narrow(b_ax, S, row.shape[b_ax] - S).zero_()
                        row = row.narrow(b_ax, 0, S)
                    row.copy_(src_row)
        return S, first_tok

    # ------------------------------------------------------------------
    def run(self, *, max_steps: int = 10_000) -> dict:
        """Drain the queue.  Returns throughput stats."""
        cfg, ecfg = self.cfg, self.ecfg
        B, T = ecfg.slots, ecfg.max_seq_len
        caches = model_lib.init_cache(cfg, B, T, device=self.device)
        lens = np.zeros(B, np.int64)
        active: List[Optional[Request]] = [None] * B
        outputs: List[List[int]] = [[] for _ in range(B)]
        last = np.zeros(B, np.int64)

        t_start = time.perf_counter()
        tokens_out = 0
        steps = 0
        while (self.queue or any(a is not None for a in active)) \
                and steps < max_steps:
            # refill free slots
            for s in range(B):
                if active[s] is None and self.queue:
                    req = self.queue.popleft()
                    t0 = time.perf_counter()
                    S, first = self._prefill_one(req, caches, s)
                    self.prefill_s.append(time.perf_counter() - t0)
                    active[s] = req
                    lens[s] = S
                    outputs[s] = [first]
                    last[s] = first
                    tokens_out += 1
                    if len(outputs[s]) >= req.max_new_tokens:
                        self.completions.append(Completion(
                            req.request_id, outputs[s], len(req.prompt),
                            time.perf_counter() - req.submitted_s))
                        active[s] = None
            if not any(a is not None for a in active):
                break

            t0 = time.perf_counter()
            # each slot writes its new token at position lens[s]; a free slot
            # whose cache filled up (lens == T) writes, unused, at T - 1
            # where JAX's dynamic_update_slice would clamp
            logits, caches = model_lib.decode_step(
                self.params, cfg,
                torch.as_tensor(last[:, None], device=self.device), caches,
                torch.as_tensor(np.minimum(lens, T - 1), device=self.device))
            nxt = self._select(logits, steps).cpu().numpy()  # waits for it
            dt = time.perf_counter() - t0
            self.decode_s.append(dt)
            steps += 1

            n_active = sum(a is not None for a in active)
            for s in range(B):
                if active[s] is None:
                    continue
                outputs[s].append(int(nxt[s]))
                last[s] = nxt[s]
                lens[s] += 1
                tokens_out += 1
                req = active[s]
                if len(outputs[s]) >= req.max_new_tokens or lens[s] >= T:
                    self.completions.append(Completion(
                        req.request_id, outputs[s], len(req.prompt),
                        time.perf_counter() - req.submitted_s))
                    active[s] = None

            if ecfg.monitor:
                achieved = self._flops_per_token * n_active
                mem_used = self._mem_used_gb(caches)
                publish_step_utilization(
                    ecfg.job_name, model_flops_per_step=achieved,
                    step_time_s=dt, peak_flops=self.peak_flops, n_devices=1,
                    hbm_used_gb=mem_used, hbm_total_gb=self.mem_total_gb)
                self.controller.observe(DeviceObservation(
                    duty_cycle=min(1.0, achieved / (dt * self.peak_flops)),
                    mem_used_gb=mem_used, mem_total_gb=self.mem_total_gb))

        wall = time.perf_counter() - t_start
        return {
            "requests": len(self.completions),
            "tokens": tokens_out,
            "steps": steps,
            "wall_s": wall,
            "tokens_per_s": tokens_out / wall if wall > 0 else 0.0,
            "decision": self.controller.decide(ecfg.slots),
        }


def overload_decision(engine: ServeEngine) -> OverloadDecision:
    return engine.controller.decide(engine.ecfg.slots)
