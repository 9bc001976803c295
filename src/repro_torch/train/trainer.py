"""Training loop with LLload self-reporting, checkpoint/restart and a
straggler hook — the "user job" side of the paper's pipeline (counterpart
of ``repro.train.trainer``).

Every ``monitor_every`` steps the trainer publishes its measured
utilization (achieved model-FLOP/s over the device's peak, the paper's
"GPU load", plus device memory) into the in-process LLload registry.  On a
card the peak is the H100's for the model's dtype and the memory is
``torch.cuda.max_memory_allocated`` over the card's; on the CPU there is no
device figure, so both must be given.

With a ``ckpt_dir`` the trainer saves every ``ckpt_every`` steps and at
the end, and ``run(resume=True)`` starts from the newest complete
checkpoint there.  Resuming needs nothing else: ``SyntheticLM.batch(step)``
is random access, and the learning rate follows the restored
``opt.step``.
"""
from __future__ import annotations

import dataclasses
import socket
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.launch.fault import (CrashInjector, StragglerDetector,
                                      resume_latest)
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import leaves
from repro_torch.monitor import device_figures, publish_step_utilization
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.train_step import (TrainState, default_opt_cfg,
                                          init_train_state,
                                          init_train_state_shape,
                                          make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    async_ckpt: bool = False      # overlap checkpoint I/O with training
    monitor_every: int = 1
    log_every: int = 10
    seed: int = 0
    job_name: str = "train"
    device: str = "cuda"
    # Device figures for the duty cycle: on a card the H100 peak of the
    # model's dtype and the card's memory; on the CPU both must be given.
    peak_flops: Optional[float] = None
    mem_total_gb: Optional[float] = None


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, *,
                 crash: Optional[CrashInjector] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(tcfg.device)
        self.peak_flops, self.mem_total_gb = device_figures(
            self.device, cfg, tcfg.peak_flops, tcfg.mem_total_gb,
            monitored=bool(tcfg.monitor_every), job="trainer")
        self.opt_cfg = default_opt_cfg(cfg, total_steps=tcfg.steps)
        self.data = SyntheticLM(DataConfig(cfg.vocab_size, tcfg.seq_len,
                                           tcfg.batch_size, tcfg.seed))
        self.step_fn = make_train_step(cfg, self.opt_cfg)
        self.crash = crash
        self.straggler = StragglerDetector()
        self.host = socket.gethostname()
        self.history: list = []
        # model flops per step (6 N D) for the duty-cycle report
        self._flops_per_step = model_lib.model_flops(
            cfg, tcfg.batch_size * tcfg.seq_len, training=True)

    def _init_state(self) -> TrainState:
        return init_train_state(
            self.cfg, torch.Generator().manual_seed(self.tcfg.seed),
            self.opt_cfg, device=self.device)

    def _batch(self, step: int) -> dict:
        """The step's tokens and labels, and its ``frontend`` embeddings
        for a model with a stub frontend."""
        b = self.data.batch(step, self.device)
        fe = self.data.frontend(step, self.cfg, self.device)
        if fe is not None:
            b["frontend"] = fe
        return b

    def _mem_used_gb(self, state) -> float:
        if self.device.type == "cuda":
            return torch.cuda.max_memory_allocated(self.device) / 1e9
        # on the CPU: the bytes of the state (masters and moments)
        return sum(t.numel() * t.element_size()
                   for tree in (state.params, state.opt.m, state.opt.v)
                   for t in leaves(tree)) / 1e9

    def run(self, resume: bool = True) -> dict:
        tc = self.tcfg
        start_step = 0
        state = None
        if tc.ckpt_dir and resume:
            state, start_step = resume_latest(
                tc.ckpt_dir, init_train_state_shape(self.cfg, self.opt_cfg),
                device=self.device)
        if state is None:
            state = self._init_state()
        losses = []
        for step in range(start_step, tc.steps):
            if self.crash is not None:
                self.crash.maybe_crash(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, self._batch(step))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            loss = float(metrics["loss"])
            losses.append(loss)
            self.straggler.record(self.host, dt)
            self.history.append({"step": step, "loss": loss, "time_s": dt})

            if tc.monitor_every and step % tc.monitor_every == 0:
                publish_step_utilization(
                    tc.job_name,
                    model_flops_per_step=self._flops_per_step,
                    step_time_s=dt, peak_flops=self.peak_flops, n_devices=1,
                    hbm_used_gb=self._mem_used_gb(state),
                    hbm_total_gb=self.mem_total_gb)
            if tc.log_every and step % tc.log_every == 0:
                print(f"[train:{self.cfg.name}] step {step} "
                      f"loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            if tc.ckpt_dir and tc.ckpt_every and \
                    (step + 1) % tc.ckpt_every == 0:
                if tc.async_ckpt:
                    ckpt_lib.save_checkpoint_async(tc.ckpt_dir, step + 1,
                                                   state)
                else:
                    ckpt_lib.save_checkpoint(tc.ckpt_dir, step + 1, state)
        if tc.ckpt_dir:
            ckpt_lib.wait_pending_checkpoints()
            ckpt_lib.save_checkpoint(tc.ckpt_dir, tc.steps, state)
        return {"final_loss": losses[-1] if losses else float("nan"),
                "losses": losses, "start_step": start_step, "state": state}
