"""Training of the port (counterpart of ``repro.train``)."""
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, init_opt_state)
from repro_torch.train.train_step import (TrainState, default_opt_cfg,
                                          init_train_state, make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "DataConfig", "SyntheticLM", "AdamWConfig", "AdamWState",
    "adamw_update", "init_opt_state", "TrainState", "default_opt_cfg",
    "init_train_state", "make_train_step", "Trainer", "TrainerConfig",
]
