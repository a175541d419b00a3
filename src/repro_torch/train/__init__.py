"""Training substrate: optimizer, train step factory, checkpointing,
data pipeline, fault tolerance, gradient compression, elastic trainer.

The port of ``repro.train`` for one process. Not ported: the sharding
spec trees (``optimizer.state_specs``, ``train_step.train_shardings``),
which wait for the multi-process step (ROADMAP Queue 1 item 5)."""

from repro_torch.train.optimizer import OptConfig, init_state, apply_updates
from repro_torch.train.train_step import TrainSettings, make_train_step, init_train_state
from repro_torch.train import checkpoint
from repro_torch.train.data import DataState, SyntheticLM

__all__ = [
    "OptConfig",
    "init_state",
    "apply_updates",
    "TrainSettings",
    "make_train_step",
    "init_train_state",
    "checkpoint",
    "DataState",
    "SyntheticLM",
]
