"""Training substrate: optimizer, train step factory, checkpointing,
data pipeline, fault tolerance, gradient compression, elastic trainer.

The port of ``repro.train``: one process, and the sharded step on a mesh
of processes (``train_step.make_sharded_train_step`` on the specs of
``train_step.train_shardings`` and ``optimizer.state_specs``; ROADMAP
Queue 1 item 5)."""

from repro_torch.train.optimizer import OptConfig, init_state, apply_updates
from repro_torch.train.train_step import (TrainSettings, make_train_step, init_train_state,
                                         make_sharded_train_step, train_shardings)
from repro_torch.train import checkpoint
from repro_torch.train.data import DataState, SyntheticLM

__all__ = [
    "OptConfig",
    "init_state",
    "apply_updates",
    "TrainSettings",
    "make_train_step",
    "init_train_state",
    "make_sharded_train_step",
    "train_shardings",
    "checkpoint",
    "DataState",
    "SyntheticLM",
]
