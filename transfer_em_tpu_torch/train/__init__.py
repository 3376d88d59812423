"""CycleGAN training: the EM2EM orchestrator, the train state, the
Keras-exact Adam, the step, checkpoints and metrics."""

from .cgan import (EM2EM, BoundModel, build_models, build_step_fn,
                   create_prior_helper, create_state, cyclegan_losses,
                   make_scan_train_step, make_train_step)
from .checkpoints import CheckpointManager
from .metrics import LOSS_NAMES, MetricsLogger, StepTimer, profile_trace
from .state import AdamState, CycleGANState, KerasAdam, make_optimizer

__all__ = ["EM2EM", "BoundModel", "AdamState", "CheckpointManager",
           "CycleGANState", "KerasAdam", "build_models", "build_step_fn",
           "create_prior_helper", "create_state", "cyclegan_losses",
           "make_optimizer", "make_scan_train_step", "make_train_step",
           "LOSS_NAMES",
           "MetricsLogger", "StepTimer", "profile_trace"]
