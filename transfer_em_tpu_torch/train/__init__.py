"""CycleGAN training: the train state, the Keras-exact Adam and the step."""

from .cgan import (build_models, build_step_fn, create_state,
                   cyclegan_losses, make_train_step)
from .state import AdamState, CycleGANState, KerasAdam, make_optimizer

__all__ = ["AdamState", "CycleGANState", "KerasAdam", "build_models",
           "build_step_fn", "create_state", "cyclegan_losses",
           "make_optimizer", "make_train_step"]
