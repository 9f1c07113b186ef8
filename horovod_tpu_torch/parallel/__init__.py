"""Parallel training: the data-parallel step (:mod:`.dp`) and top-1 expert
routing (:mod:`.ep`)."""

from .dp import TrainState, accumulate_gradients, init_state, make_train_step  # noqa: F401
from .ep import top1_dispatch  # noqa: F401
