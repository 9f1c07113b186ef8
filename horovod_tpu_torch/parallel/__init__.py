"""Parallel training: the data-parallel step (:mod:`.dp`)."""

from .dp import TrainState, accumulate_gradients, init_state, make_train_step  # noqa: F401
