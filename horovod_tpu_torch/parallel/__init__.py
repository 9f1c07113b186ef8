"""Parallel training: the data-parallel step (:mod:`.dp`), top-1 expert
routing (:mod:`.ep`) and named process meshes (:mod:`.mesh`)."""

from .dp import TrainState, accumulate_gradients, init_state, make_train_step  # noqa: F401
from .ep import top1_dispatch  # noqa: F401
from .mesh import (  # noqa: F401
    AXIS_ORDER,
    Mesh,
    build_mesh,
    data_parallel_mesh,
    num_slices,
)
