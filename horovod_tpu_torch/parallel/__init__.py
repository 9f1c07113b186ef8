"""Parallel training: the data-parallel step (:mod:`.dp`), named process
meshes (:mod:`.mesh`), and the parallelism library on them -- sequence
(:mod:`.sp`), tensor (:mod:`.tp`), pipeline (:mod:`.pp`) and expert
(:mod:`.ep`) parallelism, the hierarchical all-reduce
(:mod:`.hierarchical`), the 3-D parallel GPT (:mod:`.transformer`), and
GSPMD placements as DTensor (:mod:`.gspmd`)."""

from .dp import TrainState, accumulate_gradients, init_state, make_train_step  # noqa: F401
from .ep import switch_moe, switch_moe_stacked, top1_dispatch  # noqa: F401
from .gspmd import shard_params, transformer_param_specs  # noqa: F401
from .hierarchical import hierarchical_allreduce  # noqa: F401
from .pp import pipeline  # noqa: F401
from .sp import ring_attention, ulysses_attention  # noqa: F401
from .tp import column_parallel, row_parallel, tp_mlp  # noqa: F401
from .mesh import (  # noqa: F401
    AXIS_ORDER,
    Mesh,
    build_mesh,
    data_parallel_mesh,
    num_slices,
)
