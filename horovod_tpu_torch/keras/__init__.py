"""Keras frontend over the port's runtime (parity:
``horovod/keras/__init__.py:36-178`` and the shared
``horovod/_keras/__init__.py:28-138``).

The port of the JAX package's ``horovod_tpu/keras/__init__.py``:
``DistributedOptimizer`` and the training callbacks for Keras models, on
the TensorFlow frontend's collectives (:mod:`horovod_tpu_torch.tensorflow`),
which ride the dynamic-enqueue runtime. Keras and TF are optional: the
schedule math and the metric averaging need neither (:mod:`.callbacks`),
and everything that touches a model imports them when called.
"""

from __future__ import annotations

from typing import Optional

from ..tensorflow import (  # noqa: F401  (the reference's surface)
    Adasum,
    Average,
    Compression,
    Sum,
    allgather,
    allreduce,
    barrier,
    broadcast,
    init,
    is_initialized,
    join,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from ..tensorflow import DistributedOptimizer as _tf_distributed_optimizer
from .callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
    PiecewiseSchedule,
    WarmupSchedule,
    average_metrics,
)


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         compression=Compression.none, op: int = Average):
    """Wrap a Keras optimizer so applying gradients allreduces them first
    (reference ``keras/__init__.py:36``)."""
    return _tf_distributed_optimizer(
        optimizer, name=name, compression=compression, op=op
    )


def broadcast_global_variables(root_rank: int = 0):
    from ..tensorflow import broadcast_global_variables as impl

    return impl(root_rank)


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none):
    """Load a Keras model and wrap its optimizer again as distributed
    (reference ``keras/__init__.py:147``)."""
    try:
        import keras
    except ImportError:
        try:
            from tensorflow import keras  # type: ignore
        except ImportError as e:
            raise ImportError(
                "load_model requires the 'keras' or 'tensorflow' package"
            ) from e
    objs = dict(custom_objects or {})
    # Custom optimizer classes resolve by name when deserialized (the
    # reference's _keras.load_model custom_optimizers).
    for opt_cls in custom_optimizers or []:
        objs[opt_cls.__name__] = opt_cls
    model = keras.models.load_model(filepath, custom_objects=objs)
    if getattr(model, "optimizer", None) is not None:
        model.optimizer = DistributedOptimizer(
            model.optimizer, compression=compression
        )
    return model
