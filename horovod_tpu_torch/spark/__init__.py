"""Spark cluster integration over the port (parity: ``horovod/spark/``,
SURVEY.md §2.2; the port of ``horovod_tpu/spark``).

``run``/``run_elastic`` execute a function as a port world on Spark
executors, each task one rank (reference ``horovod/spark/runner.py:195,
303``); the Estimator API (``ParamsEstimator`` — alias ``FlaxEstimator``
— ``TorchEstimator``, ``KerasEstimator`` + ``Store``) mirrors
``horovod/spark/common/`` (flagship: ``horovod/spark/keras/estimator.py:
106``).

pyspark, pandas, pyarrow, fsspec and TensorFlow are optional and imported
where used: estimators, stores and params work standalone (array-based
fit); only DataFrame plumbing and ``run`` need the rest.
"""

from .estimator import (  # noqa: F401
    FlaxEstimator,
    FlaxModel,
    KerasEstimator,
    KerasModel,
    ParamsEstimator,
    ParamsModel,
    TorchEstimator,
    TorchModel,
    TpuEstimator,
    TpuModel,
)
from .params import EstimatorParams, ModelParams  # noqa: F401
from .runner import run, run_elastic  # noqa: F401
from .store import (  # noqa: F401
    FilesystemStore,
    FsspecStore,
    LocalStore,
    Store,
)
