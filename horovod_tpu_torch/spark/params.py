"""Estimator parameter plumbing.

The port of the JAX package's ``horovod_tpu/spark/params.py``, plus the
``device`` the estimators train on. Parity:
``horovod/spark/common/params.py`` (EstimatorParams / ModelParams). The
reference builds on pyspark.ml's Param machinery; this implementation is
dependency-free (plain attributes + fluent setters + ``_validate``) so
the estimator surface exists and is testable whether or not Spark is
installed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class EstimatorParams:
    """Shared estimator knobs, reference names kept (``params.py``)."""

    def __init__(
        self,
        *,
        model: Any = None,
        loss: Any = None,
        optimizer: Any = None,
        metrics: Optional[List] = None,
        feature_cols: Optional[List[str]] = None,
        label_cols: Optional[List[str]] = None,
        validation: Any = None,
        batch_size: int = 32,
        epochs: int = 1,
        num_proc: Optional[int] = None,
        store: Any = None,
        backend: Any = None,
        run_id: Optional[str] = None,
        train_steps_per_epoch: Optional[int] = None,
        validation_steps_per_epoch: Optional[int] = None,
        callbacks: Optional[List] = None,
        shuffle: bool = True,
        verbose: int = 1,
        max_rows_in_memory: Optional[int] = None,
        device: Any = None,
    ):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics or []
        self.feature_cols = feature_cols
        self.label_cols = label_cols
        self.validation = validation
        self.batch_size = batch_size
        self.epochs = epochs
        self.num_proc = num_proc
        self.store = store
        self.backend = backend
        self.run_id = run_id
        self.train_steps_per_epoch = train_steps_per_epoch
        self.validation_steps_per_epoch = validation_steps_per_epoch
        self.callbacks = callbacks or []
        self.shuffle = shuffle
        self.verbose = verbose
        # Beyond-memory datasets: when set and a rank's shard exceeds this
        # many rows, fit() streams parquet record batches through the
        # training loop (util.iter_shard_batches) instead of materializing
        # the shard — the analog of the reference's Petastorm reader path
        # (horovod/spark/keras/remote.py), where training iterates a
        # reader and never holds the dataset. None (default) keeps the
        # in-memory path; streaming shuffles only within record batches.
        self.max_rows_in_memory = max_rows_in_memory
        # Where training runs: None is this process's card, "cpu" the CPU
        # (context.resolve_device); the batches move there.
        self.device = device

    # Fluent setters, pyspark.ml style (setX returns self).
    def _set(self, **kw) -> "EstimatorParams":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown estimator param {k!r}")
            setattr(self, k, v)
        return self

    def setModel(self, value):  # noqa: N802 (reference casing)
        return self._set(model=value)

    def setLoss(self, value):  # noqa: N802
        return self._set(loss=value)

    def setOptimizer(self, value):  # noqa: N802
        return self._set(optimizer=value)

    def setFeatureCols(self, value):  # noqa: N802
        return self._set(feature_cols=value)

    def setLabelCols(self, value):  # noqa: N802
        return self._set(label_cols=value)

    def setBatchSize(self, value):  # noqa: N802
        return self._set(batch_size=value)

    def setEpochs(self, value):  # noqa: N802
        return self._set(epochs=value)

    def setNumProc(self, value):  # noqa: N802
        return self._set(num_proc=value)

    def setStore(self, value):  # noqa: N802
        return self._set(store=value)

    def setRunId(self, value):  # noqa: N802
        return self._set(run_id=value)

    def setMaxRowsInMemory(self, value):  # noqa: N802
        return self._set(max_rows_in_memory=value)

    def _validate(self) -> None:
        missing = [
            name
            for name in ("model", "optimizer", "loss")
            if getattr(self, name) is None
        ]
        if missing:
            raise ValueError(
                f"estimator params not set: {', '.join(missing)}"
            )
        if self.epochs < 1 or self.batch_size < 1:
            raise ValueError("epochs and batch_size must be >= 1")


class ModelParams:
    """Trained-model params (reference ``ModelParams``)."""

    def __init__(self, *, history: Optional[Dict] = None, run_id: str = "",
                 feature_cols: Optional[List[str]] = None,
                 label_cols: Optional[List[str]] = None):
        self.history = history or {}
        self.run_id = run_id
        self.feature_cols = feature_cols
        self.label_cols = label_cols
