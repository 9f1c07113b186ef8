"""Estimator API: fit → trained model, Spark-ML style.

The port of the JAX package's ``horovod_tpu/spark/estimator.py``. Parity:
``horovod/spark/common/estimator.py`` (HorovodEstimator / HorovodModel,
``:25-120``) + the per-framework estimators
(``horovod/spark/keras/estimator.py:106``, ``horovod/spark/torch/``).

Structure kept from the reference: an estimator holds params + a store;
``fit`` materializes training data, runs the distributed train function
(each Spark task one port rank), checkpoints on rank 0 into the store,
and returns a Model that can ``transform`` new data. Three estimators:

* :class:`ParamsEstimator` (alias ``FlaxEstimator``) trains a **parameter
  dict** applied to an ``nn.Module`` of the zoo through
  ``torch.func.functional_call``, with an inner optimizer of
  :mod:`horovod_tpu_torch.optimizer` (``adamw``, ``sgd``,
  ``fused_adamw``) in place of optax — the JAX package's Flax module +
  optax estimator;
* :class:`TorchEstimator` trains a module through the port's PyTorch
  frontend (:mod:`horovod_tpu_torch.torch`);
* :class:`KerasEstimator` trains a ``tf.keras`` model through the port's
  Keras frontend (only where TensorFlow is installed).

Data-frame plumbing is gated on pyspark/pandas, while array-based fitting
(``fit_arrays``: the training path the Spark workers run) works anywhere.
Every estimator trains on ``device`` (default: this process's card; pass
``device="cpu"`` for the CPU); batches move there.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .params import EstimatorParams, ModelParams
from .store import Store


def _default_run_id() -> str:
    import time

    return f"run_{int(time.time() * 1000)}"


def auto_loss(label_dtype) -> Callable:
    """``loss="auto"``: mean softmax cross-entropy over every position for
    integer labels (labels ``[..]`` against logits ``[.., V]``, as optax's
    ``softmax_cross_entropy_with_integer_labels`` reads leading
    dimensions), computed in fp32; mean squared error otherwise."""
    if np.issubdtype(np.dtype(label_dtype), np.integer):
        def xent(logits, y):
            return F.cross_entropy(logits.flatten(0, -2).float(),
                                   y.flatten().long())

        return xent

    def mse(logits, y):
        return torch.mean((logits - y) ** 2)

    return mse


def as_batch(a, device) -> torch.Tensor:
    """An array (or tensor) as the estimators feed it to a model: floating
    values as fp32, integers as int64, on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if t.is_floating_point():
        t = t.float()
    elif t.dtype != torch.bool:
        t = t.long()
    return t.to(device)


def module_consts(model, given, device) -> Dict[str, torch.Tensor]:
    """The module's own tensors that ``given`` does not hold (its buffers,
    any parameter left out of the trained dict), on ``device``. They ride
    along through ``functional_call`` as constants, so the module itself
    never moves and holds no second copy of the weights there."""
    own = list(model.named_parameters()) + list(model.named_buffers())
    return {k: v.detach().to(device) for k, v in own if k not in given}


def params_blob(params: Dict[str, torch.Tensor]) -> bytes:
    """A parameter dict as checkpoint bytes (``torch.save`` of CPU
    copies, in key order): equal dicts give equal bytes."""
    buf = io.BytesIO()
    torch.save({k: params[k].detach().cpu() for k in sorted(params)}, buf)
    return buf.getvalue()


def params_from_blob(blob: bytes, device=None) -> Dict[str, torch.Tensor]:
    out = torch.load(io.BytesIO(blob), map_location="cpu")
    return {k: v.to(device) if device is not None else v
            for k, v in out.items()}


class TpuEstimator(EstimatorParams):
    """Framework-agnostic half of the estimator (reference
    ``HorovodEstimator``)."""

    def fit(self, df, params: Optional[Dict] = None):
        """Fit on a DataFrame through the store's sharded data path.

        The reference flow (``keras/estimator.py:106`` +
        ``common/util.py``): materialize the DataFrame as parquet shards
        in the store, then train from per-worker shards — rank 0 writes,
        everyone reads its own slice (round-robin by shard file), so no
        rank ever holds the full dataset. Works with pyspark DataFrames
        (distributed write) and pandas DataFrames (local shard write,
        same on-store layout).
        """
        from . import util as _util

        if params:
            self._set(**params)
        self._ensure_run_id()
        run_id, store = self._prepare_run()
        if store is None:
            raise ValueError(
                "Estimator.fit(df) requires a store (setStore(...)); use "
                "fit_arrays() for in-memory data"
            )
        rank, nproc = self._world()
        num_shards = self.num_proc or max(nproc, 1)
        # Shards are scoped per run_id: re-fitting with new data or a new
        # validation split materializes fresh shards instead of silently
        # reusing a previous run's (the idempotency marker only
        # deduplicates ranks within one run).
        train_path = store.get_train_data_path(run_id)
        val_path = store.get_val_data_path(run_id)
        cols = dict(feature_cols=self.feature_cols or [],
                    label_cols=self.label_cols or [])
        if rank == 0:
            _util.prepare_data(
                store,
                df,
                num_shards=num_shards,
                # Float ratio or val-column name, both per the reference's
                # _train_val_split contract.
                validation=self.validation or None,
                train_path=train_path,
                val_path=val_path,
                **cols,
            )
        if nproc > 1:
            from .. import native

            native.barrier()  # shards visible before anyone reads
        has_val = (
            isinstance(self.validation, float) and self.validation > 0
        ) or (isinstance(self.validation, str) and bool(self.validation))
        val = None
        if has_val:
            # The val set stays in memory (scored whole, reference parity).
            val = _util.read_shard(store, val_path, rank=rank,
                                   num_ranks=nproc, **cols)
        if (
            self.max_rows_in_memory is not None
            and hasattr(self, "fit_stream")
            # Without a streaming open() every pass (including this row
            # probe) would fully re-download the shard — streaming buys
            # nothing there, so stay on the single-fetch in-memory path.
            and _util._has_streaming_open(store)
        ):
            n_rows = _util.shard_row_count(
                store, train_path, rank=rank, num_ranks=nproc
            )
            if n_rows > self.max_rows_in_memory:
                # Beyond-memory path: stream record batches through the
                # loop (the reference's Petastorm-reader flow).
                def stream_factory(batch_rows):
                    return _util.iter_shard_batches(
                        store, train_path, rank=rank, num_ranks=nproc,
                        batch_rows=batch_rows, **cols,
                    )

                return self.fit_stream(
                    stream_factory,
                    n_rows,
                    validation=val,
                    # loss='auto' decides from the SCHEMA's label dtype; a
                    # materialized probe batch can misreport it (nullable
                    # ints surface as float64-with-NaN and would silently
                    # select MSE over cross-entropy).
                    label_dtype=_util.shard_label_dtype(
                        store, train_path, self.label_cols or []
                    ),
                )
        features, labels = _util.read_shard(
            store, train_path, rank=rank, num_ranks=nproc, **cols
        )
        return self.fit_arrays(features, labels, validation=val)

    @staticmethod
    def _world():
        from .. import native

        if native.is_initialized() and native.size() > 1:
            return native.rank(), native.size()
        return 0, 1

    def _device(self) -> torch.device:
        from ..context import resolve_device

        return resolve_device(self.device)

    def _ensure_run_id(self) -> None:
        """Pin one run_id for every rank: rank 0 generates, everyone
        adopts (a per-rank timestamp id would point non-zero ranks'
        models at checkpoints that were never written)."""
        if self.run_id:
            return
        run_id = _default_run_id()
        if self._world()[1] > 1:
            from ..native.objects import broadcast_object

            run_id = broadcast_object(run_id, root_rank=0, name="est.runid")
        self.run_id = run_id

    @staticmethod
    def _global_min_int(value: int) -> int:
        """Cross-rank minimum (step-count agreement for lockstep
        collectives); identity in single-rank worlds."""
        from .. import native

        if native.is_initialized() and native.size() > 1:
            return int(native.allreduce(
                torch.tensor([value], dtype=torch.int64), op=native.MIN,
                name="est.nbmin")[0])
        return value

    @staticmethod
    def _global_mean(value: float, name: str) -> float:
        """Cross-rank average of a monitored metric so every rank picks
        the same best epoch."""
        from .. import native

        if native.is_initialized() and native.size() > 1:
            return float(native.allreduce(
                torch.tensor([value], dtype=torch.float64),
                op=native.AVERAGE, name=name)[0])
        return value

    # Subclasses implement the actual training.
    def fit_arrays(self, features: np.ndarray, labels: np.ndarray,
                   validation=None):
        raise NotImplementedError

    def _run_training_loop(
        self,
        *,
        n_rows: int,
        run_id: str,
        store,
        train_batch: Callable[[np.ndarray], float],
        serialize: Callable[[], bytes],
        restore: Callable[[bytes], None],
        eval_val: Optional[Callable[[], float]] = None,
        indexed: bool = True,
    ) -> Dict[str, List[float]]:
        """The distributed training skeleton shared by every framework
        estimator (one copy of the lockstep invariants, not three):

        * empty-shard fail-fast is COLLECTIVE (``_global_min_int``) so all
          ranks fail together instead of stranding peers in a gradient
          allreduce;
        * the per-epoch step count ``nb`` is agreed from the global-min
          row count (uneven shards must not desync lockstep collectives);
        * the monitored metric is cross-rank averaged so every rank picks
          the same best epoch (replica consistency of the reload);
        * rank 0 writes per-epoch + final checkpoints to the store
          (reference trainers' per-epoch checkpoint + best reload,
          ``keras/estimator.py`` + ``remote.py``).

        Hooks: ``train_batch(idx) -> loss`` runs one optimizer step on
        the given row indices; ``serialize() -> bytes`` /
        ``restore(blob)`` snapshot model weights; ``eval_val() -> loss``
        (optional) scores the validation set. ``history["step_loss"]``
        holds every step's loss in order (the reference keeps the epoch
        means only).
        """
        gmin = self._global_min_int(n_rows)
        if gmin == 0:
            raise ValueError(
                f"a rank received an empty data shard (local rows={n_rows});"
                " the dataset has fewer rows or shard files than the "
                "training world — lower num_proc or repartition the store"
            )
        bs = min(self.batch_size, n_rows)
        history: Dict[str, List[float]] = {"loss": [], "step_loss": []}
        if eval_val is not None:
            history["val_loss"] = []
        rng = np.random.default_rng(0)
        is_writer = self._world()[0] == 0
        best = (float("inf"), None)  # (monitored loss, serialized weights)
        nb = self.train_steps_per_epoch or max(gmin // bs, 1)
        for epoch in range(self.epochs):
            if indexed:
                order = (
                    rng.permutation(n_rows)
                    if self.shuffle
                    else np.arange(n_rows)
                )
            losses = []
            for b in range(nb):
                if indexed:
                    idx = order[(b * bs) % n_rows : (b * bs) % n_rows + bs]
                    if len(idx) < bs:
                        idx = order[:bs]
                else:
                    # Streaming caller pulls its own batches; building an
                    # O(n_rows) permutation here would reintroduce the
                    # per-epoch dataset-sized cost streaming exists to
                    # avoid.
                    idx = None
                losses.append(float(train_batch(idx)))
            history["step_loss"].extend(losses)
            history["loss"].append(float(np.mean(losses)))
            monitored = history["loss"][-1]
            if eval_val is not None:
                vloss = float(eval_val())
                history["val_loss"].append(vloss)
                monitored = vloss
            monitored = self._global_mean(monitored, "est.monitored")
            blob = serialize()
            if store is not None and is_writer:
                store.write(
                    store.get_epoch_checkpoint_path(run_id, epoch), blob
                )
            if monitored < best[0]:
                best = (monitored, blob)
        if best[1] is not None:
            restore(best[1])
        if is_writer:
            self._save_checkpoint(store, run_id, serialize())
        return history

    def _prepare_run(self):
        self._validate()
        run_id = self.run_id or _default_run_id()
        store = self.store
        if isinstance(store, str):
            store = Store.create(store)
        return run_id, store

    def _save_checkpoint(self, store, run_id: str, payload: bytes) -> None:
        if store is not None:
            store.write(store.get_checkpoint_path(run_id), payload)


class TpuModel(ModelParams):
    """Trained-model half (reference ``HorovodModel``): ``transform``
    appends predictions."""

    output_col = "prediction"

    def transform(self, df, params: Optional[Dict] = None):
        """Append predictions to ``df`` (reference ``HorovodModel
        .transform``). pandas DataFrames are handled natively; pyspark
        DataFrames run the model per-partition through ``mapInPandas``.
        """
        del params
        from .util import feature_matrix

        cols = list(self.feature_cols or [])
        if not cols:
            raise ValueError("model has no feature_cols to transform with")
        mod = type(df).__module__
        if mod.startswith("pyspark."):  # pragma: no cover - needs pyspark
            from pyspark.sql.types import (
                ArrayType, DoubleType, StructField, StructType,
            )

            model = self

            def _predict(batches):
                for pdf in batches:
                    preds = np.asarray(
                        model.transform_arrays(feature_matrix(pdf, cols))
                    )
                    out = pdf.copy()
                    out[model.output_col] = [
                        [float(v) for v in np.atleast_1d(p)] for p in preds
                    ]
                    yield out

            # StructType.add mutates in place — build a fresh schema so
            # the input DataFrame's cached schema stays untouched.
            schema = StructType(
                list(df.schema.fields)
                + [StructField(self.output_col, ArrayType(DoubleType()))]
            )
            return df.mapInPandas(_predict, schema=schema)
        preds = np.asarray(self.transform_arrays(feature_matrix(df, cols)))
        out = df.copy()
        # Same per-row representation as the Spark branch: every cell is
        # a 1-D array, scalar model outputs included.
        out[self.output_col] = [np.atleast_1d(p) for p in preds]
        return out

    def transform_arrays(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class ParamsEstimator(TpuEstimator):
    """Train a parameter dict under the estimator contract — the port of
    the JAX package's ``FlaxEstimator`` (a Flax module with optax).

    ``model`` is an ``nn.Module`` (e.g. a zoo model); ``params`` the dict
    of its parameters to train (default: copies of the module's own
    ``named_parameters()``), applied through ``torch.func.functional_call``
    — the module's own buffers ride along as constants on ``device``, and
    the module stays where it is (it may live on ``meta``). ``optimizer`` is an
    :class:`horovod_tpu_torch.optimizer.Optimizer` (``adamw``, ``sgd``,
    ``fused_adamw``); ``loss`` is ``fn(logits, labels) -> scalar`` or
    ``"auto"`` (:func:`auto_loss`). Parameters keep their dtype (fp32 for
    the zoo's bf16-compute models, which cast them at each op). Replicas
    start from rank 0's broadcast; at world > 1 the gradients are averaged
    over the port's runtime (:mod:`horovod_tpu_torch.native`).
    """

    def __init__(self, *, params: Optional[Dict[str, torch.Tensor]] = None,
                 **kw):
        super().__init__(**kw)
        self.params = params

    def fit_arrays(self, features: np.ndarray, labels: np.ndarray,
                   validation=None) -> "ParamsModel":
        run_id, store, session = self._session(np.asarray(labels),
                                               validation)
        x = torch.as_tensor(np.asarray(features))
        y = torch.as_tensor(np.asarray(labels))

        def train_batch(idx):
            t = torch.from_numpy(np.asarray(idx))
            return session["step_on"](x[t], y[t])

        history = self._run_training_loop(
            n_rows=x.shape[0],
            run_id=run_id,
            store=store,
            train_batch=train_batch,
            serialize=session["serialize"],
            restore=session["restore"],
            eval_val=session["eval_val"],
        )
        return self._result(session, history, run_id)

    def fit_stream(self, stream_factory, n_rows: int, validation=None,
                   label_dtype=None) -> "ParamsModel":
        """Train from a re-iterable stream of ``(x, y)`` array batches —
        the beyond-memory path behind ``max_rows_in_memory`` (see
        ``params.py``): each epoch re-opens the stream and consumes
        exact-batch-size chunks; only one record batch is resident.

        ``stream_factory(batch_rows) -> iterator of (x, y)``; ``n_rows``
        is the metadata row count of this rank's shard. ``label_dtype``
        (optional) is the schema-declared label dtype driving
        ``loss='auto'`` — more reliable than the probe batch's
        materialized dtype."""
        # The probe generator holds an open parquet stream; close it
        # explicitly instead of leaving the file handle to the GC.
        # (Plain iterators without close() are also valid factories.)
        gen = stream_factory(self.batch_size)
        try:
            probe = next(gen)
        finally:
            if hasattr(gen, "close"):
                gen.close()
        run_id, store, session = self._session(
            np.asarray(probe[1]), validation, label_dtype=label_dtype,
        )
        bs = min(self.batch_size, n_rows)
        stream_state = {"it": None}

        rng = np.random.default_rng(0)

        def rebatched():
            """Exact-``bs`` chunks from the stream (carrying remainders
            across record batches/files so every step sees one shape);
            the final sub-``bs`` tail of an epoch is dropped, like any
            drop_last loader.  ``shuffle`` permutes rows within each
            record batch (the Petastorm windowed-shuffle trade: file
            order is fixed, rows inside the read window are not)."""
            carry_x, carry_y = None, None
            for bx, by in stream_factory(4 * bs):
                if self.shuffle:
                    perm = rng.permutation(len(bx))
                    bx, by = bx[perm], by[perm]
                if carry_x is not None and len(carry_x):
                    bx = np.concatenate([carry_x, bx])
                    by = np.concatenate([carry_y, by])
                pos = 0
                while pos + bs <= len(bx):
                    yield bx[pos : pos + bs], by[pos : pos + bs]
                    pos += bs
                carry_x, carry_y = bx[pos:], by[pos:]

        def train_batch(_idx):
            if stream_state["it"] is None:
                stream_state["it"] = rebatched()
            try:
                bx, by = next(stream_state["it"])
            except StopIteration:
                stream_state["it"] = rebatched()
                bx, by = next(stream_state["it"])
            return session["step_on"](bx, by)

        history = self._run_training_loop(
            n_rows=n_rows,
            run_id=run_id,
            store=store,
            train_batch=train_batch,
            serialize=session["serialize"],
            restore=session["restore"],
            eval_val=session["eval_val"],
            indexed=False,
        )
        return self._result(session, history, run_id)

    def _result(self, session, history, run_id) -> "ParamsModel":
        return ParamsModel(
            model=self.model, params=session["state"]["params"],
            history=history, run_id=run_id,
            feature_cols=self.feature_cols, label_cols=self.label_cols,
        )

    def _session(self, labels, validation, label_dtype=None):
        """Shared training-session setup for the in-memory and streaming
        paths: the step, DP gradient sync over the runtime, the weight
        broadcast, serialize/restore/eval hooks.

        ``label_dtype`` overrides the materialized ``labels`` dtype for
        the ``loss='auto'`` decision (streaming path: the parquet schema
        knows the declared type, the probe batch may not)."""
        from .. import native
        from ..parallel.dp import accumulate_gradients

        self._ensure_run_id()
        run_id, store = self._prepare_run()
        dev = self._device()
        model, opt = self.model, self.optimizer

        loss_fn = self.loss
        if loss_fn is None or loss_fn == "auto":
            loss_fn = auto_loss(label_dtype if label_dtype is not None
                                else np.asarray(labels).dtype)

        names = {n for n, _ in model.named_parameters()}
        source = (self.params if self.params is not None
                  else dict(model.named_parameters()))
        unknown = sorted(set(source) - names
                         - {n for n, _ in model.named_buffers()})
        if unknown:
            raise ValueError(f"params {unknown} are not the model's")
        params = {k: source[k].detach().to(dev).clone()
                  for k in sorted(source) if k in names}
        consts = module_consts(model, source, dev)
        consts.update({k: source[k].detach().to(dev)
                       for k in sorted(source) if k not in names})
        world = self._world()[1]
        if world > 1:
            # Replicas start identical (reference: broadcast from rank 0).
            for i, k in enumerate(sorted(params)):
                params[k] = native.broadcast(params[k], 0, name=f"est.p.{i}")
        for p in params.values():
            p.requires_grad_(True)
        opt_state = opt.init(params)

        def apply(p, bx):
            return torch.func.functional_call(model, {**consts, **p}, (bx,))

        def objective(p, batch):
            bx, by = batch
            return loss_fn(apply(p, bx), by)

        state = {"params": params, "opt_state": opt_state}

        def step_on(bx, by):
            p = state["params"]
            loss, _, grads = accumulate_gradients(
                objective, p, (as_batch(bx, dev), as_batch(by, dev)), 1)
            with torch.no_grad():
                if world > 1:
                    # Grad sync over the runtime — the Spark world's DP
                    # allreduce (each executor is one rank).
                    grads = {k: native.allreduce(grads[k], op=native.AVERAGE,
                                                 name=f"est.g.{i}")
                             for i, k in enumerate(sorted(grads))}
                updates, state["opt_state"] = opt.update(
                    grads, state["opt_state"], p)
                for k, t in p.items():
                    t.add_(updates[k])
            return loss

        val_xy = None
        if validation is not None:
            vx, vy = validation
            if np.size(vx):
                val_xy = (as_batch(vx, dev), as_batch(vy, dev))

        def eval_val():
            with torch.no_grad():
                return loss_fn(apply(state["params"], val_xy[0]), val_xy[1])

        def restore(blob):
            with torch.no_grad():
                for k, v in params_from_blob(blob).items():
                    state["params"][k].copy_(v)

        session = {
            "state": state,
            "step_on": step_on,
            "serialize": lambda: params_blob(state["params"]),
            "restore": restore,
            "eval_val": eval_val if val_xy is not None else None,
        }
        return run_id, store, session


class ParamsModel(TpuModel):
    """A trained parameter dict and the module it applies to (the port of
    the JAX package's ``FlaxModel``)."""

    def __init__(self, *, model, params, **kw):
        super().__init__(**kw)
        self.model = model
        self.params = params

    def transform_arrays(self, features: np.ndarray) -> np.ndarray:
        dev = next(iter(self.params.values())).device
        with torch.no_grad():
            out = torch.func.functional_call(
                self.model,
                {**module_consts(self.model, self.params, dev),
                 **self.params},
                (as_batch(features, dev),))
        return out.float().cpu().numpy()

    @classmethod
    def load(cls, store: Store, run_id: str, *, model, device=None,
             example: Optional[np.ndarray] = None):
        """Rehydrate from a store checkpoint (reference
        ``read_serialized_keras_model``): the parameters as written, on
        ``device`` (default: this process's card). ``example`` is the JAX
        package's shape hint, unneeded here."""
        from ..context import resolve_device

        del example
        blob = store.read(store.get_checkpoint_path(run_id))
        params = params_from_blob(blob, resolve_device(device))
        return cls(model=model, params=params, run_id=run_id)


# The JAX package's names for the parameter-dict estimator.
FlaxEstimator = ParamsEstimator
FlaxModel = ParamsModel


class TorchEstimator(TpuEstimator):
    """Train a torch module through :mod:`horovod_tpu_torch.torch`
    (reference ``horovod/spark/torch/estimator.py``); the module moves to
    the estimator's device."""

    def fit_arrays(self, features: np.ndarray, labels: np.ndarray,
                   validation=None) -> "TorchModel":
        self._ensure_run_id()
        run_id, store = self._prepare_run()
        dev = self._device()
        model, opt = self.model.to(dev), self.optimizer
        loss_fn = self.loss
        if loss_fn is None or loss_fn == "auto":
            loss_fn = (
                torch.nn.CrossEntropyLoss()
                if np.issubdtype(np.asarray(labels).dtype, np.integer)
                else torch.nn.MSELoss()
            )

        # Wrap in the distributed optimizer when a world is up; plain
        # local training otherwise (the Spark backend runs one of these
        # per rank).
        from ..torch import mpi_ops as hvt_ops

        if hvt_ops.is_initialized() and hvt_ops.size() > 1:
            from ..torch import DistributedOptimizer, broadcast_parameters

            opt = DistributedOptimizer(
                opt, named_parameters=model.named_parameters()
            )
            broadcast_parameters(model.state_dict(), root_rank=0)

        x = torch.as_tensor(np.asarray(features)).float()
        y = torch.as_tensor(np.asarray(labels))
        if y.dtype.is_floating_point:
            y = y.float()
        val_xy = None
        if validation is not None and np.size(validation[0]):
            vx = torch.as_tensor(np.asarray(validation[0])).float()
            vy = torch.as_tensor(np.asarray(validation[1]))
            if vy.dtype.is_floating_point:
                vy = vy.float()
            val_xy = (vx.to(dev), vy.to(dev))

        def train_batch(idx):
            tidx = torch.as_tensor(np.asarray(idx))
            opt.zero_grad()
            loss = loss_fn(model(x[tidx].to(dev)), y[tidx].to(dev))
            loss.backward()
            opt.step()
            return float(loss.detach())

        def eval_val():
            with torch.no_grad():
                return float(loss_fn(model(val_xy[0]), val_xy[1]))

        def serialize():
            buf = io.BytesIO()
            torch.save(model.state_dict(), buf)
            return buf.getvalue()

        history = self._run_training_loop(
            n_rows=len(x),
            run_id=run_id,
            store=store,
            train_batch=train_batch,
            serialize=serialize,
            restore=lambda blob: model.load_state_dict(
                torch.load(io.BytesIO(blob))
            ),
            eval_val=eval_val if val_xy is not None else None,
        )
        return TorchModel(
            model=model, history=history, run_id=run_id,
            feature_cols=self.feature_cols, label_cols=self.label_cols,
        )


class TorchModel(TpuModel):
    def __init__(self, *, model, **kw):
        super().__init__(**kw)
        self.model = model

    def transform_arrays(self, features: np.ndarray) -> np.ndarray:
        dev = next(self.model.parameters()).device
        with torch.no_grad():
            out = self.model(
                torch.as_tensor(np.asarray(features)).float().to(dev))
        return out.cpu().numpy()

    @classmethod
    def load(cls, store: Store, run_id: str, *, model):
        blob = store.read(store.get_checkpoint_path(run_id))
        model.load_state_dict(torch.load(io.BytesIO(blob)))
        return cls(model=model, run_id=run_id)


def _keras_weights_blob(model) -> bytes:
    """Serialize keras weights as an npz blob (architecture travels as
    the user's model object, like a parameter dict vs its module)."""
    buf = io.BytesIO()
    np.savez(buf, *model.get_weights())
    return buf.getvalue()


def _keras_load_weights(model, blob: bytes) -> None:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        model.set_weights([z[k] for k in z.files])


class KerasEstimator(TpuEstimator):
    """Train a compiled-or-not ``tf.keras`` model under the estimator
    contract — the reference's flagship Spark estimator
    (``horovod/spark/keras/estimator.py:106``), on the same store/shard
    plumbing, through the port's Keras frontend. TensorFlow places the
    model itself: ``device`` does not apply.

    ``optimizer`` may be a keras optimizer instance or a string name
    (``"adam"``); ``loss`` a keras loss (string or callable), defaulting
    to sparse categorical cross-entropy for integer labels, MSE
    otherwise.
    """

    def fit_arrays(self, features: np.ndarray, labels: np.ndarray,
                   validation=None) -> "KerasModel":
        import tensorflow as tf

        self._ensure_run_id()
        run_id, store = self._prepare_run()
        model = self.model
        opt = self.optimizer or "adam"
        if isinstance(opt, str):
            opt = tf.keras.optimizers.get(opt)
        loss_fn = self.loss
        if loss_fn is None or loss_fn == "auto":
            loss_fn = (
                tf.keras.losses.SparseCategoricalCrossentropy(
                    from_logits=True
                )
                if np.issubdtype(np.asarray(labels).dtype, np.integer)
                else "mse"
            )

        from .. import native

        world = self._world()[1]
        if world > 1:
            # Gradient averaging through the keras wrapper (the runtime
            # underneath); replicas start from rank 0's weights.
            from ..keras import DistributedOptimizer as _KerasDistOpt

            opt = _KerasDistOpt(opt)
        model.compile(optimizer=opt, loss=loss_fn)

        x = np.asarray(features, np.float32)
        y = np.asarray(labels)
        # Build variables before broadcasting them.
        model(x[: min(2, len(x))])
        if world > 1:
            weights = [
                native.broadcast(torch.from_numpy(np.array(w)), 0,
                                 name=f"est.kw.{i}").numpy()
                for i, w in enumerate(model.get_weights())
            ]
            model.set_weights(weights)

        val_xy = None
        if validation is not None and np.size(validation[0]):
            val_xy = (
                np.asarray(validation[0], np.float32),
                np.asarray(validation[1]),
            )

        history = self._run_training_loop(
            n_rows=len(x),
            run_id=run_id,
            store=store,
            train_batch=lambda idx: np.ravel(
                model.train_on_batch(x[idx], y[idx])
            )[0],
            serialize=lambda: _keras_weights_blob(model),
            restore=lambda blob: _keras_load_weights(model, blob),
            eval_val=(
                (lambda: np.ravel(
                    model.test_on_batch(val_xy[0], val_xy[1])
                )[0])
                if val_xy is not None
                else None
            ),
        )
        return KerasModel(
            model=model, history=history, run_id=run_id,
            feature_cols=self.feature_cols, label_cols=self.label_cols,
        )


class KerasModel(TpuModel):
    def __init__(self, *, model, **kw):
        super().__init__(**kw)
        self.model = model

    def transform_arrays(self, features: np.ndarray) -> np.ndarray:
        return np.asarray(
            self.model(np.asarray(features, np.float32), training=False)
        )

    @classmethod
    def load(cls, store: Store, run_id: str, *, model,
             example: Optional[np.ndarray] = None):
        """Rehydrate from a store checkpoint (reference
        ``read_serialized_keras_model``); ``example`` builds variables
        for uncompiled models."""
        if example is not None:
            model(np.asarray(example, np.float32))
        _keras_load_weights(model, store.read(store.get_checkpoint_path(run_id)))
        return cls(model=model, run_id=run_id)
