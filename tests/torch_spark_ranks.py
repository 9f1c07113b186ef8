"""Rank-side functions of the Spark, Ray and MXNet parity tests.

``tests/test_torch_port_spark.py``, ``test_torch_port_ray.py`` and
``test_torch_port_mxnet.py`` run these in spawned processes: gloo worlds
(``horovod_tpu_torch.context.spawn_gloo``), ranks started with a Ray
coordinator's environment, and the Keras estimators (TensorFlow is
imported in a spawned process only). This module imports no JAX and
nothing of the JAX package at import time: a spawned rank imports the
module its function lives in, and a JAX import there would slow every
world. The reference-side functions (:func:`keras_fit`, side ``"ref"``,
and :func:`ref_two_rank_fit`, run as ``python torch_spark_ranks.py
<function> ...``) import the JAX package when they run.
"""

from __future__ import annotations

import json
import os
import sys
import types

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FEATURES = ["f0", "f1", "f2", "f3"]


def features_df(n=200, seed=0):
    """The reference's two-rank fit data: 4 normal features, the label
    their sum's sign."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int64)
    return pd.DataFrame({"f0": x[:, 0], "f1": x[:, 1], "f2": x[:, 2],
                         "f3": x[:, 3], "label": y})


# ---------------------------------------------------------------------------
# Two-rank estimator fits (twin of tests/test_spark.py's
# TestDistributedShardFit), inside a spawn_gloo world.


TWO_RANK = dict(loss="auto", feature_cols=FEATURES, label_cols=["label"],
                batch_size=25, epochs=6, validation=0.25)
TWO_RANK_LR = 4.0


def _torch_net(rank: int):
    import torch

    torch.manual_seed(7 + rank)  # replicas differ until the broadcast
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                               torch.nn.Linear(8, 2))


def two_rank_fit(workdir: str, kind: str, start=None) -> dict:
    """Fit on a gloo world of 2 from a pandas frame through the store's
    shards; the estimator's world is the runtime's, started on the
    world's store. ``start`` (kind ``"params"``) is the parameter dict
    rank 0 trains from; rank 1 starts from it moved by one, so the
    replicas agree only through the broadcast. Returns this rank's row
    count, its final parameters and the run's history."""
    import torch

    from horovod_tpu_torch import native
    from horovod_tpu_torch import optimizer as topt
    from horovod_tpu_torch.models.mlp import MLP
    from horovod_tpu_torch.spark import (
        FilesystemStore, ParamsEstimator, TorchEstimator, util,
    )

    native.init(device="cpu")
    try:
        rank, size = native.rank(), native.size()
        store = FilesystemStore(workdir)
        common = dict(TWO_RANK, store=store, run_id=f"dist-{kind}",
                      device="cpu")
        if kind == "torch":
            net = _torch_net(rank)
            est = TorchEstimator(
                model=net, optimizer=torch.optim.SGD(net.parameters(),
                                                     lr=TWO_RANK_LR),
                **common)
        else:
            net = MLP(features=(8,), num_classes=2, in_features=4,
                      device="cpu")
            est = ParamsEstimator(
                model=net, params={k: v + rank for k, v in start.items()},
                optimizer=topt.sgd(TWO_RANK_LR), **common)
        model = est.fit(features_df())
        if kind == "torch":
            params = {k: v.detach().clone()
                      for k, v in model.model.state_dict().items()}
        else:
            params = {k: v.detach().clone() for k, v in model.params.items()}
        shard, val = (util.read_shard(
            store, path(f"dist-{kind}"), rank=rank, num_ranks=size,
            feature_cols=FEATURES, label_cols=["label"])[0]
            for path in (store.get_train_data_path, store.get_val_data_path))
        return {"rank": rank, "rows": int(shard.shape[0]),
                "f0": shard[:, 0].tolist(), "val_f0": val[:, 0].tolist(),
                "params": params, "history": model.history}
    finally:
        native.shutdown()


def ref_two_rank_fit(kind: str, workdir: str, out_path: str) -> None:
    """:func:`two_rank_fit` with the JAX package's estimators, on this
    rank of its native world (``HVT_RANK``, ``HVT_SIZE``,
    ``HVT_COORD_PORT`` from the parent): the same frame, seeds, shards
    and optimizer. History and final parameters (numpy) to ``out_path``
    as a pickle. Imports the JAX package when it runs."""
    import pickle

    import torch

    torch.set_num_threads(1)  # as spawn_gloo's ranks
    from horovod_tpu import native
    from horovod_tpu.spark import FilesystemStore, FlaxEstimator, TorchEstimator

    native.init()
    try:
        rank = native.rank()
        common = dict(TWO_RANK, store=FilesystemStore(workdir),
                      run_id=f"dist-{kind}")
        if kind == "torch":
            est = TorchEstimator(model=_torch_net(rank), optimizer=None,
                                 **common)
            est.optimizer = torch.optim.SGD(est.model.parameters(),
                                            lr=TWO_RANK_LR)
            model = est.fit(features_df())
            params = {k: v.detach().numpy().copy()
                      for k, v in model.model.state_dict().items()}
        else:
            import jax
            import optax
            from flax import serialization

            from horovod_tpu.models.mlp import MLP

            model = FlaxEstimator(
                model=MLP(features=(8,), num_classes=2),
                optimizer=optax.sgd(TWO_RANK_LR), **common,
            ).fit(features_df())
            params = jax.tree.map(
                np.asarray, serialization.to_state_dict(model.params))
        rec = {"rank": rank, "history": dict(model.history),
               "params": params}
    finally:
        native.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(rec, f)


# ---------------------------------------------------------------------------
# MXNet frontend on a gloo world (twins of tests/test_mxnet_contract.py).


class NDArray:
    """The contract tests' ndarray stand-in: ``asnumpy``/``[]``."""

    def __init__(self, data):
        self._data = np.asarray(data)

    def asnumpy(self):
        return self._data

    def __setitem__(self, key, value):
        self._data[key] = value._data if isinstance(value, NDArray) else value

    def __getitem__(self, key):
        return self._data[key]


class Param:
    def __init__(self, data):
        self._data = NDArray(data)
        self.grad_req = "write"
        self._grad = NDArray(np.zeros_like(np.asarray(data)))

    def data(self):
        return self._data

    def set_data(self, v):
        self._data = v

    def list_grad(self):
        return [self._grad]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None, kvstore=None):
        self._params = (list(params.values()) if hasattr(params, "values")
                        else list(params))

    def _allreduce_grads(self):  # overridden by the frontend
        raise NotImplementedError


class SGD:
    def __init__(self, lr=0.1):
        self.lr = lr
        self.updates = []

    def update(self, index, weight, grad, state):
        self.updates.append((index, grad))

    def update_multi_precision(self, index, weight, grad, state):
        self.updates.append((index, grad))


def fake_mx():
    """The contract tests' fake ``mxnet`` module."""
    mx = types.ModuleType("mxnet")
    mx.nd = types.SimpleNamespace(array=NDArray)
    mx.gluon = types.SimpleNamespace(Trainer=Trainer)
    return mx


def mx_world() -> dict:
    """Every MXNet frontend call on this rank of a gloo world: rank ``r``
    holds values ``r + 1`` (and ``arange * (r + 1)``)."""
    sys.modules["mxnet"] = fake_mx()
    import horovod_tpu_torch.mxnet as hvd_mx

    hvd_mx.init(device="cpu")
    try:
        r, n = hvd_mx.rank(), hvd_mx.size()
        base = np.arange(6, dtype=np.float32).reshape(2, 3)
        t = NDArray(base * (r + 1))
        out = {"rank": r, "size": n,
               "avg": hvd_mx.allreduce(t, name="c0").asnumpy(),
               "sum": hvd_mx.allreduce(t, average=False,
                                       name="c1").asnumpy(),
               "gather": hvd_mx.allgather(NDArray(base[: r + 1] * (r + 1)),
                                          name="g0").asnumpy(),
               "bcast": hvd_mx.broadcast(t, root_rank=1,
                                         name="b0").asnumpy()}
        params = {"w": Param(np.full((3,), float(r + 2), np.float32)),
                  "b": Param(np.full((2,), float(-r), np.float32))}
        hvd_mx.broadcast_parameters(params, root_rank=0)
        out["bp"] = {k: p.data().asnumpy() for k, p in params.items()}
        opt = hvd_mx.DistributedOptimizer(SGD())
        g = NDArray(np.full((4,), float(r + 1), np.float32))
        opt.update(0, None, g, None)
        opt.update_multi_precision(1, None, g, None)
        opt.update([2, 3], None, [g, NDArray(np.full((2,), 2.0 * (r + 1),
                                                     np.float32))], None)
        out["opt"] = [(i, [x.asnumpy() for x in gr] if isinstance(gr, list)
                       else gr.asnumpy()) for i, gr in opt.updates]
        tp = {"w": Param(np.zeros((3,), np.float32))}
        tp["w"]._grad = NDArray(np.full((3,), 4.0 * (r + 1), np.float32))
        hvd_mx.DistributedTrainer(tp, "sgd")._allreduce_grads()
        out["trainer"] = tp["w"].list_grad()[0].asnumpy()
        return out
    finally:
        hvd_mx.shutdown()


# ---------------------------------------------------------------------------
# A rank started with a Ray coordinator's environment.


def coordinator_rank(out_path: str) -> None:
    """Form the world from the env a ``Coordinator`` hands this rank:
    ``horovod_tpu_torch.init`` and ``native.init`` over the driver's
    rendezvous KV, one collective on each, results to ``out_path``."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import native
    from horovod_tpu_torch.ops import collectives as C

    hvt.init(device="cpu", backend="gloo")
    native.init(device="cpu")
    try:
        r = hvt.rank()
        dist_sum = C.allreduce(torch.full((3,), float(r + 1)), op=C.Sum)
        rt_sum = native.allreduce(torch.full((2,), float(r + 1)),
                                  name="coord.sum")
        rec = {"rank": r, "size": hvt.size(), "native_rank": native.rank(),
               "native_size": native.size(),
               "local_rank": hvt.local_rank(),
               "dist_sum": dist_sum.tolist(), "rt_sum": rt_sum.tolist()}
    finally:
        native.shutdown()
        hvt.shutdown()
    with open(out_path, "w") as f:
        json.dump(rec, f)


# ---------------------------------------------------------------------------
# The Keras estimators, each in a process of its own.


def xor_data(n=256, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.int64)
    return x, y


def keras_fit(side: str, workdir: str, out_path: str) -> None:
    """The reference's ``TestKerasEstimator`` fit (array and DataFrame
    paths, best reload) with ``side``'s KerasEstimator; histories,
    predictions and checkpoint facts to ``out_path``."""
    import tensorflow as tf

    if side == "ref":
        from horovod_tpu.spark import FilesystemStore, KerasEstimator, KerasModel
    else:
        from horovod_tpu_torch.spark import (
            FilesystemStore, KerasEstimator, KerasModel,
        )

    def build(width):
        return tf.keras.Sequential([
            tf.keras.layers.Dense(width, activation="relu"),
            tf.keras.layers.Dense(2)])

    tf.keras.utils.set_random_seed(0)
    store = FilesystemStore(os.path.join(workdir, side))
    x, y = xor_data()
    model = KerasEstimator(
        model=build(32), optimizer="adam", loss="auto", batch_size=64,
        epochs=8, store=store, run_id="keras1").fit_arrays(x, y)
    again = KerasModel.load(store, "keras1", model=build(32), example=x[:1])
    tf.keras.utils.set_random_seed(0)
    dfm = KerasEstimator(
        model=build(16), optimizer="adam", loss="auto",
        feature_cols=FEATURES, label_cols=["label"], batch_size=32,
        epochs=3, store=store, run_id="krun",
        validation=0.25).fit(features_df(300))
    best = int(np.argmin(dfm.history["val_loss"]))
    rec = {
        "loss": [float(v) for v in model.history["loss"]],
        "preds": model.transform_arrays(x[:8]).tolist(),
        "reloaded": again.transform_arrays(x[:8]).tolist(),
        "accuracy": float((model.transform_arrays(x).argmax(-1)
                           == y).mean()),
        "df_loss": [float(v) for v in dfm.history["loss"]],
        "df_val_loss": [float(v) for v in dfm.history["val_loss"]],
        "best_reloaded": store.read(store.get_checkpoint_path("krun"))
        == store.read(store.get_epoch_checkpoint_path("krun", best)),
    }
    with open(out_path, "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    fn = sys.argv[1]
    if fn == "keras_fit":
        keras_fit(*sys.argv[2:5])
    elif fn == "ref_two_rank_fit":
        ref_two_rank_fit(*sys.argv[2:5])
    elif fn == "coordinator_rank":
        coordinator_rank(sys.argv[2])
    else:
        raise SystemExit(f"unknown function {fn}")
