"""Worlds of the TensorFlow and Keras frontends' parity tests.

``tests/test_torch_port_tensorflow.py`` and ``test_torch_port_keras.py``
run the same scenarios on the port's frontends
(:mod:`horovod_tpu_torch.tensorflow`, :mod:`horovod_tpu_torch.keras`, on
the port's runtime) and on the JAX package's (``horovod_tpu.tensorflow``,
``horovod_tpu.keras``, on its native runtime). Each side runs a world of 1
(every single-process scenario) and a world of 2 (the cross-rank ones),
each a set of worker processes started here that run the whole suite once
and write their results to a file: importing TensorFlow takes ~15 s a
process, so a test session imports it in these four worlds only, and no
pytest worker carries TF's threads and state into the tests it runs next.

This module imports neither JAX nor TensorFlow at import time: a rank
imports TF and its side's frontend when it starts (:func:`_rank_main`).

Run a rank by hand: ``python tests/torch_tf_ranks.py SIDE RANK SIZE PORT
OUT`` (``SIDE`` ``port`` or ``ref``).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DTYPES = ("float32", "float64", "float16", "bfloat16", "int32", "int64",
          "int8", "uint8")


def _np(t):
    """A TF tensor (or array) as numpy, bfloat16 widened to fp32 (exact)."""
    a = t.numpy() if hasattr(t, "numpy") else np.asarray(t)
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _weights(model):
    return [np.asarray(w) for w in model.get_weights()]


def _values(rank, dtype, n=12, salt=0):
    g = np.random.default_rng(100 * salt + rank)
    if dtype.startswith(("int", "uint")):
        return g.integers(0, 9, n)
    return g.standard_normal(n) * 3


class Api:
    """One side's frontends, TF, and the names that differ between them."""

    def __init__(self, side):
        import tensorflow as tf

        if side == "port":
            import horovod_tpu_torch.keras as hk
            import horovod_tpu_torch.keras.callbacks as cb
            import horovod_tpu_torch.keras.elastic as kel
            import horovod_tpu_torch.tensorflow as hvd
        else:
            import horovod_tpu.keras as hk
            import horovod_tpu.keras.callbacks as cb
            import horovod_tpu.keras.elastic as kel
            import horovod_tpu.tensorflow as hvd
        self.side, self.tf, self.hvd, self.hk = side, tf, hvd, hk
        self.cb, self.kel = cb, kel


def _model(tf, seed, widths=(8, 1), inputs=4):
    tf.keras.utils.set_random_seed(seed)
    model = tf.keras.Sequential(
        [tf.keras.layers.Dense(w, activation="relu" if i < len(widths) - 1
                               else None) for i, w in enumerate(widths)])
    model.build((None, inputs))
    return model


def _data(rank, salt, n=64, inputs=4):
    rs = np.random.RandomState(1000 * salt + rank)
    x = rs.randn(n, inputs).astype(np.float32)
    return x, (x.sum(-1, keepdims=True) > 0).astype(np.float32)


# ---------------------------------------------------------------------------
# World of 1: fn(api, rank, size) -> {key: value}
# ---------------------------------------------------------------------------


def w_eager_dtypes(a, rank, size):
    """Every eager collective on every dtype the bridge carries."""
    tf, hvd = a.tf, a.hvd
    out = {}
    for dt in DTYPES:
        x = tf.constant(_values(rank, dt, salt=1), dtype=getattr(tf, dt))
        is_int = dt.startswith(("int", "uint"))
        out[f"{dt}.avg"] = _np(hvd.allreduce(x, name=f"avg.{dt}"))
        out[f"{dt}.sum_pre"] = _np(hvd.allreduce(
            x, name=f"sp.{dt}", op=hvd.Sum, prescale_factor=2.0))
        if not is_int:
            out[f"{dt}.sum_post"] = _np(hvd.allreduce(
                x, name=f"spo.{dt}", op=hvd.Sum, postscale_factor=0.3))
        for op in ("Min", "Max", "Product"):
            out[f"{dt}.{op}"] = _np(hvd.allreduce(
                x, name=f"{op}.{dt}", op=getattr(hvd, op)))
        out[f"{dt}.gather"] = _np(hvd.allgather(
            tf.reshape(x, (3, 4)), name=f"ag.{dt}"))
        out[f"{dt}.bcast"] = _np(hvd.broadcast(x, root_rank=0,
                                               name=f"bc.{dt}"))
        out[f"{dt}.dtype"] = hvd.allreduce(x, name=f"dt.{dt}").dtype.name
    out["scalar.shape"] = tuple(hvd.allreduce(tf.constant(2.0),
                                              name="scalar").shape)
    return out


def w_compression_and_groups(a, rank, size):
    tf, hvd = a.tf, a.hvd
    x32 = tf.constant(_values(rank, "f", salt=2), tf.float32)
    x64 = tf.constant(_values(rank, "f", salt=3), tf.float64)
    out = {}
    for name, x in (("f32", x32), ("f64", x64)):
        r = hvd.allreduce(x, name=f"fp16.{name}",
                          compression=hvd.Compression.fp16)
        out[f"fp16.{name}"], out[f"fp16.{name}.dtype"] = _np(r), r.dtype.name
    xi = tf.constant(_values(rank, "int32", salt=4), tf.int32)
    for op in ("Average", "Sum"):
        outs = hvd.grouped_allreduce(
            [x32, tf.reshape(x64, (3, 4)), xi], name=f"g.{op}",
            op=getattr(hvd, op))
        out[f"group.{op}"] = [_np(o) for o in outs]
    outs = hvd.grouped_allreduce([x32, x64], name="g.fp16",
                                 compression=hvd.Compression.fp16)
    out["group.fp16"] = [_np(o) for o in outs]
    return out


def w_graph_mode(a, rank, size):
    """``alltoall`` and ``allreduce`` inside ``tf.function``; the scalar
    ops read the world when the graph runs."""
    tf, hvd = a.tf, a.hvd

    @tf.function
    def f(t):
        out, recv = hvd.alltoall(t, name="a2a.graph")
        out2, recv2 = hvd.alltoall(t, splits=[3], name="a2a.split")
        red = hvd.allreduce(t * 2.0, name="ar.graph")
        return out, recv, out2, recv2, red, hvd.size_op() + \
            hvd.rank_op() * 100

    res = f(tf.constant([1.0, 2.0, 3.0]))
    return {"a2a": _np(res[0]), "recv": _np(res[1]), "a2a_split": _np(res[2]),
            "recv_split": _np(res[3]), "ar": _np(res[4]),
            "ops": int(res[5]), "local": (int(hvd.local_size_op()),
                                          int(hvd.local_rank_op()))}


def w_tape_and_optimizer(a, rank, size):
    tf, hvd = a.tf, a.hvd
    x = tf.Variable([1.0, 2.0])
    unused = tf.Variable([5.0])
    with hvd.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = tf.reduce_sum(x * x * 1.5)
    gx, gu = tape.gradient(loss, [x, unused])
    var = tf.Variable([1.0, 1.0])
    var2 = tf.Variable([2.0])
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(learning_rate=0.5))
    opt.apply_gradients([(tf.constant([1.0, 2.0]), var), (None, var2)])
    sv = tf.Variable(3, dtype=tf.int64)
    v1 = tf.Variable([1.0, 2.0])
    hvd.broadcast_variables([v1, sv], root_rank=0)
    return {"gx": _np(gx), "gu_none": gu is None, "var": _np(var),
            "var2": _np(var2), "opt_class": type(opt).__name__,
            "scalar_var": (tuple(sv.shape), int(sv.numpy())),
            "v1": _np(v1)}


def _lr_log(tf, log):
    """A Keras callback that appends the LR of each batch to ``log``."""

    class Rec(tf.keras.callbacks.Callback):
        def on_train_batch_begin(self, batch, logs=None):
            log.append(float(self.model.optimizer.learning_rate.numpy()))

    return Rec()


def w_keras_fit(a, rank, size):
    """A few epochs of a small Keras model under ``DistributedOptimizer``
    with the broadcast and metric-average callbacks (graph mode)."""
    tf, hk = a.tf, a.hk
    model = _model(tf, 0)
    opt = hk.DistributedOptimizer(tf.keras.optimizers.Adam(learning_rate=0.05))
    x, y = _data(rank, 5)
    model.compile(optimizer=opt, loss="mse")
    hist = model.fit(x, y, epochs=3, batch_size=16, verbose=0, shuffle=False,
                     callbacks=[hk.BroadcastGlobalVariablesCallback(0),
                                hk.MetricAverageCallback()])
    return {"weights": _weights(model), "loss": hist.history["loss"],
            "opt_class": type(model.optimizer).__name__}


def w_lr_callbacks(a, rank, size):
    """The warmup (at a pretended world of 8, as the reference's test does)
    and the schedule callback: the LR of every batch."""
    tf, hk = a.tf, a.hk
    out = {}
    with mock.patch.object(a.cb.native, "size", return_value=8):
        model = _model(tf, 1, widths=(1,), inputs=2)
        model.compile(optimizer=tf.keras.optimizers.SGD(0.8), loss="mse")
        log = []
        cb = hk.LearningRateWarmupCallback(initial_lr=0.8, warmup_epochs=2,
                                           steps_per_epoch=4)
        model.fit(np.zeros((8, 2), np.float32), np.zeros((8, 1), np.float32),
                  epochs=3, batch_size=2, verbose=0, shuffle=False,
                  callbacks=[cb, _lr_log(tf, log)])
        out["warmup"] = log
    model = _model(tf, 1, widths=(1,), inputs=2)
    model.compile(optimizer=tf.keras.optimizers.SGD(1.0), loss="mse")
    log = []
    cb = hk.LearningRateScheduleCallback(1.0, [(0, 1.0), (1, 0.1), (2, 0.01)])
    x, y = _data(rank, 6, n=8, inputs=2)
    model.fit(x, y, epochs=3, batch_size=4, verbose=0, shuffle=False,
              callbacks=[cb, _lr_log(tf, log)])
    out["schedule"] = log
    out["schedule_weights"] = _weights(model)
    sched = hk.WarmupSchedule(warmup_epochs=2, steps_per_epoch=10,
                              world_size=8)
    out["warmup_table"] = [sched.multiplier(e, b) for e in range(3)
                           for b in (0, 5, 9)]
    table = hk.PiecewiseSchedule([(0, 1.0), (30, 0.1), (60, 0.01)])
    out["piecewise"] = [table.multiplier(e) for e in (0, 29, 30, 75)]
    out["metrics"] = hk.average_metrics({"loss": 2.0, "acc": 0.5,
                                         "name": "not-a-number"})
    logs = {"loss": 4.0}
    hk.MetricAverageCallback().on_epoch_end(0, logs)
    out["metric_cb"] = logs
    return out


def w_objects(a, rank, size):
    """The object broadcast and gather, the process surface, join, the
    barrier and the timeline."""
    tf, hvd = a.tf, a.hvd
    obj = {"epoch": 3, "names": ["a", "b"], "arr": np.arange(4)}
    got = hvd.broadcast_object(obj, root_rank=0)
    out = {"bcast": got, "fn": hvd.broadcast_object_fn(root_rank=0)(42),
           "gather": hvd.allgather_object({"rank": hvd.rank()}),
           "rank_size": (hvd.rank(), hvd.size(), hvd.local_rank(),
                         hvd.local_size()),
           "initialized": hvd.is_initialized()}
    path = os.path.join(tempfile.mkdtemp(prefix="hvt-tl-"), "timeline.json")
    hvd.start_timeline(path)
    hvd.allreduce(tf.ones(2), name="tl.ar")
    hvd.stop_timeline()
    out["timeline"] = path  # read after the shutdown (the JAX package's
    # runtime writes its timeline out then)
    hvd.barrier()
    out["join"] = hvd.join()
    return out


class FakeState:
    def __init__(self):
        self.commits = 0
        self.batch = 0
        self.epoch = 0

    def commit(self):
        self.commits += 1


def w_elastic(a, rank, size):
    """``TensorFlowKerasState``'s commit, restore and sync, and the three
    elastic callbacks' cadence and epoch trims."""
    tf, hvd, kel = a.tf, a.hvd, a.kel
    model = _model(tf, 2, widths=(2,), inputs=3)
    opt = tf.keras.optimizers.Adam(0.01)
    opt.build(model.trainable_variables)
    state = hvd.TensorFlowKerasState(model=model, optimizer=opt, epoch=10,
                                     batch=0)
    state.sync()
    state.commit()
    saved = _weights(model)
    model.set_weights([np.zeros_like(w) for w in saved])
    state.epoch = 99
    state.restore()
    out = {"restored": _weights(model), "saved": saved, "epoch": state.epoch,
           "opt_vars": [np.asarray(v.numpy()) for v in opt.variables]}
    st = FakeState()
    cb = kel.CommitStateCallback(st, batches_per_commit=2)
    cb.on_train_begin()
    for b in range(5):
        cb.on_train_batch_end(b)
    out["commits"] = [st.commits]
    cb.on_epoch_end(0)
    out["commits"].append(st.commits)
    st = FakeState()
    st.batch = 30
    cb = kel.UpdateBatchStateCallback(st)
    cb.params = {"steps": 100}
    cb.on_train_begin()
    cb.on_epoch_begin(0)
    trims = [cb.params["steps"]]
    cb.on_train_batch_end(0)
    trims.append(st.batch)
    cb.on_train_batch_end(4)
    trims.append(st.batch)
    cb.on_epoch_end(0)
    trims += [st.batch, cb.params["steps"]]
    out["trims"] = trims
    st = FakeState()
    kel.UpdateEpochStateCallback(st).on_epoch_end(4)
    out["epoch_cb"] = st.epoch
    return out


def w_load_model(a, rank, size):
    tf, hk = a.tf, a.hk
    model = _model(tf, 3, widths=(2,), inputs=3)
    model.compile(optimizer=tf.keras.optimizers.Adam(0.01), loss="mse")
    x, y = _data(rank, 7, n=8, inputs=3)
    model.fit(x, y[:, :1].repeat(2, 1), epochs=1, verbose=0, shuffle=False)
    path = os.path.join(tempfile.mkdtemp(prefix="hvt-tf-"), "model.keras")
    model.save(path)
    loaded = hk.load_model(path)
    loaded.fit(x, y[:, :1].repeat(2, 1), epochs=1, verbose=0, shuffle=False)
    return {"opt_class": type(loaded.optimizer).__name__,
            "weights": _weights(loaded)}


def w_sync_bn(a, rank, size):
    """At one rank ``SyncBatchNormalization`` is ``BatchNormalization``."""
    tf, hvd = a.tf, a.hvd
    x = tf.constant(np.random.RandomState(8).randn(6, 3), tf.float32)
    bn = hvd.SyncBatchNormalization(axis=-1, momentum=0.5, epsilon=1e-3)
    plain = tf.keras.layers.BatchNormalization(axis=-1, momentum=0.5,
                                               epsilon=1e-3)
    return {"sync": _np(bn(x, training=True)),
            "plain": _np(plain(x, training=True)),
            "moving_mean": _np(bn.moving_mean)}


SUITE_1 = [w_eager_dtypes, w_compression_and_groups, w_graph_mode,
           w_tape_and_optimizer, w_keras_fit, w_lr_callbacks, w_objects,
           w_elastic, w_load_model, w_sync_bn]


# ---------------------------------------------------------------------------
# World of 2
# ---------------------------------------------------------------------------


def x_collectives(a, rank, size):
    tf, hvd = a.tf, a.hvd
    t = tf.fill((4,), float(rank + 1))
    out = {"avg": _np(hvd.allreduce(t, name="ar")),
           "bcast": _np(hvd.broadcast(tf.fill((2,), float(rank)),
                                      root_rank=1, name="b")),
           "gather": _np(hvd.allgather(tf.fill((rank + 1, 2), rank),
                                       name="ag"))}
    x = tf.constant(_values(rank, "f", salt=9), tf.float32)
    out["random_avg"] = _np(hvd.allreduce(x, name="ar.r"))
    out["random_fp16"] = _np(hvd.allreduce(
        x, name="ar.h", compression=hvd.Compression.fp16))
    outs = hvd.grouped_allreduce(
        [x, tf.constant(_values(rank, "int32", salt=10), tf.int32)],
        name="g2", op=hvd.Sum)
    out["group"] = [_np(o) for o in outs]
    rows = tf.constant([rank * 10 + j for j in range(3)], tf.int64)
    got, recv = hvd.alltoall(rows, splits=[1, 2] if rank == 0 else [2, 1],
                             name="a2a")
    out["a2a"], out["a2a_recv"] = _np(got), _np(recv)
    out["objects"] = hvd.allgather_object({"rank": rank})
    out["bobj"] = hvd.broadcast_object({"from": rank}, root_rank=1)
    hvd.barrier()
    # Join's last rank depends on arrival order: record whether it is one
    # of the world's ranks.
    out["join_in_world"] = hvd.join() in range(size)
    return out


def x_train_step(a, rank, size):
    """A ``tf.function`` train step with ``DistributedGradientTape``: the
    ranks' data differ, the averaged gradients keep the weights alike."""
    tf, hvd = a.tf, a.hvd
    model = _model(tf, 7 + rank)  # unlike weights until the broadcast
    opt = tf.keras.optimizers.SGD(0.05)
    rs = np.random.RandomState(100 + rank)
    x = tf.constant(rs.randn(32, 4), tf.float32)
    y = tf.constant(rs.randn(32, 1), tf.float32)

    @tf.function
    def train_step(xb, yb):
        with tf.GradientTape() as tape:
            loss = tf.reduce_mean((model(xb, training=True) - yb) ** 2)
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        return loss

    hvd.broadcast_variables(model.variables, root_rank=0)
    losses = [float(train_step(x, y)) for _ in range(20)]
    return {"weights": _weights(model), "losses": losses}


def x_keras_fit(a, rank, size):
    tf, hk = a.tf, a.hk
    model = _model(tf, 11)
    opt = hk.DistributedOptimizer(tf.keras.optimizers.SGD(0.02))
    model.compile(optimizer=opt, loss="mse")
    x, y = _data(rank, 12)
    hist = model.fit(x, y, epochs=2, batch_size=16, verbose=0, shuffle=False,
                     callbacks=[hk.BroadcastGlobalVariablesCallback(0),
                                hk.MetricAverageCallback()])
    return {"weights": _weights(model), "loss": hist.history["loss"]}


def x_sync_bn(a, rank, size):
    """Global batch statistics with disjoint inputs a rank, and gradients
    through the differentiable allreduce."""
    tf, hvd = a.tf, a.hvd
    bn = hvd.SyncBatchNormalization(axis=-1, momentum=0.5, epsilon=1e-3)
    x_all = np.arange(16, dtype=np.float32).reshape(8, 2)
    x_mine = x_all[rank * 4:(rank + 1) * 4]
    out = {"y": _np(bn(tf.constant(x_mine), training=True)),
           "moving_mean": _np(bn.moving_mean),
           "moving_var": _np(bn.moving_variance)}
    bn2 = hvd.SyncBatchNormalization(axis=-1)
    x = tf.constant(np.random.RandomState(rank).randn(4, 3), tf.float32)
    with tf.GradientTape() as tape:
        tape.watch(x)
        y = bn2(x, training=True)
        loss = tf.reduce_sum(y * y * tf.constant([1.0, 2.0, 3.0]))
    out["grad"] = _np(tape.gradient(loss, x))
    return out


def x_state(a, rank, size):
    """``TensorFlowKerasState.sync`` brings rank 0's weights, optimizer
    variables and values to every rank; commit and restore round-trip."""
    tf, hvd = a.tf, a.hvd
    model = _model(tf, 13, widths=(2,), inputs=3)
    opt = tf.keras.optimizers.Adam(0.01)
    opt.build(model.trainable_variables)
    model.set_weights([np.full_like(w, rank + 1.0)
                       for w in model.get_weights()])
    for v in opt.variables:
        v.assign(tf.fill(v.shape, tf.cast(rank + 2, v.dtype)))
    state = hvd.TensorFlowKerasState(model=model, optimizer=opt,
                                     epoch=10 + rank, batch=0)
    state.sync()
    out = {"synced": _weights(model), "epoch": state.epoch,
           "opt_vars": [np.asarray(v.numpy()) for v in opt.variables]}
    state.commit()
    model.set_weights([np.zeros_like(w) for w in model.get_weights()])
    state.epoch = 99
    state.restore()
    out["restored"] = _weights(model)
    out["restored_epoch"] = state.epoch
    return out


SUITE_2 = [x_collectives, x_train_step, x_keras_fit, x_sync_bn, x_state]


# ---------------------------------------------------------------------------
# One rank's main, and the world runner.
# ---------------------------------------------------------------------------


def _rank_main(side, rank, size, port, out):
    os.environ.update(HVT_RANK=str(rank), HVT_SIZE=str(size),
                      HVT_COORD_PORT=str(port))
    a = Api(side)
    a.tf.config.experimental.enable_op_determinism()
    if side == "port":
        a.hvd.init(rank, size, "127.0.0.1", port, device="cpu")
    else:
        a.hvd.init()
    results = {}
    for case in SUITE_1 if size == 1 else SUITE_2:
        t0 = time.perf_counter()
        results[case.__name__] = case(a, rank, size)
        results[case.__name__]["_seconds"] = time.perf_counter() - t0
    a.hvd.shutdown()
    for res in results.values():
        if "timeline" in res:
            with open(res["timeline"]) as f:
                res["timeline"] = "tl.ar" in f.read()
    with open(out, "wb") as f:
        pickle.dump(results, f)


def _start(side: str, size: int):
    from torch_eager_ranks import _free_port

    tmp = tempfile.mkdtemp(prefix=f"hvt-tf-{side}-")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
               HVT_DATA_TIMEOUT_SECS="60", TF_CPP_MIN_LOG_LEVEL="2",
               OMP_NUM_THREADS="1", TF_NUM_INTRAOP_THREADS="1",
               TF_NUM_INTEROP_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE", "HVT_LOCAL_RANK",
              "HVT_LOCAL_SIZE"):
        env.pop(k, None)
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(size)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), side, str(r), str(size),
         str(port), outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(size)]
    return procs, outs


def run_worlds(worlds, timeout: float = 240.0):
    """Run the suites of ``worlds`` (``(side, size)`` pairs), all at once;
    ``{(side, size): [each rank's {case: {key: value}}, in rank order]}``."""
    started = {w: _start(*w) for w in worlds}
    deadline = time.time() + timeout
    logs = {w: [] for w in worlds}
    for w, (procs, _) in started.items():
        for p in procs:
            try:
                logs[w].append(p.communicate(
                    timeout=max(1.0, deadline - time.time()))[0].decode())
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs[w].append(p.communicate()[0].decode())
    failed = [(w, [p.returncode for p in started[w][0]]) for w in worlds
              if any(p.returncode for p in started[w][0])]
    if failed:
        raise RuntimeError(
            f"TF worlds failed: {failed}\n" + "\n".join(
                log[-6000:] for w, _ in failed for log in logs[w]))
    results = {}
    for w, (_, outs) in started.items():
        results[w] = []
        for path in outs:
            with open(path, "rb") as f:
                results[w].append(pickle.load(f))
    return results


if __name__ == "__main__":
    side, rank, size, port, out = sys.argv[1:6]
    _rank_main(side, int(rank), int(size), int(port), out)
