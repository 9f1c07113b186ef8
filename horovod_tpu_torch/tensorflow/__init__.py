"""TensorFlow frontend over the port's runtime (parity:
``horovod/tensorflow/__init__.py``).

The port of the JAX package's ``horovod_tpu/tensorflow/__init__.py``: the
reference's TF surface -- ``init``/``rank``/``size``, eager collectives,
``DistributedOptimizer`` (``:568``), ``DistributedGradientTape``
(``:673``), ``broadcast_variables`` (``:263``), fp16 compression -- on
the dynamic-enqueue runtime (:mod:`horovod_tpu_torch.native`) that serves
the torch frontend. TF tensors become numpy arrays, and numpy arrays CPU
tensors (``torch.from_numpy``), which the runtime moves on its gloo group
whatever device it was started for; results come back the same way.

TensorFlow is optional: every function body imports it lazily and raises
a clean ImportError without it, so this module always imports and nothing
else of the package depends on TF. As in the JAX package there are no
graph-mode custom ops (``horovod/tensorflow/mpi_ops.cc:374-430``): TF2
eager and ``tf.function`` through ``tf.numpy_function``.

:func:`init` starts the runtime on this process's card like every entry
point of the package; a process without one passes ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import native
from ..exceptions import HorovodInternalError

# Reduction ops (the runtime's codes).
Sum = native.SUM
Average = native.AVERAGE
Min = native.MIN
Max = native.MAX
Product = native.PRODUCT
Adasum = native.ADASUM


def _tf():
    try:
        import tensorflow as tf

        return tf
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.tensorflow requires the 'tensorflow' package; "
            "the port's training path is horovod_tpu_torch (PyTorch)"
        ) from e


# -- process control (the runtime's world) ------------------------------


def init(*args, **kwargs):
    """Start the runtime: ``native.init(rank, size, coord_addr,
    coord_port, device)``."""
    return native.init(*args, **kwargs)


def shutdown():
    return native.shutdown()


def is_initialized() -> bool:
    return native.is_initialized()


def rank() -> int:
    r = native.rank()
    if r < 0:
        raise HorovodInternalError(
            "horovod_tpu_torch.tensorflow not initialized")
    return r


def size() -> int:
    s = native.size()
    if s < 0:
        raise HorovodInternalError(
            "horovod_tpu_torch.tensorflow not initialized")
    return s


def local_rank() -> int:
    v = os.environ.get("HVT_LOCAL_RANK")
    return int(v) if v is not None else rank()


def local_size() -> int:
    v = os.environ.get("HVT_LOCAL_SIZE")
    return int(v) if v is not None else size()


# -- compression --------------------------------------------------------


class Compression:
    """Gradient compression (reference ``compression.py:20-67``)."""

    class none:
        @staticmethod
        def compress(tensor):
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            return tensor

    class fp16:
        @staticmethod
        def compress(tensor):
            tf = _tf()
            if tensor.dtype in (tf.float32, tf.float64):
                return tf.cast(tensor, tf.float16), tensor.dtype
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            tf = _tf()
            return tensor if ctx is None else tf.cast(tensor, ctx)


# -- numpy <-> the runtime's CPU tensors ---------------------------------


def _torch(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s bytes (bfloat16 through its bits)."""
    arr = np.asarray(arr)  # 0-d stays 0-d (np.ascontiguousarray makes 1-d)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy(order="C")
    if arr.dtype.name == "bfloat16":  # ml_dtypes, as TF hands it out
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _numpy(t: torch.Tensor, like: np.dtype) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(like)
    return t.numpy()


def _to_numpy(value) -> np.ndarray:
    tf = _tf()
    return value.numpy() if tf.is_tensor(value) else np.asarray(value)


def _bridge(np_fn, value, *, same_shape: bool):
    """Run a numpy -> numpy collective on a TF tensor: directly when
    eager; inside ``tf.function`` tracing (Keras ``fit``'s train step) as
    a ``tf.numpy_function`` node, which calls the runtime when the graph
    runs -- the counterpart of the reference's AsyncOpKernel custom ops
    (``tensorflow/mpi_ops.cc:374``)."""
    tf = _tf()
    if tf.executing_eagerly():
        return tf.convert_to_tensor(np_fn(_to_numpy(value)))
    out = tf.numpy_function(np_fn, [value], Tout=value.dtype)
    if same_shape:
        out.set_shape(value.shape)
    return out


# -- eager collectives --------------------------------------------------


def allreduce(value, name: Optional[str] = None, op: int = Average,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=Compression.none):
    """Differentiable allreduce, eager or inside ``tf.function``
    (reference ``__init__.py:54-154``; dense tensors only).

    Its gradient is an allreduce of the upstream gradient with the same
    reduction (``horovod/tensorflow/mpi_ops.py:117-127``), so collectives
    inside a model -- sync batch norm -- backpropagate across ranks in
    eager tapes and compiled graphs alike.
    """
    tf = _tf()
    orig_op = op
    value, ctx = compression.compress(tf.convert_to_tensor(value))
    # Average divides at RUN time, not at trace time: a tf.function traced
    # at one world size must not bake a stale 1/size into its graph (after
    # an elastic rescale the ranks would negotiate mismatched postscales;
    # the reference switches to size_op() under HOROVOD_ELASTIC, :99).
    average = op == Average
    if average:
        op = Sum
    the_name = name or "tf.allreduce"

    def np_fn(arr, _op=op, _pre=prescale_factor, _post=postscale_factor):
        post = _post / size() if average else _post
        arr = np.asarray(arr)
        out = native.allreduce(_torch(arr), op=_op, name=the_name,
                               prescale=_pre, postscale=post)
        return _numpy(out, arr.dtype)

    @tf.custom_gradient
    def _reduce(v):
        out = _bridge(np_fn, v, same_shape=True)

        def grad(dy):
            return allreduce(
                dy, name=f"{the_name}.grad", op=orig_op,
                prescale_factor=prescale_factor,
                postscale_factor=postscale_factor,
            )

        return out, grad

    return compression.decompress(_reduce(value), ctx)


def grouped_allreduce(values, name: Optional[str] = None, op: int = Average,
                      compression=Compression.none):
    tf = _tf()
    gname = name or "tf.group"
    post = 1.0
    the_op = op
    if op == Average:
        the_op, post = Sum, 1.0 / size()

    if not tf.executing_eagerly():
        # Graph mode: one node a tensor (the graph's execution order is the
        # scheduler's, and a group held until whole could deadlock a
        # serialized executor; the runtime still fuses what one cycle sees).
        return [
            allreduce(v, name=f"{gname}.{i}", op=op, compression=compression)
            for i, v in enumerate(values)
        ]

    arrs, ctxs = [], []
    for v in values:
        v, ctx = compression.compress(tf.convert_to_tensor(v))
        ctxs.append(ctx)
        arrs.append(_to_numpy(v))
    tensors = [_torch(a) for a in arrs]
    handles = native.grouped_allreduce_async(
        [f"{gname}.{i}" for i in range(len(values))], tensors, op=the_op,
        postscale=post, group_name=gname,
    )
    return [
        compression.decompress(
            tf.convert_to_tensor(_numpy(native.synchronize(h), a.dtype)), ctx
        )
        for h, a, ctx in zip(handles, arrs, ctxs)
    ]


def allgather(value, name: Optional[str] = None):
    the_name = name or "tf.allgather"

    def np_fn(arr):
        arr = np.asarray(arr)
        return _numpy(native.allgather(_torch(arr), name=the_name),
                      arr.dtype)

    return _bridge(np_fn, _tf().convert_to_tensor(value), same_shape=False)


def broadcast(value, root_rank: int = 0, name: Optional[str] = None):
    the_name = name or "tf.broadcast"

    def np_fn(arr):
        arr = np.asarray(arr)
        return _numpy(native.broadcast(_torch(arr), root_rank=root_rank,
                                       name=the_name), arr.dtype)

    return _bridge(np_fn, _tf().convert_to_tensor(value), same_shape=True)


def alltoall(value, splits=None, name: Optional[str] = None):
    tf = _tf()
    the_name = name or "tf.alltoall"
    value = tf.convert_to_tensor(value)
    splits_np = None if splits is None else _to_numpy(splits)

    def np_fn(arr):
        arr = np.asarray(arr)
        out, recv = native.alltoall(
            _torch(arr), splits=None if splits_np is None
            else [int(s) for s in splits_np], name=the_name)
        return _numpy(out, arr.dtype), recv.numpy().astype(np.int32)

    if tf.executing_eagerly():
        out, recv = np_fn(_to_numpy(value))
        return tf.convert_to_tensor(out), tf.convert_to_tensor(recv)
    out, recv = tf.numpy_function(
        np_fn, [value], Tout=(value.dtype, tf.int32)
    )
    return out, recv


def join() -> int:
    return native.join()


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start the chrome-tracing timeline (parity: ``hvd.start_timeline``,
    reference ``operations.cc:740-766``)."""
    del mark_cycles  # cycle marks ride HVT_TIMELINE_MARK_CYCLES
    native.timeline_start(file_path)


def stop_timeline() -> None:
    native.timeline_stop()


# -- graph-friendly scalar ops + object helpers --------------------------
# Parity: rank_op/size_op/local_*_op (reference mpi_ops.cc:758-856) and
# broadcast_object/allgather_object (reference tensorflow/functions.py).
# The *_op variants read the world when the graph RUNS (tf.py_function),
# which elastic tf.function graphs need after a rescale.


def rank_op(name: Optional[str] = None):
    tf = _tf()
    return tf.py_function(lambda: rank(), [], tf.int32)


def size_op(name: Optional[str] = None):
    tf = _tf()
    return tf.py_function(lambda: size(), [], tf.int32)


def local_rank_op(name: Optional[str] = None):
    tf = _tf()
    return tf.py_function(lambda: local_rank(), [], tf.int32)


def local_size_op(name: Optional[str] = None):
    tf = _tf()
    return tf.py_function(lambda: local_size(), [], tf.int32)


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    """Broadcast a picklable object (reference ``tensorflow/functions.py``;
    the protocol is :mod:`horovod_tpu_torch.native.objects`)."""
    from ..native.objects import broadcast_object as impl

    return impl(obj, root_rank=root_rank, name=name or "tf.obj")


def broadcast_object_fn(root_rank: int = 0, name: Optional[str] = None):
    """The curried form (the reference keeps both spellings)."""

    def _fn(obj):
        return broadcast_object(obj, root_rank=root_rank, name=name)

    return _fn


def allgather_object(obj, name: Optional[str] = None):
    """One picklable object a rank, in rank order (reference
    ``allgather_object``)."""
    from ..native.objects import allgather_object as impl

    return impl(obj, name=name or "tf.gobj")


def barrier():
    native.barrier()


# -- variable broadcast / optimizer -------------------------------------


def broadcast_variables(variables, root_rank: int = 0):
    """Assign every variable rank ``root_rank``'s value (reference
    ``broadcast_variables``, ``__init__.py:263``)."""
    for i, var in enumerate(variables):
        var.assign(
            broadcast(var, root_rank=root_rank, name=f"bcast_var.{i}")
        )


def broadcast_global_variables(root_rank: int = 0):
    tf = _tf()
    if hasattr(tf.compat.v1, "global_variables"):
        broadcast_variables(tf.compat.v1.global_variables(), root_rank)


class DistributedGradientTape:
    """Wrap ``tf.GradientTape`` so ``gradient()`` allreduces (reference
    ``DistributedGradientTape``, ``__init__.py:673``)."""

    def __init__(self, tape, compression=Compression.none, op: int = Average):
        self._tape = tape
        self._compression = compression
        self._op = op

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def __getattr__(self, item):
        return getattr(self._tape, item)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        return _reduce_present(grads, "tape.grads", self._op,
                               self._compression)


def _reduce_present(grads, name, op, compression):
    """Allreduce the gradients that exist; a None gradient (a source the
    loss does not reach) passes through, as the reference's
    ``_allreduce_cond`` skips it."""
    present = [g for g in grads if g is not None]
    reduced = iter(grouped_allreduce(present, name=name, op=op,
                                     compression=compression)
                   if present else [])
    return [None if g is None else next(reduced) for g in grads]


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         compression=Compression.none, op: int = Average,
                         backward_passes_per_step: int = 1):
    """Wrap a ``tf.keras.optimizers.Optimizer`` so ``apply_gradients``
    allreduces first (reference ``DistributedOptimizer``,
    ``__init__.py:568``)."""
    _tf()

    class _Wrapper(optimizer.__class__):
        def __init__(self):
            self.__dict__.update(optimizer.__dict__)
            self._hvd_compression = compression
            self._hvd_op = op

        def apply_gradients(self, grads_and_vars, **kwargs):
            grads_and_vars = list(grads_and_vars)
            reduced = _reduce_present(
                [g for g, _ in grads_and_vars], name or "opt.grads",
                self._hvd_op, self._hvd_compression)
            return super().apply_gradients(
                zip(reduced, [v for _, v in grads_and_vars]), **kwargs)

    _Wrapper.__name__ = f"Distributed{optimizer.__class__.__name__}"
    return _Wrapper()


def __getattr__(name):
    # Lazy exports: these pull in keras / TF at first use, so the package
    # imports without TF (the module contract above).
    if name == "SyncBatchNormalization":
        from .sync_batch_norm import SyncBatchNormalization

        return SyncBatchNormalization
    if name == "TensorFlowKerasState":
        from .elastic import TensorFlowKerasState

        return TensorFlowKerasState
    if name == "elastic":
        from . import elastic

        return elastic
    raise AttributeError(name)
