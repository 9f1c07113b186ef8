"""MXNet frontend over the port's runtime (parity:
``horovod/mxnet/__init__.py``; the port of ``horovod_tpu/mxnet``).

``DistributedOptimizer`` (reference ``:40``), ``DistributedTrainer``
(``:102``), ``broadcast_parameters`` (``:191``) and the eager collective
set, bridged through numpy onto the dynamic-enqueue runtime
(:mod:`horovod_tpu_torch.native`): an NDArray's values become a CPU
tensor, ride the runtime's gloo group and come back as an NDArray — the
adapter the reference implements with ``MXEnginePushAsync``
(``horovod/mxnet/mpi_ops.cc``).

MXNet is optional and deprecated upstream: every function imports it
lazily and raises a clean ImportError when it is absent, so the module
imports without it. ``init`` starts the runtime on this process's card
unless it is given ``device="cpu"``, as the TensorFlow frontend's does;
the bridged host tensors ride the runtime's gloo group either way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native
from ..exceptions import HorovodInternalError

Sum = native.SUM
Average = native.AVERAGE
Adasum = native.ADASUM


def _mx():
    try:
        import mxnet as mx

        return mx
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.mxnet requires the 'mxnet' package; the "
            "port's training path is horovod_tpu_torch (PyTorch)"
        ) from e


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
        raise HorovodInternalError("horovod_tpu_torch.mxnet not initialized")
    return r


def size() -> int:
    s = native.size()
    if s < 0:
        raise HorovodInternalError("horovod_tpu_torch.mxnet not initialized")
    return s


def _to_numpy(tensor) -> np.ndarray:
    if hasattr(tensor, "asnumpy"):
        return tensor.asnumpy()
    return np.asarray(tensor)


def _run(collective, tensor, **kw) -> np.ndarray:
    """One runtime collective on an NDArray's values, back as numpy."""
    arr = np.ascontiguousarray(_to_numpy(tensor))
    return collective(torch.from_numpy(arr.copy()), **kw).numpy()


def _reduce(tensor, name: str, average: bool) -> np.ndarray:
    return _run(native.allreduce, tensor, op=native.SUM, name=name,
                postscale=(1.0 / size()) if average else 1.0)


def allreduce(tensor, average: bool = True, name: Optional[str] = None):
    mx = _mx()
    return mx.nd.array(_reduce(tensor, name or "mx.allreduce", average))


def allgather(tensor, name: Optional[str] = None):
    mx = _mx()
    return mx.nd.array(
        _run(native.allgather, tensor, name=name or "mx.allgather"))


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None):
    mx = _mx()
    return mx.nd.array(
        _run(native.broadcast, tensor, root_rank=root_rank,
             name=name or "mx.broadcast"))


def broadcast_parameters(params, root_rank: int = 0):
    """Broadcast a Gluon ``ParameterDict`` / param map from ``root_rank``
    (reference ``__init__.py:191``)."""
    mx = _mx()
    if hasattr(params, "items"):
        items = sorted(params.items())
    else:
        raise ValueError("invalid params type")
    for name, p in items:
        data = p.data() if hasattr(p, "data") else p
        out = _run(native.broadcast, data, root_rank=root_rank,
                   name=f"mx.bp.{name}")
        if hasattr(p, "set_data"):
            p.set_data(mx.nd.array(out))
        else:
            params[name] = mx.nd.array(out)


def DistributedOptimizer(optimizer):
    """Wrap an mxnet Optimizer: allreduce gradients inside ``update``
    (reference ``DistributedOptimizer``, ``__init__.py:40``)."""
    mx = _mx()

    class _DistributedOptimizer(optimizer.__class__):
        def __init__(self):
            self.__dict__.update(optimizer.__dict__)

        def _do_allreduce(self, index, grad):
            if size() == 1:
                return grad
            if isinstance(index, (tuple, list)):
                return [mx.nd.array(_reduce(g, f"mx.grad.{i}", True))
                        for i, g in zip(index, grad)]
            return mx.nd.array(_reduce(grad, f"mx.grad.{index}", True))

        def update(self, index, weight, grad, state):
            super().update(index, weight, self._do_allreduce(index, grad),
                           state)

        def update_multi_precision(self, index, weight, grad, state):
            super().update_multi_precision(
                index, weight, self._do_allreduce(index, grad), state
            )

    return _DistributedOptimizer()


def DistributedTrainer(params, optimizer, optimizer_params=None):
    """Gluon Trainer whose ``_allreduce_grads`` rides the runtime
    (reference ``DistributedTrainer``, ``__init__.py:102``)."""
    mx = _mx()

    class _DistributedTrainer(mx.gluon.Trainer):
        def __init__(self):
            # The trainer divides by the batch size; the allreduce sums
            # across ranks, so it averages.
            super().__init__(
                params, optimizer, optimizer_params, kvstore=None
            )

        def _allreduce_grads(self):
            if size() == 1:
                return
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    for g in param.list_grad():
                        g[:] = mx.nd.array(
                            _reduce(g, f"mx.trainer.{i}", True))

    return _DistributedTrainer()
