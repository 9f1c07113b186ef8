"""Elastic state for TF / Keras training.

The port of the JAX package's ``tensorflow/elastic.py`` (parity:
``horovod/tensorflow/elastic.py:91-154``, ``TensorFlowKerasState``: save,
restore and sync of a Keras model's weights, its optimizer's variables and
plain attributes) on the port's :class:`~..elastic.state.State`, which
brings the commit, the host-update interrupt (its timestamp over the
runtime, as the base's ``_bcast_object`` sends it) and the world rejoin,
which starts the runtime again on the new round. Every exchange rides the
runtime: the weights as broadcasts, the attributes through
:mod:`horovod_tpu_torch.native.objects`.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from .. import native
from ..elastic.run import run  # noqa: F401  (parity: hvd.elastic.run)
from ..elastic.state import State
from ..native.objects import broadcast_object
from . import _numpy, _torch, broadcast


def _opt_variables(optimizer):
    """Keras 3 optimizers have ``variables``; older ones ``weights``."""
    if hasattr(optimizer, "variables"):
        return list(optimizer.variables)
    return list(optimizer.weights)


def _multi_rank() -> bool:
    return native.is_initialized() and native.size() > 1


class _ModelHandler:
    def __init__(self, model):
        self.value = model
        self.save()

    def save(self):
        self._saved = [np.copy(w) for w in self.value.get_weights()]

    def restore(self):
        self.value.set_weights([np.copy(w) for w in self._saved])

    def sync(self):
        synced = []
        for i, w in enumerate(self.value.get_weights()):
            w = np.asarray(w)
            if _multi_rank():
                w = _numpy(native.broadcast(
                    _torch(w), 0, name=f"tfstate.model.{i}"), w.dtype)
            synced.append(w)
        self.value.set_weights(synced)


class _OptimizerHandler:
    def __init__(self, optimizer):
        self.value = optimizer
        self.save()

    def save(self):
        self._saved = [np.copy(v.numpy()) for v in _opt_variables(self.value)]

    def restore(self):
        for var, saved in zip(_opt_variables(self.value), self._saved):
            var.assign(saved)

    def sync(self):
        for i, var in enumerate(_opt_variables(self.value)):
            var.assign(broadcast(var, root_rank=0, name=f"tfstate.opt.{i}"))


class TensorFlowKerasState(State):
    """Elastic state of a Keras model, its optimizer and plain values.

    ``TensorFlowKerasState(model, optimizer, epoch=0, batch=0)``: commit
    snapshots in host memory, restore rolls back, sync broadcasts rank 0's
    (the reference's recipe for a joining worker).
    """

    def __init__(self, model=None, optimizer: Optional[object] = None,
                 **kwargs):
        self._handlers = {}
        if model is not None:
            self._handlers["model"] = _ModelHandler(model)
        if optimizer is not None:
            self._handlers["optimizer"] = _OptimizerHandler(optimizer)
        self._values = dict(kwargs)
        self._saved_values = copy.deepcopy(self._values)
        super().__init__()
        for k, h in self._handlers.items():
            object.__setattr__(self, k, h.value)

    def __getattr__(self, name):
        values = self.__dict__.get("_values", {})
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if "_values" in self.__dict__ and name in self._values:
            self._values[name] = value
        else:
            object.__setattr__(self, name, value)

    def save(self):
        for h in self._handlers.values():
            h.save()
        self._saved_values = copy.deepcopy(self._values)

    def restore(self):
        for h in self._handlers.values():
            h.restore()
        self._values = copy.deepcopy(self._saved_values)

    def sync(self):
        for h in self._handlers.values():
            h.sync()
        self._values = broadcast_object(self._values, root_rank=0,
                                        name="tfstate.values")
        self.save()
