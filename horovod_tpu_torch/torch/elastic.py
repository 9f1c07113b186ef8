"""Elastic training state for the torch frontend.

The port of the JAX package's ``horovod_tpu/torch/elastic.py``: reference
``horovod/torch/elastic/state.py:27`` (``TorchState`` -- save, restore and
sync of module and optimizer state, on the port's
:class:`~horovod_tpu_torch.elastic.state.State`) and
``horovod/torch/elastic/sampler.py:24`` (``ElasticSampler`` -- mid-epoch
resume by the processed indices, re-sharded when the world changes).
Every exchange rides the runtime (:mod:`horovod_tpu_torch.native`).
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch
from torch.utils.data import Sampler

from ..elastic.run import run  # noqa: F401  (parity: hvd.elastic.run decorator)
from ..elastic.state import State
from . import mpi_ops
from .functions import broadcast_object, broadcast_parameters


class TorchState(State):
    """Elastic state wrapping torch modules / optimizers / plain values.

    ``TorchState(model=model, optimizer=opt, epoch=0, batch=0)``; commit
    checkpoints in-memory, restore rolls back, sync broadcasts from the
    lowest surviving rank.
    """

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None, **kwargs):
        self._handlers = {}
        if model is not None:
            self._handlers["model"] = _ModuleHandler(model)
        if optimizer is not None:
            self._handlers["optimizer"] = _OptimizerHandler(optimizer)
        self._values = dict(kwargs)
        self._saved_values = dict(kwargs)
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
        self._values = broadcast_object(self._values, root_rank=0, name="torchstate")
        self.save()


class _ModuleHandler:
    def __init__(self, module: torch.nn.Module):
        self.value = module
        self._saved = copy.deepcopy(module.state_dict())

    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        self.value.load_state_dict(self._saved)

    def sync(self):
        broadcast_parameters(self.value.state_dict(), root_rank=0)


class _OptimizerHandler:
    def __init__(self, optimizer: torch.optim.Optimizer):
        self.value = optimizer
        self._saved = copy.deepcopy(optimizer.state_dict())

    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        self.value.load_state_dict(copy.deepcopy(self._saved))

    def sync(self):
        state = broadcast_object(self.value.state_dict(), root_rank=0, name="opt.sync")
        if mpi_ops.rank() != 0:
            self.value.load_state_dict(state)


class ElasticSampler(Sampler):
    """Shards a dataset across ranks and resumes mid-epoch after a world
    resize by excluding already-processed indices (reference
    ``sampler.py:24``)."""

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set = set()
        self.num_replicas = 0
        self.rank = 0
        self.remaining_indices: list = []
        self.num_samples = 0
        self.total_size = 0
        self.reset()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Mark the global indices of this batch as processed."""
        start = self.rank + batch_idx * batch_size * self.num_replicas
        for i in range(batch_size):
            offset = start + i * self.num_replicas
            if offset < len(self.remaining_indices):
                self.processed_indices.add(self.remaining_indices[offset])

    def record_indices(self, indices) -> None:
        self.processed_indices.update(indices)

    def load_state_dict(self, state_dict):
        self.epoch = state_dict["epoch"]
        self.processed_indices = set(state_dict["processed_indices"])
        self.reset()

    def state_dict(self):
        return {
            "epoch": self.epoch,
            "processed_indices": sorted(self.processed_indices),
        }

    def reset(self) -> None:
        """Re-shard over the (possibly new) world (reference
        ``sampler.py`` reset-on-rescale)."""
        self.num_replicas = mpi_ops.size() if mpi_ops.is_initialized() else 1
        self.rank = mpi_ops.rank() if mpi_ops.is_initialized() else 0

        all_indices = list(range(len(self.dataset)))
        if self.shuffle:
            g = torch.Generator()
            g.manual_seed(self.seed + self.epoch)
            perm = torch.randperm(len(all_indices), generator=g).tolist()
            all_indices = [all_indices[i] for i in perm]
        remaining = [i for i in all_indices if i not in self.processed_indices]

        self.num_samples = int(math.ceil(len(remaining) / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas
        if remaining:
            # Pad by cycling (padding may exceed len(remaining) when the
            # tail is shorter than the world size).
            pad = self.total_size - len(remaining)
            reps = -(-pad // len(remaining)) if pad > 0 else 0
            remaining += (remaining * reps)[:pad]
        self.remaining_indices = remaining

    def __iter__(self):
        return iter(self.remaining_indices[self.rank : self.total_size : self.num_replicas])

    def __len__(self):
        return self.num_samples
