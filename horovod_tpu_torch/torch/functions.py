"""Object and parameter broadcast for the torch frontend.

The port of the JAX package's ``horovod_tpu/torch/functions.py``
(reference ``horovod/torch/functions.py:186-229``: ``broadcast_object``,
``allgather_object`` -- stdlib pickle over the runtime -- and
``broadcast_parameters`` / ``broadcast_optimizer_state``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from . import mpi_ops


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast model parameters (state_dict or named param iterable)
    from `root_rank` (reference ``horovod/torch/__init__`` via
    ``broadcast_parameters``)."""
    if isinstance(params, dict):
        items = sorted(params.items())
    else:
        items = list(params)
    handles = []
    for name, p in items:
        if p is None:
            continue
        if not isinstance(p, torch.Tensor):
            continue
        handles.append(mpi_ops.broadcast_async_(p.data, root_rank, name=f"bparam.{name}"))
    for h in handles:
        mpi_ops.synchronize(h)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer, root_rank: int = 0) -> None:
    """Broadcast optimizer state (momenta, step counts, lr) from
    `root_rank`; scalar / non-tensor state rides the object path."""
    state_dict = optimizer.state_dict()
    state_dict = broadcast_object(state_dict, root_rank, name="opt_state")
    if mpi_ops.rank() != root_rank:
        optimizer.load_state_dict(state_dict)


def broadcast_object(obj: Any, root_rank: int = 0, name: Optional[str] = None) -> Any:
    """Pickle → broadcast length → broadcast bytes → unpickle
    (reference ``functions.py:186``; the protocol lives in
    :mod:`horovod_tpu_torch.native.objects`)."""
    from ..native.objects import broadcast_object as impl

    return impl(obj, root_rank=root_rank, name=name or "broadcast_object")


def allgather_object(obj: Any, name: Optional[str] = None) -> list:
    """Gather a picklable object from every rank (reference
    ``functions.py:229``); returns a list indexed by rank."""
    from ..native.objects import allgather_object as impl

    return impl(obj, name=name or "allgather_object")
