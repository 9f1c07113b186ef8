"""Process context: ``init``, ``rank``, ``size``, ``local_rank``,
``device``.

The PyTorch counterpart of the JAX package's ``context.py`` for one
process per card (the reference Horovod's model): rank, world size and
local rank come from the launcher's environment (``torchrun``'s
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``, or Horovod's ``HOROVOD_RANK``/
``HOROVOD_SIZE``/``HOROVOD_LOCAL_RANK``); without a launcher the world is
one process. The card is ``cuda:<local_rank>``. Process groups
(``torch.distributed``) arrive with the training slice.

Every entry point of the package runs on the card unless the caller
passes ``device="cpu"``: :func:`resolve_device` raises when CUDA is
absent instead of dropping to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional, Sequence

import torch

from .exceptions import NotInitializedError

_RANK_VARS = ("RANK", "HOROVOD_RANK")
_SIZE_VARS = ("WORLD_SIZE", "HOROVOD_SIZE")
_LOCAL_RANK_VARS = ("LOCAL_RANK", "HOROVOD_LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class TorchContext:
    """Immutable world description of this process."""

    rank: int
    size: int
    local_rank: int
    device: torch.device


_lock = threading.Lock()
_context: Optional[TorchContext] = None


def _env_int(names: Sequence[str], default: int) -> int:
    for name in names:
        val = os.environ.get(name)
        if val is not None and val.strip():
            return int(val)
    return default


def launcher_rank() -> int:
    """This process's rank as the launcher's environment gives it (0
    without a launcher)."""
    return _env_int(_RANK_VARS, 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means this process's card: ``cuda:<local_rank>`` after
    :func:`init`, else the current CUDA device. A CUDA device on a machine
    without CUDA raises; only an explicit ``"cpu"`` runs on the CPU."""
    if device is None:
        if _context is not None:
            return _context.device
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init(device=None) -> TorchContext:
    """Read rank/size/local rank from the launcher's environment and pin
    this process's device (default ``cuda:<local_rank>``)."""
    global _context
    rank = launcher_rank()
    size = _env_int(_SIZE_VARS, 1)
    local_rank = _env_int(_LOCAL_RANK_VARS, 0)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a world of size {size}")
    dev = resolve_device(
        device if device is not None else f"cuda:{local_rank}"
    )
    with _lock:
        _context = TorchContext(rank, size, local_rank, dev)
        return _context


def shutdown() -> None:
    global _context
    with _lock:
        _context = None


def is_initialized() -> bool:
    return _context is not None


def context() -> TorchContext:
    if _context is None:
        raise NotInitializedError()
    return _context


def rank() -> int:
    """Rank of this process in the world."""
    return context().rank


def size() -> int:
    """Number of processes in the world."""
    return context().size


def local_rank() -> int:
    """Rank of this process on its host."""
    return context().local_rank


def device() -> torch.device:
    """This process's device (``cuda:<local_rank>`` by default)."""
    return context().device
