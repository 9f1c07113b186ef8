"""Pickle-over-collectives object exchange on the runtime.

The port of the JAX package's ``horovod_tpu/native/objects.py``: the one
implementation of the size-then-bytes protocol behind the frontend's
``broadcast_object`` / ``allgather_object`` (reference
``horovod/torch/functions.py:186-229``; stdlib pickle), so the frontend
and its elastic state cannot disagree on the wire. The bytes ride the
runtime as CPU ``uint8`` tensors (its gloo data plane).
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

import torch

from . import allgather as _allgather, broadcast as _broadcast, rank, size


def _to_bytes(obj) -> torch.Tensor:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """Pickle on the root, broadcast the length, broadcast the bytes,
    unpickle on the others."""
    name = name or "broadcast_object"
    if size() <= 1:
        return obj
    if rank() == root_rank:
        data = _to_bytes(obj)
        length = torch.tensor([data.numel()], dtype=torch.int64)
    else:
        data = None
        length = torch.zeros(1, dtype=torch.int64)
    n = int(_broadcast(length, root_rank, name=f"{name}.len")[0])
    if data is None or data.numel() != n:
        data = torch.zeros(n, dtype=torch.uint8)
    payload = _broadcast(data, root_rank, name=f"{name}.data")
    if rank() == root_rank:
        return obj
    return pickle.loads(payload.numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> list:
    """One picklable object from every rank, in rank order."""
    name = name or "allgather_object"
    if size() <= 1:
        return [obj]
    data = _to_bytes(obj)
    lengths = _allgather(torch.tensor([data.numel()], dtype=torch.int64),
                         name=f"{name}.len")
    gathered = _allgather(data, name=f"{name}.data").numpy()
    out, offset = [], 0
    for n in lengths.reshape(-1).tolist():
        out.append(pickle.loads(gathered[offset:offset + n].tobytes()))
        offset += n
    return out
