"""Handle-based async collectives for PyTorch tensors.

The port of the JAX package's ``horovod_tpu/torch/mpi_ops.py`` (reference
``horovod/torch/mpi_ops.py``: ``allreduce_async:130``, in-place
``allreduce_async_:223``, ``synchronize:823``, grouped, allgather,
broadcast, alltoall, reducescatter, join). Every call enqueues the tensor
itself into the runtime (:mod:`horovod_tpu_torch.native`) -- there is no
numpy staging -- and returns the runtime's int handle; :func:`synchronize`
returns the result, and the in-place ``_`` forms write the caller's
tensor. CUDA tensors go through the runtime's NCCL group, CPU tensors
through its gloo group (the JAX package serves CPU tensors only).

Average is a Sum with a postscale of ``1 / size()`` (reference
``operations.cc:943-958``).
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Optional, Sequence

import torch

from .. import native
from ..exceptions import HorovodInternalError

# Reduction ops (the runtime's codes, csrc/common.h).
Sum = native.SUM
Average = native.AVERAGE
Min = native.MIN
Max = native.MAX
Product = native.PRODUCT
Adasum = native.ADASUM

_alltoall_handles: set = set()
_lock = threading.Lock()
_names = itertools.count(1)


def init(rank: Optional[int] = None, size: Optional[int] = None,
         **kw) -> None:
    """Start the runtime (``hvd.init()``); the world comes from the
    launcher's environment (``HVT_RANK``/``HVT_SIZE``/...) or a
    ``torch.distributed`` world already formed. ``device="cpu"`` runs it
    on the CPU; by default it serves this process's card."""
    native.init(rank, size, **kw)


def shutdown() -> None:
    native.shutdown()


def is_initialized() -> bool:
    return native.is_initialized()


def rank() -> int:
    r = native.rank()
    if r < 0:
        raise HorovodInternalError("horovod_tpu_torch.torch not initialized")
    return r


def size() -> int:
    s = native.size()
    if s < 0:
        raise HorovodInternalError("horovod_tpu_torch.torch not initialized")
    return s


def _env_int(names, default):
    for n in names:
        v = os.environ.get(n)
        if v is not None and v.strip():
            return int(v)
    return default


def local_rank() -> int:
    """Rank on this host (the launcher's ``HVT_LOCAL_RANK``, or
    ``LOCAL_RANK``)."""
    v = _env_int(("HVT_LOCAL_RANK", "LOCAL_RANK"), None)
    return v if v is not None else rank()


def local_size() -> int:
    v = _env_int(("HVT_LOCAL_SIZE", "LOCAL_WORLD_SIZE"), None)
    return v if v is not None else size()


def cross_rank() -> int:
    return _env_int(("HVT_CROSS_RANK",), 0)


def cross_size() -> int:
    return _env_int(("HVT_CROSS_SIZE",), 1)


def _auto_name(prefix: str, name: Optional[str]) -> str:
    return name if name is not None else f"{prefix}.noname.{next(_names)}"


def _average(op: int, postscale: float):
    """Average = Sum + postscale 1/size (``operations.cc:943-958``)."""
    if op == Average:
        return Sum, postscale / size()
    return op, postscale


def _allreduce_async(tensor, name, op, prescale_factor, postscale_factor,
                     inplace: bool) -> int:
    op, post = _average(op, postscale_factor)
    t = tensor.detach()
    return native.allreduce_async(
        _auto_name("allreduce", name), t, op=op, prescale=prescale_factor,
        postscale=post, out=t if inplace else None)


def allreduce_async(tensor: torch.Tensor, name: Optional[str] = None,
                    op: int = Average, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """Async allreduce; returns a handle (``mpi_ops.py:130``)."""
    return _allreduce_async(tensor, name, op, prescale_factor,
                            postscale_factor, inplace=False)


def allreduce_async_(tensor: torch.Tensor, name: Optional[str] = None,
                     op: int = Average, prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> int:
    """In-place async allreduce (``mpi_ops.py:223``)."""
    return _allreduce_async(tensor, name, op, prescale_factor,
                            postscale_factor, inplace=True)


def allreduce(tensor: torch.Tensor, name: Optional[str] = None,
              op: int = Average, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    return synchronize(allreduce_async(tensor, name, op, prescale_factor,
                                       postscale_factor))


def allreduce_(tensor: torch.Tensor, name: Optional[str] = None,
               op: int = Average, prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> torch.Tensor:
    synchronize(allreduce_async_(tensor, name, op, prescale_factor,
                                 postscale_factor))
    return tensor


def _grouped_async(tensors, name, op, prescale_factor, postscale_factor,
                   inplace: bool) -> list:
    gname = _auto_name("group", name)
    op, post = _average(op, postscale_factor)
    ts = [t.detach() for t in tensors]
    return native.grouped_allreduce_async(
        [f"{gname}.{i}" for i in range(len(ts))], ts, op=op,
        prescale=prescale_factor, postscale=post, group_name=gname,
        outs=ts if inplace else None)


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None, op: int = Average,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> list:
    """All tensors negotiated and fused as one unit (``group_table.cc``)."""
    return _grouped_async(tensors, name, op, prescale_factor,
                          postscale_factor, inplace=False)


def grouped_allreduce_async_(tensors, name=None, op=Average,
                             prescale_factor=1.0,
                             postscale_factor=1.0) -> list:
    return _grouped_async(tensors, name, op, prescale_factor,
                          postscale_factor, inplace=True)


def grouped_allreduce(tensors, name=None, op=Average, **kw) -> list:
    return [synchronize(h)
            for h in grouped_allreduce_async(tensors, name, op, **kw)]


def grouped_allreduce_(tensors, name=None, op=Average, **kw) -> list:
    for h in grouped_allreduce_async_(tensors, name, op, **kw):
        synchronize(h)
    return list(tensors)


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None) -> int:
    """Concatenate along dim 0 across ranks; dim 0 may differ."""
    return native.allgather_async(_auto_name("allgather", name),
                                  tensor.detach())


def allgather(tensor: torch.Tensor, name: Optional[str] = None):
    return synchronize(allgather_async(tensor, name))


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None) -> int:
    return native.broadcast_async(_auto_name("broadcast", name),
                                  tensor.detach(), root_rank)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> int:
    t = tensor.detach()
    return native.broadcast_async(_auto_name("broadcast", name), t,
                                  root_rank, out=t)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    synchronize(broadcast_async_(tensor, root_rank, name))
    return tensor


def alltoall_async(tensor: torch.Tensor,
                   splits: Optional[torch.Tensor] = None,
                   name: Optional[str] = None) -> int:
    sp = None if splits is None else [int(x) for x in splits]
    h = native.alltoall_async(_auto_name("alltoall", name), tensor.detach(),
                              sp)
    with _lock:
        _alltoall_handles.add(h)
    return h


def alltoall(tensor: torch.Tensor, splits: Optional[torch.Tensor] = None,
             name: Optional[str] = None):
    """Returns ``(output, received_splits)`` (``operations.cc:1101-1162``)."""
    return synchronize(alltoall_async(tensor, splits, name))


def reducescatter_async(tensor: torch.Tensor, name: Optional[str] = None,
                        op: int = Average) -> int:
    op, post = _average(op, 1.0)
    return native.reducescatter_async(_auto_name("reducescatter", name),
                                      tensor.detach(), op=op, postscale=post)


def reducescatter(tensor: torch.Tensor, name: Optional[str] = None,
                  op: int = Average) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, name, op))


def poll(handle: int) -> bool:
    """True once the op behind ``handle`` completed (``mpi_ops_v2.cc:441``)."""
    return native.poll(handle)


def synchronize(handle: int, timeout: float = -1.0):
    """Block until ``handle`` completes and return its result (an
    alltoall's ``(output, received_splits)``); on the card the caller's
    current stream then waits on the collective's completion event."""
    with _lock:
        is_a2a = handle in _alltoall_handles
        _alltoall_handles.discard(handle)
    if is_a2a:
        return native.synchronize_alltoall(handle, timeout)
    return native.synchronize(handle, timeout)


def join() -> int:
    """Signal data exhaustion on this rank; block until every rank joined
    and return the last rank that joined (``operations.cc:1166-1190``)."""
    return native.join()


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start the runtime's chrome-tracing timeline (``hvd.start_timeline``;
    cycle marks ride ``HVDTPU_TIMELINE_MARK_CYCLES``)."""
    del mark_cycles
    native.timeline_start(file_path)


def stop_timeline() -> None:
    native.timeline_stop()


def barrier(timeout: float = -1.0) -> None:
    native.barrier(timeout)
