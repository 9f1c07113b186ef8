"""Process-level (eager) collectives on ``torch.distributed``.

The port of the JAX package's ``ops/eager.py``: blocking collectives on
concrete tensors over the world's process group (gloo on the CPU, NCCL on
the card; :func:`horovod_tpu_torch.init`), where the JAX package exchanges
host arrays through ``multihost_utils``. They serve the control plane --
a parameter broadcast at init, metric averaging, object exchange -- and
compute as the JAX package does: every process's tensor is gathered, then
reduced on the host in the reference's formulas (a sum in rank order, an
integer Average a floor division, Adasum the binary-tree fold of
:func:`_adasum_fold`), and the result keeps the input's dtype and device.
The hot path is the train step's bucketed collectives
(:mod:`.collectives`, :mod:`.fusion`), not these.

Each call is bracketed by :func:`_observed`, as in the JAX package: the
chaos ``eager.dispatch`` site, the timeline activity, a stall watchdog
(a warning after ``HVDTPU_STALL_CHECK_TIME_SECONDS``, an exit after
``HVDTPU_STALL_SHUTDOWN_TIME_SECONDS``) and the ``eager.<KIND>.ms``,
``eager.ops`` and ``eager.bytes`` metrics.

With one process every op is the identity (a copy) -- the reference's
``-np 1``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import chaos as _chaos
from ..exceptions import HorovodInternalError, HorovodTpuError
from ..obs import registry as _obs
from ..utils.stall import StallInspector
from ..utils.timeline import global_timeline
from .collectives import Adasum, Average, Max, Min, Product, ReduceOp, Sum

__all__ = ["allgather", "allreduce", "alltoall", "barrier", "broadcast",
           "reducescatter"]


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


log = logging.getLogger("horovod_tpu_torch.stall")


def _stall_abort(names):
    log.error("aborting: stalled eager collectives %s", names)
    os._exit(1)  # the main thread is wedged in a blocked collective


_stall = StallInspector(on_shutdown=_stall_abort, local_view=True)
_op_seq = itertools.count()


def _payload_bytes(args) -> int:
    """The payload of one call (its first positional argument), from its
    shape and dtype."""
    if not args:
        return 0
    x = args[0]
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _collective(kind: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _observed(kind, args):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def _observed(kind: str, args=()):
    """Timeline, stall and metrics bracketing of one blocking eager
    collective (the JAX package's, ``ops/eager.py:96-149``): a latency
    histogram a kind, op and byte counters (the wire payload ~ payload x
    (world - 1) for the gather-based exchange here), and the stall table
    behind the per-collective age gauges. The payload is sized only when
    metrics are on."""
    if _chaos.enabled():
        # The eager.dispatch site, before any bookkeeping, so an injected
        # failure leaves nothing dangling: delay stalls inline; timeout
        # raises the recoverable error a stalled-out collective would.
        fault = _chaos.act("eager.dispatch", kind=kind)
        if fault is not None and fault.kind == "timeout":
            raise HorovodInternalError(
                f"chaos: injected {kind} dispatch timeout")
    label = f"eager.{next(_op_seq)}"
    tl = global_timeline()
    tl.start_activity(kind, kind)
    world = _world()
    mx = _obs.enabled()
    nbytes = _payload_bytes(args) if mx else 0
    t0 = time.perf_counter() if mx else 0.0
    done = threading.Event()
    if world > 1 and _stall.enabled and _stall.warning_time > 0:
        _stall.record_uncached_tensor(label, _rank())
        interval = _stall.warning_time + 0.01

        def _watch():
            # Re-scan until the op completes, so a warning escalates to
            # the configured shutdown.
            while not done.wait(interval):
                _stall.check(_world())

        threading.Thread(target=_watch, daemon=True).start()
    try:
        yield
    finally:
        done.set()
        _stall.remove_tensor(label)
        tl.end_activity(kind, kind)
        if mx:
            reg = _obs.metrics()
            reg.histogram(f"eager.{kind}.ms").observe(
                (time.perf_counter() - t0) * 1e3)
            reg.counter("eager.ops").inc()
            if world > 1 and nbytes:
                reg.counter("eager.bytes").inc(nbytes * (world - 1))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _from_numpy(y, like: torch.Tensor) -> torch.Tensor:
    y = np.asarray(y)
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(y.astype(np.float32)).to(
            torch.bfloat16).to(like.device)
    return torch.from_numpy(np.ascontiguousarray(y)).to(like.device)


def _group_device(t: torch.Tensor) -> torch.device:
    """Where the world's backend takes its tensors."""
    if dist.get_backend() == "nccl":
        return t.device if t.is_cuda else torch.device(
            "cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_equal(x: torch.Tensor) -> np.ndarray:
    """Every process's ``x`` stacked along a new leading axis (as numpy)."""
    if _world() == 1:
        return _to_numpy(x)[None]
    t = x.detach().contiguous().to(_group_device(x))
    data = t.reshape(-1).view(torch.uint8)
    outs = [torch.empty_like(data) for _ in range(_world())]
    dist.all_gather(outs, data)
    return np.stack([_to_numpy(o.view(t.dtype).view(t.shape)) for o in outs])


@_collective("EAGER_ALLREDUCE")
def allreduce(tensor, op: ReduceOp, prescale: float = 1.0,
              postscale: float = 1.0) -> torch.Tensor:
    like = _as_tensor(tensor)
    x = _to_numpy(like)
    orig_dtype = x.dtype
    if prescale != 1.0:
        x = x * prescale
    g = _gather_equal(torch.from_numpy(np.ascontiguousarray(x)))
    if op in (Average, Sum):
        y = g.sum(axis=0)
        if op == Average:
            y = (y // g.shape[0] if np.issubdtype(y.dtype, np.integer)
                 else y / g.shape[0])
    elif op == Min:
        y = g.min(axis=0)
    elif op == Max:
        y = g.max(axis=0)
    elif op == Product:
        y = g.prod(axis=0)
    elif op == Adasum:
        y = _adasum_fold(g)
    else:
        raise HorovodTpuError(f"unknown reduce op {op}")
    if postscale != 1.0:
        y = y * postscale
    # The input dtype is kept (scaled integers compute in float, then
    # cast back), as the device path's scale does.
    return _from_numpy(np.asarray(y).astype(orig_dtype), like)


def _adasum_fold(g: np.ndarray) -> np.ndarray:
    """Binary-tree Adasum over stacked contributions, in fp64 on the host
    (the JAX package's fold, bit for bit)."""
    vecs = [v.astype(np.float64).ravel() for v in g]
    shape = g.shape[1:]
    while len(vecs) > 1:
        nxt = []
        for i in range(0, len(vecs), 2):
            if i + 1 == len(vecs):
                nxt.append(vecs[i])
                continue
            a, b = vecs[i], vecs[i + 1]
            dot = float(a @ b)
            na = float(a @ a)
            nb = float(b @ b)
            ca = 1.0 - dot / (2 * na) if na > 0 else 1.0
            cb = 1.0 - dot / (2 * nb) if nb > 0 else 1.0
            nxt.append(ca * a + cb * b)
        vecs = nxt
    return vecs[0].reshape(shape)


@_collective("EAGER_ALLGATHER")
def allgather(tensor) -> torch.Tensor:
    """Every process's tensor concatenated along dim 0; uneven first
    dimensions are exchanged first (the reference controller's allgatherv
    bookkeeping)."""
    like = _as_tensor(tensor)
    x = like.reshape(1) if like.dim() == 0 else like
    if _world() == 1:
        return x.clone()
    sizes = _gather_equal(torch.tensor([x.shape[0]], dtype=torch.int64))[:, 0]
    max_n = int(sizes.max())
    padded = torch.zeros((max_n,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device)
    padded[: x.shape[0]] = x
    g = _gather_equal(padded)
    parts = [g[i, : int(sizes[i])] for i in range(g.shape[0])]
    return _from_numpy(np.concatenate(parts, axis=0), x)


@_collective("EAGER_BROADCAST")
def broadcast(tensor, root_rank: int = 0) -> torch.Tensor:
    """Broadcast from the worker rank ``root_rank`` (one process a card:
    the process of that rank)."""
    like = _as_tensor(tensor)
    world = _world()
    if not 0 <= root_rank < world:
        raise HorovodTpuError(
            f"broadcast root_rank {root_rank} out of range for world size "
            f"{world}")
    if world == 1:
        return like.clone()
    t = like.detach().contiguous().to(_group_device(like))
    data = t.reshape(-1).view(torch.uint8).clone()
    dist.broadcast(data, src=root_rank)
    return data.view(t.dtype).view(t.shape).to(like.device)


@_collective("EAGER_ALLTOALL")
def alltoall(tensor, splits=None):
    like = _as_tensor(tensor)
    x = _to_numpy(like)
    world = _world()
    if splits is None:
        if x.shape[0] % world:
            raise HorovodTpuError(
                "alltoall requires dim0 divisible by world size")
        splits_arr = np.full((world,), x.shape[0] // world, dtype=np.int64)
    else:
        splits_arr = np.asarray(splits, dtype=np.int64)
        if splits_arr.shape != (world,):
            raise HorovodTpuError(
                f"alltoall splits must be a length-{world} vector, got "
                f"shape {splits_arr.shape}")
        if int(splits_arr.sum()) != x.shape[0]:
            raise HorovodTpuError(
                f"alltoall splits sum to {int(splits_arr.sum())} but dim0 "
                f"is {x.shape[0]}")
    if world == 1:
        out = like.clone()
        return (out, torch.from_numpy(splits_arr.astype(np.int32))) \
            if splits is not None else out
    # The split tables, then the (uneven-safe) concatenation; each process
    # slices out the segments addressed to it.
    all_splits = _gather_equal(torch.from_numpy(splits_arr))
    me = _rank()
    g = _to_numpy(allgather(like))
    row_offsets = np.concatenate(
        [[0], np.cumsum(all_splits.sum(axis=1))])[:-1]
    parts = []
    for src in range(world):
        start = row_offsets[src] + all_splits[src, :me].sum()
        parts.append(g[int(start): int(start + all_splits[src, me])])
    out = _from_numpy(np.concatenate(parts, axis=0), like)
    recv = torch.from_numpy(all_splits[:, me].astype(np.int32))
    return (out, recv) if splits is not None else out


@_collective("EAGER_REDUCESCATTER")
def reducescatter(tensor, op: ReduceOp = Sum) -> torch.Tensor:
    """Reduce across processes; this process keeps its dim-0 shard (in
    rank order)."""
    like = _as_tensor(tensor)
    x = _to_numpy(like)
    world = _world()
    if x.shape[0] % world:
        raise HorovodTpuError(
            "reducescatter requires dim0 divisible by world size")
    g = _gather_equal(like)
    y = g.sum(axis=0)
    if op == Average:
        y = y // world if np.issubdtype(y.dtype, np.integer) else y / world
    shard = x.shape[0] // world
    me = _rank()
    return _from_numpy(y[me * shard:(me + 1) * shard].astype(x.dtype), like)


@_collective("EAGER_BARRIER")
def barrier() -> None:
    if _world() == 1:
        return
    dist.barrier()
