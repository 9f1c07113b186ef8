"""The dynamic-enqueue runtime: handle-based collectives negotiated, cached
and fused on ``torch.distributed``.

The port of the JAX package's ``horovod_tpu/native/__init__.py`` (the
reference's basics layer, ``horovod/common/basics.py:22-252``, and the
torch binding's handle API, ``horovod/torch/mpi_ops_v2.cc:64-481``):
enqueue returns an int handle, :func:`synchronize` blocks for it,
:func:`poll` tests it. Any thread may enqueue, in any order: the
background thread (:mod:`.runtime`) negotiates each name with the other
ranks (:mod:`.controller`), serves repeats from the response cache
(:mod:`.cache`), fuses what is ready and runs it.

Where the JAX package loads ``libhvtcore.so`` and moves host arrays over
its TCP ring, its peer mesh or its shared-memory plane, this runtime is
Python on two process groups of its own, made once at :func:`init` on
every rank in the same order and apart from every group of
:mod:`horovod_tpu_torch.context` and :mod:`..ops.collectives`: a gloo
group (the control exchange and CPU tensors) and, on the card, an NCCL
group (CUDA tensors). The tensor's device picks the data plane. A world
already formed by :func:`horovod_tpu_torch.init` lends its store; else
the world forms from ``HVT_RANK``/``HVT_SIZE``/``HVT_COORD_ADDR``/
``HVT_COORD_PORT`` (a ``TCPStore`` rank 0 opens), or from the launcher's
rendezvous KV (:func:`..runner.api.kv_store` under the ``native`` scope),
or, for a world of one, from an in-process store. Under an elastic
launcher :func:`init` first joins the driver's current round.

There is no fallback: :func:`init` runs on the card unless the caller
passes ``device="cpu"`` (and raises without CUDA), and a CUDA tensor sent
to a runtime on the CPU raises.
"""

from __future__ import annotations

import os
import threading
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..exceptions import HorovodInternalError, HorovodTpuError
from ..utils import env as _env
from . import messages as msg
from .messages import (  # noqa: F401
    ADASUM, AVERAGE, MAX, MIN, PRODUCT, SUM, Request, RequestType,
)
from .runtime import COUNTERS, OK, PRECONDITION_ERROR, Entry, Runtime

# The counters behind metrics_counters(), under the JAX package's names
# (short name -> its hvt_metrics_* symbol; here a field of
# runtime.COUNTERS). The obs bridge (..obs.native_bridge) reads the same.
METRICS_ABI = {
    "cycles": "hvt_metrics_cycles",
    "fused_tensors": "hvt_metrics_fused_tensors",
    "fused_batches": "hvt_metrics_fused_batches",
    "cache_hits": "hvt_metrics_cache_hits",
    "cache_misses": "hvt_metrics_cache_misses",
    "shm_bytes": "hvt_metrics_shm_bytes",
}

# The ParameterManager's answer, under the JAX package's C symbol.
AUTOTUNE_ABI = {"autotune_best": "hvt_autotune_best"}

_lock = threading.Lock()
_runtime: Optional[Runtime] = None


def _elastic_rank_size():
    from ..elastic import worker as _worker

    if _worker.in_elastic_world() and not dist.is_initialized():
        return _worker.join_world_env()
    return None, None


def _store(rank: int, size: int, coord_addr, coord_port, timeout: float):
    """The store the runtime's groups rendezvous on (see the module doc)."""
    if dist.is_initialized():
        from torch.distributed import distributed_c10d as _c10d

        return _c10d._get_default_store()
    addr = coord_addr or os.environ.get(
        "HVT_COORD_ADDR", os.environ.get("HVDTPU_COORDINATOR_ADDR",
                                         "127.0.0.1"))
    port = (int(os.environ.get("HVT_COORD_PORT", "0"))
            if coord_port is None else int(coord_port))
    if port:
        return dist.TCPStore(addr, port, size, rank == 0,
                             timeout=timedelta(seconds=timeout))
    from ..runner import api as _api

    store = _api.kv_store(rank, size, timeout, scope=os.environ.get(
        "HVDTPU_NATIVE_SCOPE", "native"))
    if store is not None:
        return store
    if size == 1:
        return dist.HashStore()
    raise HorovodTpuError(
        "a runtime of several processes needs HVT_COORD_PORT, a launcher's "
        "rendezvous (HVDTPU_RENDEZVOUS_ADDR/PORT) or a torch.distributed "
        "world formed by horovod_tpu_torch.init(backend=...)")


def init(rank: Optional[int] = None, size: Optional[int] = None,
         coord_addr: Optional[str] = None, coord_port: Optional[int] = None,
         device=None) -> None:
    """Start the runtime (a no-op while one runs). ``rank``/``size``
    default to a live ``torch.distributed`` world's, else ``HVT_RANK``/
    ``HVT_SIZE`` (the launcher's env, then ``RANK``/``WORLD_SIZE``).
    ``device``: ``None`` is this process's card, ``"cpu"`` the CPU."""
    global _runtime
    from .. import context as _ctx

    with _lock:
        if _runtime is not None and _runtime.alive:
            return
        dev = _ctx.resolve_device(device)
        if rank is None and size is None:
            rank, size = _elastic_rank_size()
        if dist.is_initialized():
            rank = dist.get_rank() if rank is None else rank
            size = dist.get_world_size() if size is None else size
            if (rank, size) != (dist.get_rank(), dist.get_world_size()):
                raise HorovodTpuError(
                    f"rank {rank} of {size} in a torch.distributed world "
                    f"where this process is rank {dist.get_rank()} of "
                    f"{dist.get_world_size()}")
        env_rank, env_size = _env.launcher_rank_world()
        rank = env_rank if rank is None else int(rank)
        size = env_size if size is None else int(size)
        if not 0 <= rank < size:
            raise HorovodTpuError(f"rank {rank} outside a world of {size}")
        timeout = _env.data_timeout_secs()
        store = _store(rank, size, coord_addr, coord_port, timeout)
        # Every rank of an init adds once: the same generation on all.
        gen = (store.add("hvt_native/inits", 1) - 1) // size
        prefix = f"hvt_native/{gen}"
        gloo = dist.ProcessGroupGloo(
            dist.PrefixStore(prefix + "/gloo", store), rank, size,
            timedelta(seconds=timeout))
        nccl = None
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timedelta(seconds=timeout)
            nccl = dist.ProcessGroupNCCL(
                dist.PrefixStore(prefix + "/nccl", store), rank, size, opts)
        rt = Runtime(rank, size, gloo, nccl, dev)
        rt.start()
        _runtime = rt


def shutdown() -> None:
    """Stop the runtime; every rank calls it (the loop ends when all did)."""
    global _runtime
    with _lock:
        rt, _runtime = _runtime, None
    if rt is not None:
        rt.shutdown()


def is_initialized() -> bool:
    return _runtime is not None and _runtime.alive


def rank() -> int:
    return _runtime.rank if _runtime is not None else -1


def size() -> int:
    return _runtime.size if _runtime is not None else -1


def get_runtime() -> Runtime:
    rt = _runtime
    if rt is None or not rt.alive:
        raise HorovodInternalError(
            "native runtime not initialized"
            + (f" ({rt.error})" if rt is not None and rt.error else ""))
    return rt


def _device_class(rt: Runtime, t: torch.Tensor) -> str:
    if t.device.type == "cpu":
        return "cpu"
    if t.device.type != "cuda" or rt.device.type != "cuda":
        raise HorovodTpuError(
            f"a {t.device} tensor cannot go through a runtime initialized "
            f"for the {rt.device.type.upper()}: pass device=None to "
            "horovod_tpu_torch.native.init() to serve CUDA tensors")
    if t.device != rt.device:
        raise HorovodTpuError(
            f"tensor on {t.device}, the runtime serves {rt.device}")
    return "cuda"


def _enqueue(rt: Runtime, name: str, rtype: RequestType, tensor, *,
             output=None, **req) -> int:
    dev = _device_class(rt, tensor)
    entry = Entry(name=name, type=rtype, input=tensor, output=output)
    if dev == "cuda":
        stream = torch.cuda.current_stream(tensor.device)
        entry.ready = torch.cuda.Event()
        entry.ready_stream = stream.cuda_stream
        with rt.record_lock:  # seq follows the events' order on a stream
            entry.ready.record(stream)
            entry.seq = next(rt.record_seq)
    request = Request(type=rtype, name=name,
                      dtype=msg.dtype_code(tensor.dtype),
                      shape=tuple(tensor.shape), device=dev, **req)
    return rt.enqueue(entry, request)


def _check_out(tensor: torch.Tensor, out: Optional[torch.Tensor]):
    if out is None:
        return torch.empty_like(tensor)
    if out.shape != tensor.shape or out.dtype != tensor.dtype \
            or out.device != tensor.device:
        raise HorovodTpuError(
            f"out mismatch: {out.dtype}{tuple(out.shape)} on {out.device} "
            f"vs {tensor.dtype}{tuple(tensor.shape)} on {tensor.device}")
    return out


def allreduce_async(name: str, tensor: torch.Tensor, op: int = SUM,
                    prescale: float = 1.0, postscale: float = 1.0,
                    group_name: str = "", group_size: int = 0,
                    out: Optional[torch.Tensor] = None) -> int:
    """Enqueue an allreduce of ``tensor`` under ``name``. ``out`` receives
    the result (pass ``tensor`` itself for an in-place allreduce: the
    runtime reads the input while packing, before it writes)."""
    rt = get_runtime()
    return _enqueue(rt, name, RequestType.ALLREDUCE, tensor,
                    output=_check_out(tensor, out), reduce_op=int(op),
                    prescale=float(prescale), postscale=float(postscale),
                    group_name=group_name, group_size=int(group_size))


def grouped_allreduce_async(names: Sequence[str],
                            tensors: Sequence[torch.Tensor], op: int = SUM,
                            prescale: float = 1.0, postscale: float = 1.0,
                            group_name: str = "",
                            outs: Optional[Sequence] = None) -> List[int]:
    """Enqueue a set negotiated and fused as one unit (the group is held
    until every member is ready on every rank)."""
    count = len(tensors)
    if count == 0:
        return []
    if len(names) != count or (outs is not None and len(outs) != count):
        raise HorovodTpuError(
            f"grouped_allreduce_async: {len(names)} names / {count} tensors"
            f" / {len(outs) if outs is not None else count} outs")
    group_name = group_name or names[0] + ".grp"
    return [allreduce_async(n, t, op, prescale, postscale, group_name, count,
                            None if outs is None else outs[i])
            for i, (n, t) in enumerate(zip(names, tensors))]


def allgather_async(name: str, tensor: torch.Tensor) -> int:
    """Concatenate every rank's ``tensor`` along dim 0 (uneven sizes)."""
    rt = get_runtime()
    if tensor.dim() == 0:
        tensor = tensor.reshape(1)
    return _enqueue(rt, name, RequestType.ALLGATHER, tensor)


def broadcast_async(name: str, tensor: torch.Tensor, root_rank: int = 0,
                    out: Optional[torch.Tensor] = None) -> int:
    rt = get_runtime()
    return _enqueue(rt, name, RequestType.BROADCAST, tensor,
                    output=_check_out(tensor, out), root_rank=int(root_rank))


def alltoall_async(name: str, tensor: torch.Tensor,
                   splits: Optional[Sequence[int]] = None) -> int:
    rt = get_runtime()
    if tensor.dim() == 0:
        tensor = tensor.reshape(1)
    if splits is None:
        if tensor.shape[0] % rt.size:
            raise HorovodTpuError(
                "alltoall requires dim0 divisible by world size")
        splits = [tensor.shape[0] // rt.size] * rt.size
    splits = [int(s) for s in splits]
    if sum(splits) != tensor.shape[0]:
        raise HorovodTpuError(
            f"alltoall splits sum to {sum(splits)} but dim0 is "
            f"{tensor.shape[0]}")
    return _enqueue(rt, name, RequestType.ALLTOALL, tensor,
                    splits=tuple(splits))


def reducescatter_async(name: str, tensor: torch.Tensor, op: int = SUM,
                        prescale: float = 1.0,
                        postscale: float = 1.0) -> int:
    """Reduce across ranks; rank r keeps rows ``[r * d, (r + 1) * d)``,
    ``d = dim0 / size``."""
    rt = get_runtime()
    if tensor.dim() == 0 or tensor.shape[0] % rt.size:
        raise HorovodTpuError(
            "reducescatter requires dim0 divisible by world size")
    out = torch.empty((tensor.shape[0] // rt.size,) + tuple(tensor.shape[1:]),
                      dtype=tensor.dtype, device=tensor.device)
    return _enqueue(rt, name, RequestType.REDUCESCATTER, tensor, output=out,
                    reduce_op=int(op), prescale=float(prescale),
                    postscale=float(postscale))


def _wait_check(rt: Runtime, handle: int, timeout: float = -1.0) -> None:
    if not rt.handles.wait(handle, timeout):
        raise HorovodTpuError("timed out waiting for collective")
    status = rt.handles.status(handle)
    if status.type == OK:
        return
    rt.handles.release(handle)
    reason = status.reason or "collective failed"
    if status.type == PRECONDITION_ERROR:
        raise HorovodTpuError(reason)
    raise HorovodInternalError(reason)


def _special(rtype: RequestType, name: str, timeout: float = -1.0) -> int:
    rt = get_runtime()
    entry = Entry(name=name, type=rtype)
    handle = rt.enqueue(entry, Request(type=rtype, name=name,
                                       device=rt.device.type))
    _wait_check(rt, handle, timeout)
    done = rt.handles.entry(handle)
    rt.handles.release(handle)
    return done.result


def join() -> int:
    """Mark this rank's data exhausted; block until every rank joined and
    return the last rank that joined (``operations.cc:1166-1190``). Until
    then this rank takes part in the other ranks' collectives with the
    op's identity."""
    return int(_special(RequestType.JOIN, msg.JOIN_NAME))


def barrier(timeout: float = -1.0) -> None:
    _special(RequestType.BARRIER, msg.BARRIER_NAME, timeout)


def poll(handle: int) -> bool:
    """True once the collective behind ``handle`` has completed (on the
    card: its work on the runtime's stream has run)."""
    rt = get_runtime()
    if not rt.handles.poll(handle):
        return False
    e = rt.handles.entry(handle)
    return e is None or e.done is None or e.done.query()


def _finish(rt: Runtime, handle: int, timeout: float) -> Entry:
    _wait_check(rt, handle, timeout)
    e = rt.handles.entry(handle)
    rt.handles.release(handle)
    if e.done is not None:
        stream = torch.cuda.current_stream(rt.device)
        stream.wait_event(e.done)
        if e.owned:
            e.result.record_stream(stream)
    return e


def synchronize(handle: int, timeout: float = -1.0) -> torch.Tensor:
    """Block (on the host) until ``handle`` completes and return its
    result; on the card the caller's current stream then waits on the
    collective's completion event."""
    e = _finish(get_runtime(), handle, timeout)
    return e.result if e.owned else e.output


def synchronize_alltoall(handle: int, timeout: float = -1.0):
    """:func:`synchronize` for an alltoall: ``(output, received splits)``."""
    e = _finish(get_runtime(), handle, timeout)
    return e.result, torch.tensor(e.recv_splits, dtype=torch.int64)


def wire_bytes() -> tuple:
    """Cumulative (sent, received) bytes of this process's runtime: its
    control exchanges and the payloads of its collectives (0 at world 1)."""
    return COUNTERS.bytes_sent, COUNTERS.bytes_received


def metrics_counters() -> dict:
    """Cumulative runtime counters under :data:`METRICS_ABI`'s names."""
    snap = COUNTERS.snapshot()
    return {name: snap[name] for name in METRICS_ABI}


def autotune_best() -> Tuple[int, int, int]:
    """``(fusion_bytes, cycle_us, done)``: the best knobs the runtime's
    ParameterManager has scored (its starting knobs until it scored one)
    and whether tuning is done (1) or not (0); ``(-1, -1, -1)`` before
    :func:`init` (``hvt_autotune_best``, ``operations.cc:1606``)."""
    rt = _runtime
    if rt is None:
        return -1, -1, -1
    best = rt.autotune.best
    return (best.fusion_threshold_bytes, best.cycle_time_us,
            1 if rt.autotune.done else 0)


def shm_enabled() -> bool:
    """False: the runtime has no shared-memory data plane."""
    return False


def timeline_start(path: str) -> None:
    get_runtime().timeline.start(path)


def timeline_stop() -> None:
    get_runtime().timeline.stop()


# Blocking conveniences.
def allreduce(tensor, op: int = SUM, name: str = "allreduce", **kw):
    return synchronize(allreduce_async(name, tensor, op=op, **kw))


def allgather(tensor, name: str = "allgather"):
    return synchronize(allgather_async(name, tensor))


def broadcast(tensor, root_rank: int = 0, name: str = "broadcast"):
    return synchronize(broadcast_async(name, tensor, root_rank))


def alltoall(tensor, splits=None, name: str = "alltoall"):
    return synchronize_alltoall(alltoall_async(name, tensor, splits))


def reducescatter(tensor, op: int = SUM, name: str = "reducescatter"):
    return synchronize(reducescatter_async(name, tensor, op=op))
