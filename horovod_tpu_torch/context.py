"""Process context: ``init``, ``rank``, ``size``, ``local_rank``,
``local_size``, ``cross_rank``, ``cross_size``, ``device``, and the process
group.

The PyTorch counterpart of the JAX package's ``context.py`` for one
process per card (the reference Horovod's model): rank, world size, local
rank and local size come from the launcher's environment (``torchrun``'s
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, or Horovod's
``HOROVOD_RANK``/``HOROVOD_SIZE``/``HOROVOD_LOCAL_RANK``/
``HOROVOD_LOCAL_SIZE``); without a launcher the world is one process. The
card is ``cuda:<local_rank>``. Hosts are counted as the JAX package counts
them: ``cross_size = size // local_size`` and ``cross_rank = rank //
local_size``.

``init(backend=...)`` also brings up ``torch.distributed``: ``"nccl"`` for
a process on the card, ``"gloo"`` on the CPU. Its rendezvous is
``init_method`` when given, else ``MASTER_ADDR``/``MASTER_PORT`` from the
environment, else -- in a process the port's launcher started
(``HVDTPU_RENDEZVOUS_ADDR``/``_PORT``) -- a ``TCPStore`` that rank 0 opens
and publishes through the launcher's KV (:func:`~.runner.api.kv_store`),
else -- for a world of one -- a file store in a fresh temporary
directory. Under an elastic launcher ``init`` first joins the driver's
current round, which gives the rank and the world size. Every call of the
world times out after ``HVT_DATA_TIMEOUT_SECS`` (default 300 s), so a dead
peer fails the survivors' collectives instead of hanging them.
:func:`spawn_gloo` runs a function on a gloo world of CPU processes (the
multi-rank CPU tests use it).

The world is a named mesh of ranks (:mod:`.parallel.mesh`), as in the JAX
package: a flat ``"hvd"`` axis by default, ``(cross, local)`` with
``hierarchical=True`` (``local`` the processes of a host), or the caller's
``mesh=`` with ``world_axes=`` naming the axes that form the data-parallel
world. ``size(axis)`` and ``rank(axis)`` read it, and every collective's
``axis=`` resolves through :func:`axis_group` to this process's group
along those axes (``None``: the world axes).

Every entry point of the package runs on the card unless the caller
passes ``device="cpu"``: :func:`resolve_device` raises when CUDA is
absent instead of dropping to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .exceptions import HorovodTpuError, NotInitializedError

_RANK_VARS = ("RANK", "HOROVOD_RANK")
_SIZE_VARS = ("WORLD_SIZE", "HOROVOD_SIZE")
_LOCAL_RANK_VARS = ("LOCAL_RANK", "HOROVOD_LOCAL_RANK")
_LOCAL_SIZE_VARS = ("LOCAL_WORLD_SIZE", "HOROVOD_LOCAL_SIZE")
BACKENDS = ("nccl", "gloo")
# The flat data-parallel world axis, and the hierarchical (intra-host /
# inter-host) axis names, as the JAX package names them.
WORLD_AXIS = "hvd"
LOCAL_AXIS = "local"
CROSS_AXIS = "cross"


@dataclasses.dataclass(frozen=True)
class TorchContext:
    """Immutable world description of this process."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    local_size: int = 1
    backend: Optional[str] = None  # the process group's, None without one
    mesh: Any = None  # a parallel.mesh.Mesh
    world_axes: Tuple[str, ...] = (WORLD_AXIS,)  # the mesh axes of the world

    @property
    def cross_size(self) -> int:
        return max(1, self.size // self.local_size)

    @property
    def cross_rank(self) -> int:
        return self.rank // self.local_size


_lock = threading.Lock()
_context: Optional[TorchContext] = None
_store_dir: Optional[str] = None  # file-store directory that init made
_store = None  # the launcher-bootstrapped TCPStore of the live world
_pg_ours = False  # init brought up the default process group


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


def _rendezvous(init_method: Optional[str], rank: int, size: int,
                timeout: float) -> dict:
    """``init_process_group``'s rendezvous arguments: ``init_method=`` or
    a launcher-bootstrapped ``store=``."""
    global _store_dir, _store
    if init_method:
        return {"init_method": init_method}
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return {"init_method": "env://"}
    from .runner import api as _api

    store = _api.kv_store(rank, size, timeout)
    if store is not None:
        _store = store
        return {"store": store}
    if size != 1:
        raise ValueError(
            f"a world of {size} processes needs a rendezvous: pass "
            "init_method= or set MASTER_ADDR and MASTER_PORT"
        )
    _store_dir = tempfile.mkdtemp(prefix="hvt-store-")
    return {"init_method": "file://" + os.path.join(_store_dir, "store")}


def init(device=None, *, backend: Optional[str] = None,
         init_method: Optional[str] = None,
         mesh=None,
         world_axes: Optional[Sequence[str]] = None,
         hierarchical: bool = False) -> TorchContext:
    """Read rank/size/local rank/local size from the launcher's environment
    and pin this process's device (default ``cuda:<local_rank>``).

    ``backend`` ``"nccl"`` (the card) or ``"gloo"`` (the CPU) also
    initializes the default ``torch.distributed`` process group with that
    rank and world size; ``None`` leaves process groups alone (a serving
    process needs none).

    The world's mesh: ``mesh`` (axis sizes, or a :class:`~.parallel.mesh.
    Mesh` built on this world), with ``world_axes`` its axes that form the
    world (default all); else ``hierarchical=True`` for ``(cross, local)``
    axes from the local size; else one ``"hvd"`` axis. Building a mesh's
    process groups is collective: every rank calls ``init`` alike."""
    global _context, _pg_ours
    if backend is not None:
        from .elastic import worker as _worker

        if (_worker.in_elastic_world() and not dist.is_initialized()
                and not _worker.consume_join()):
            # Rank and size come from the driver's current round, not the
            # static env, and may change at every rejoin. A fresh worker
            # forms its first world as a rejoin does: retried.
            return _worker.form_world(lambda: init(
                device, backend=backend, init_method=init_method,
                mesh=mesh, world_axes=world_axes, hierarchical=hierarchical))
    rank = launcher_rank()
    size = _env_int(_SIZE_VARS, 1)
    local_rank = _env_int(_LOCAL_RANK_VARS, 0)
    local_size = _env_int(_LOCAL_SIZE_VARS, size)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a world of size {size}")
    if local_size < 1 or size % local_size:
        raise ValueError(
            f"local size {local_size} does not divide the world size {size}"
        )
    dev = resolve_device(
        device if device is not None else f"cuda:{local_rank}"
    )
    if backend is not None:
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
        want = "cuda" if backend == "nccl" else "cpu"
        if dev.type != want:
            raise ValueError(
                f"backend {backend!r} runs on {want} tensors, but this "
                f"process's device is {dev}"
            )
    from .parallel import mesh as _mesh

    with _lock:
        if backend is not None and not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            from datetime import timedelta

            from .utils import env as _env

            timeout = _env.data_timeout_secs()
            dist.init_process_group(
                backend, rank=rank, world_size=size,
                timeout=timedelta(seconds=timeout),
                **_rendezvous(init_method, rank, size, timeout),
            )
            _pg_ours = True
        if isinstance(mesh, _mesh.Mesh):
            m = mesh
        elif mesh is not None:
            m = _mesh.build_mesh(mesh, world=size, rank=rank, axis_groups=(
                [tuple(world_axes)] if world_axes else ()))
        elif hierarchical:
            m = _mesh.build_mesh(
                {CROSS_AXIS: size // local_size, LOCAL_AXIS: local_size},
                world=size, rank=rank)
        else:
            m = _mesh.build_mesh({WORLD_AXIS: size}, world=size, rank=rank)
        if m.size != size:
            raise ValueError(f"{m} does not cover the world of {size}")
        axes = tuple(world_axes) if world_axes else m.axis_names
        m.group(axes)  # an unknown or unbuilt world axis raises here
        _context = TorchContext(
            rank, size, local_rank, dev, local_size,
            backend if dist.is_initialized() else None, m, axes,
        )
        return _context


def shutdown(abort: bool = False) -> None:
    """Forget the context and tear down the process groups that
    :func:`init` brought up: the default group and every mesh group.

    ``abort=True`` (an elastic rejoin, where a peer may be dead) aborts
    an NCCL world's communicators first, so a dead peer cannot hang the
    teardown."""
    global _context, _store_dir, _store, _pg_ours
    from .ops import collectives

    with _lock:
        # _pg_ours: an init that failed after bringing the group up (a mesh
        # group a dead peer never joined) left no context, but its group
        # must go too.
        if (_pg_ours or _context is not None and _context.backend) \
                and dist.is_initialized():
            from torch.distributed import distributed_c10d as _c10d

            abort_all = getattr(_c10d, "_abort_process_group", None)
            if abort and dist.get_backend() == "nccl" and abort_all:
                abort_all()
            else:
                dist.destroy_process_group()
            collectives.forget_groups()
        _pg_ours = False
        _store = None
        _context = None
        if _store_dir is not None:
            shutil.rmtree(_store_dir, ignore_errors=True)
            _store_dir = None


def is_initialized() -> bool:
    return _context is not None


def context() -> TorchContext:
    if _context is None:
        raise NotInitializedError()
    return _context


def rank(axis=None) -> int:
    """This process's rank along ``axis`` (default: the world axes; the
    index is row-major over a tuple of axes)."""
    c = context()
    return c.mesh.axis_index(c.world_axes if axis is None else axis, c.rank)


def size(axis=None) -> int:
    """Number of processes along ``axis`` (default: the world axes)."""
    c = context()
    return c.mesh.axis_size(c.world_axes if axis is None else axis)


def mesh():
    """The world's mesh."""
    return context().mesh


def world_axes() -> Tuple[str, ...]:
    return context().world_axes


def axis_group(axis=None):
    """This process's group along ``axis`` -- a mesh axis name or a tuple
    of names; ``None`` is the world axes -- which every collective's
    ``axis=`` resolves through. Without :func:`init` the world is the
    default process group (or one process), and a named axis raises."""
    from .parallel import mesh as _mesh

    c = _context
    if c is None:
        if axis is not None:
            raise HorovodTpuError(
                f"axis {axis!r} names no mesh axis: call "
                "horovod_tpu_torch.init() first")
        return _mesh._world_group()
    return c.mesh.group(c.world_axes if axis is None else axis)


def local_rank() -> int:
    """Rank of this process on its host."""
    return context().local_rank


def local_size() -> int:
    """Number of processes on this host."""
    return context().local_size


def cross_rank() -> int:
    """This host's rank (parity: ``hvd.cross_rank()``)."""
    return context().cross_rank


def cross_size() -> int:
    """Number of hosts (parity: ``hvd.cross_size()``)."""
    return context().cross_size


def device() -> torch.device:
    """This process's device (``cuda:<local_rank>`` by default)."""
    return context().device


def _spawned(rank: int, world: int, store: str, out_dir: str, fn: Callable,
             args: tuple) -> None:
    os.environ.update(
        RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
        LOCAL_WORLD_SIZE=str(world),
    )
    # One intra-op thread a rank: the test suite runs several worlds at once.
    torch.set_num_threads(1)
    init(device="cpu", backend="gloo", init_method="file://" + store)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown()


def spawn_gloo(world: int, fn: Callable, *args: Any) -> List[Any]:
    """Run ``fn(*args)`` on a gloo world of ``world`` CPU processes and
    return each rank's result, in rank order.

    Each process is spawned fresh (``fn`` must be importable by name),
    initialized with :func:`init` (``device="cpu"``, ``backend="gloo"``)
    on a file store in a new temporary directory -- no port, so concurrent
    worlds never collide -- and limited to one intra-op thread.
    Results travel back through ``torch.save``; a failing rank raises here
    with its traceback."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="hvt-gloo-")
    try:
        mp.start_processes(
            _spawned,
            args=(world, os.path.join(tmp, "store"), tmp, fn, args),
            nprocs=world, start_method="spawn",
        )
        return [
            torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)
        ]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
