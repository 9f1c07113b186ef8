"""Ray actor-based launcher.

The port of the JAX package's ``horovod_tpu/ray/runner.py``. Parity
surface (``horovod/ray/runner.py``): ``RayExecutor`` (``:250``) schedules
one worker actor per slot across the cluster, ``NodeColocator`` (``:90``)
pins a node's workers together, and ``Coordinator`` (``:178``) collects
worker registrations and derives the rank topology + rendezvous
environment every worker needs before calling ``init()``.

A slot is one process owning one card. The environment the coordinator
hands a rank is the one the port's launcher gives a slot
(:func:`..runner.api.slot_env`): ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE`` beside the ``HVDTPU_*`` block, so
:func:`horovod_tpu_torch.init` and :func:`horovod_tpu_torch.native.init`
form the world over the driver's rendezvous KV. ``ray`` is imported only
inside the calls that place actors.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import socket
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

from ..runner.api import (
    ENV_COORDINATOR,
    ENV_HOSTNAMES,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ENV_RENDEZVOUS_ADDR,
    ENV_RENDEZVOUS_PORT,
    _local_addr,
    slot_env,
)
from ..runner.hosts import HostInfo, get_host_assignments
from ..runner.http_server import RendezvousServer


def ray_available() -> bool:
    return importlib.util.find_spec("ray") is not None


def _require_ray():
    """The ``ray`` module, or a clean ImportError without it."""
    try:
        import ray
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.ray requires the 'ray' package; install ray "
            "or use horovod_tpu_torch.runner for ssh-based launching"
        ) from e
    return ray


@dataclasses.dataclass
class RaySettings:
    """Executor knobs (reference ``MiniSettings``, ``runner.py:22``)."""

    timeout_s: int = 300
    placement_group_timeout_s: int = 100
    gpus_per_worker: int = 0  # ray resource "GPU" per worker
    cpus_per_worker: int = 1
    env_vars: Dict[str, str] = dataclasses.field(default_factory=dict)


def _remote_worker_cls(ray, settings: RaySettings):
    """``BaseRayWorker`` as an actor class asking for one slot's CPUs and,
    where set, its cards (the reference asks for ``TPU`` the same way)."""
    kw = {"num_cpus": settings.cpus_per_worker}
    if settings.gpus_per_worker:
        kw["num_gpus"] = settings.gpus_per_worker
    return ray.remote(**kw)(BaseRayWorker)


class BaseRayWorker:
    """Per-slot worker; wrapped in ``ray.remote`` at start time
    (reference ``BaseHorovodWorker``, ``runner.py:48``)."""

    def __init__(self, world_rank: int = 0, world_size: int = 1):
        self.world_rank = world_rank
        self.world_size = world_size
        self._executable = None

    def hostname(self) -> str:
        return socket.gethostname()

    def update_env_vars(self, env_vars: Dict[str, str]) -> None:
        os.environ.update({k: str(v) for k, v in env_vars.items()})

    def env_vars(self) -> Dict[str, str]:
        return dict(os.environ)

    def start_executable(self, executable_cls=None, executable_args=None,
                         executable_kwargs=None) -> None:
        if executable_cls is not None:
            self._executable = executable_cls(
                *(executable_args or []), **(executable_kwargs or {})
            )

    def execute(self, func: Callable) -> Any:
        """Run ``func(executable)`` on this worker."""
        return func(self._executable)


class Coordinator:
    """Registers workers and derives the rank topology + env block
    (reference ``Coordinator``, ``runner.py:178-248``).

    Pure Python: no ray objects cross this class, so slot assignment is
    unit-testable exactly like the reference's (SURVEY.md §4 technique b).
    """

    def __init__(self, settings: Optional[RaySettings] = None):
        self.settings = settings or RaySettings()
        # hostname -> [world ranks] in registration order
        self.hostnames_by_rank: Dict[str, List[int]] = defaultdict(list)
        self.rendezvous: Optional[RendezvousServer] = None

    @property
    def world_size(self) -> int:
        return sum(len(r) for r in self.hostnames_by_rank.values())

    @property
    def hoststring(self) -> str:
        return ",".join(
            f"{host}:{len(ranks)}"
            for host, ranks in self.hostnames_by_rank.items()
        )

    def register(self, hostname: str, world_rank: int) -> None:
        self.hostnames_by_rank[hostname].append(world_rank)

    def _hosts(self) -> List[HostInfo]:
        return [HostInfo(host, len(ranks))
                for host, ranks in self.hostnames_by_rank.items()]

    def finalize_registration(self) -> Dict[int, Dict[str, str]]:
        """Per-worker env, keyed by registered world rank: the slot's
        ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` as the
        port's launcher injects them, plus the ``HVDTPU_*`` block
        (reference ``runner.py:209-221`` computes cross/local ranks the
        same way). Slots are host-grouped, so a worker's ``RANK`` can
        differ from its registration rank."""
        hosts = self._hosts()
        slots = get_host_assignments(hosts, min_np=self.world_size)
        coordinator_host = hosts[0].hostname if hosts else "127.0.0.1"
        hostnames = ",".join(h.hostname for h in hosts)

        env_by_rank: Dict[int, Dict[str, str]] = {}
        slot_iter = iter(slots)
        for host, ranks in self.hostnames_by_rank.items():
            for world_rank in ranks:
                slot = next(slot_iter)
                env_by_rank[world_rank] = {
                    **slot_env(slot),
                    ENV_COORDINATOR: coordinator_host,
                    ENV_PROCESS_ID: str(slot.rank),
                    ENV_NUM_PROCESSES: str(slot.size),
                    ENV_HOSTNAMES: hostnames,
                }
        return env_by_rank

    def establish_rendezvous(self) -> Dict[str, str]:
        """Start the HTTP KV rendezvous on the driver and return the env
        pointing workers at it (reference ``runner.py:222-248``)."""
        self.rendezvous = RendezvousServer()
        port = self.rendezvous.start()
        hosts = self._hosts()
        if hosts:
            self.rendezvous.init(
                get_host_assignments(hosts, min_np=self.world_size)
            )
        return {
            ENV_RENDEZVOUS_ADDR: _local_addr(),
            ENV_RENDEZVOUS_PORT: str(port),
        }

    def shutdown(self) -> None:
        if self.rendezvous is not None:
            self.rendezvous.stop()
            self.rendezvous = None


class NodeColocator:
    """Creates and pins one node's worker actors together (reference
    ``NodeColocator``, ``runner.py:90-176``): a placement bundle reserves
    the node's resources, then per-slot workers are spawned inside it."""

    def __init__(self, *, node_rank: int, num_slots: int, world_size: int,
                 settings: Optional[RaySettings] = None):
        self.node_rank = node_rank
        self.num_slots = num_slots
        self.world_size = world_size
        self.settings = settings or RaySettings()
        self.workers: List[Any] = []

    def create_workers(self):
        remote_cls = _remote_worker_cls(_require_ray(), self.settings)
        rank_start = self.node_rank * self.num_slots
        self.workers = [
            remote_cls.remote(
                world_rank=rank_start + i, world_size=self.world_size
            )
            for i in range(self.num_slots)
        ]
        return self.workers


class RayExecutor:
    """Drive a port job as Ray actors (reference ``RayExecutor``,
    ``runner.py:250-480``).

    Usage::

        ex = RayExecutor(RaySettings(), num_workers=4, use_gpu=True)
        ex.start()
        results = ex.run(train_fn, args=(cfg,))
        ex.shutdown()
    """

    def __init__(
        self,
        settings: Optional[RaySettings] = None,
        num_workers: Optional[int] = None,
        num_hosts: Optional[int] = None,
        num_workers_per_host: int = 1,
        use_gpu: bool = False,
    ):
        self.settings = settings or RaySettings()
        if use_gpu and not self.settings.gpus_per_worker:
            self.settings.gpus_per_worker = 1
        if num_workers is None and num_hosts is None:
            raise ValueError("specify num_workers or num_hosts")
        self.num_workers = (
            num_workers
            if num_workers is not None
            else num_hosts * num_workers_per_host
        )
        self.num_workers_per_host = num_workers_per_host
        self.coordinator = Coordinator(self.settings)
        self.workers: List[Any] = []

    def start(
        self,
        executable_cls=None,
        executable_args=None,
        executable_kwargs=None,
    ) -> None:
        ray = _require_ray()
        remote_cls = _remote_worker_cls(ray, self.settings)
        self.workers = [
            remote_cls.remote(world_rank=i, world_size=self.num_workers)
            for i in range(self.num_workers)
        ]
        # Register actual placements, then push the derived env to every
        # worker (reference start() -> _create_workers -> finalize).
        hostnames = ray.get([w.hostname.remote() for w in self.workers])
        for rank, hostname in enumerate(hostnames):
            self.coordinator.register(hostname, rank)
        env_by_rank = self.coordinator.finalize_registration()
        rendezvous_env = self.coordinator.establish_rendezvous()
        ray.get(
            [
                w.update_env_vars.remote(
                    {
                        **self.settings.env_vars,
                        **rendezvous_env,
                        **env_by_rank[rank],
                    }
                )
                for rank, w in enumerate(self.workers)
            ]
        )
        # Reorder self.workers so index == assigned RANK and
        # execute()/run() results come back in rank order.
        by_rank = [None] * len(self.workers)
        for i, w in enumerate(self.workers):
            by_rank[int(env_by_rank[i]["RANK"])] = w
        self.workers = by_rank
        if executable_cls is not None:
            ray.get(
                [
                    w.start_executable.remote(
                        executable_cls, executable_args, executable_kwargs
                    )
                    for w in self.workers
                ]
            )

    def execute(self, fn: Callable) -> List[Any]:
        """Run ``fn(executable)`` on every worker (reference ``:427``)."""
        ray = _require_ray()
        return ray.get([w.execute.remote(fn) for w in self.workers])

    def run(self, fn: Callable, args=None, kwargs=None) -> List[Any]:
        """Run ``fn(*args, **kwargs)`` on every worker (reference
        ``:438``)."""
        ray = _require_ray()
        args, kwargs = args or [], kwargs or {}
        return ray.get(
            [
                w.execute.remote(lambda _, f=fn: f(*args, **kwargs))
                for w in self.workers
            ]
        )

    def execute_single(self, fn: Callable) -> Any:
        """Run ``fn(executable)`` on rank 0 only (reference ``:461``)."""
        ray = _require_ray()
        return ray.get(self.workers[0].execute.remote(fn))

    def shutdown(self) -> None:
        self.coordinator.shutdown()
        if self.workers and ray_available():
            ray = _require_ray()
            for w in self.workers:
                try:
                    ray.kill(w)
                except Exception:
                    pass
        self.workers = []
