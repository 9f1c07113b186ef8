"""Elastic execution on Ray.

The port of the JAX package's ``horovod_tpu/ray/elastic.py`` (parity:
``horovod/ray/elastic.py``). ``RayHostDiscovery`` (reference ``:36-58``)
turns the Ray cluster's live node table into the ``{hostname: slots}``
map the elastic driver polls; ``ElasticRayExecutor`` (reference
``:61-300``) runs a worker function under the elastic restart loop,
re-placing actors as the cluster grows and shrinks.

A slot is a card: discovery counts a node's ``GPU`` resource (the
reference's GPU logic; the JAX package counts ``TPU``), and falls back to
its CPUs. The parsing is pure (``hosts_from_nodes``), so elastic
scheduling is testable with fabricated node tables.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

from ..runner.elastic_driver import ElasticDriver, HostDiscovery
from .runner import RayExecutor, RaySettings, _require_ray

log = logging.getLogger(__name__)


class RayHostDiscovery(HostDiscovery):
    """Discover hosts/slots from ``ray.nodes()`` (reference
    ``elastic.py:36-58``)."""

    def __init__(self, use_gpu: bool = True, cpus_per_slot: int = 1,
                 gpus_per_slot: int = 1):
        self.use_gpu = use_gpu
        self.cpus_per_slot = cpus_per_slot
        self.gpus_per_slot = gpus_per_slot

    @staticmethod
    def hosts_from_nodes(
        nodes: List[Dict[str, Any]],
        *,
        use_gpu: bool = True,
        cpus_per_slot: int = 1,
        gpus_per_slot: int = 1,
    ) -> Dict[str, int]:
        """Pure mapping from a Ray node table to ``{hostname: slots}``.

        Slots per node = floor(resource / per-slot requirement), using the
        GPU resource when present and ``use_gpu`` (reference
        ``:46-58``), otherwise CPUs.
        """
        hosts: Dict[str, int] = {}
        for node in nodes:
            if not node.get("Alive", False):
                continue
            resources = node.get("Resources", {}) or {}
            hostname = node.get("NodeManagerHostname") or node.get(
                "NodeManagerAddress"
            )
            if not hostname:
                continue
            slots = 0
            if use_gpu and resources.get("GPU"):
                slots = int(resources["GPU"] // max(gpus_per_slot, 1))
            if slots == 0 and resources.get("CPU"):
                slots = int(resources["CPU"] // max(cpus_per_slot, 1))
            if slots > 0:
                hosts[hostname] = slots
        return hosts

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        ray = _require_ray()
        return self.hosts_from_nodes(
            ray.nodes(),
            use_gpu=self.use_gpu,
            cpus_per_slot=self.cpus_per_slot,
            gpus_per_slot=self.gpus_per_slot,
        )


class ElasticRayExecutor:
    """Run a worker function elastically on Ray (reference
    ``elastic.py:61-300``): poll discovery, place one actor per slot,
    restart the world (user state kept by
    :mod:`horovod_tpu_torch.elastic`) on membership change or worker
    failure.
    """

    @staticmethod
    def create_settings(min_np: int = 1, max_np: Optional[int] = None,
                        reset_limit: Optional[int] = None,
                        **kwargs) -> RaySettings:
        s = RaySettings(**kwargs)
        s.min_np = min_np  # type: ignore[attr-defined]
        s.max_np = max_np  # type: ignore[attr-defined]
        s.reset_limit = reset_limit  # type: ignore[attr-defined]
        return s

    def __init__(
        self,
        settings: RaySettings,
        discovery: Optional[HostDiscovery] = None,
    ):
        self.settings = settings
        self.min_np = getattr(settings, "min_np", 1)
        self.max_np = getattr(settings, "max_np", None)
        self.reset_limit = getattr(settings, "reset_limit", None)
        self.discovery = discovery or RayHostDiscovery(
            gpus_per_slot=max(settings.gpus_per_worker, 1),
            cpus_per_slot=settings.cpus_per_worker,
        )
        self.driver: Optional[ElasticDriver] = None

    def start(self) -> None:
        self.driver = ElasticDriver(
            self.discovery, min_np=self.min_np, max_np=self.max_np
        )
        self.driver.start()

    def _launch_world(self, hosts_map: Dict[str, int],
                      worker_fn: Callable) -> List[Any]:
        """One generation: place actors per current membership and run
        ``worker_fn`` on each; raises on any worker failure so the outer
        loop can re-place."""
        _require_ray()
        world = min(
            sum(hosts_map.values()),
            self.max_np or sum(hosts_map.values()),
        )
        ex = RayExecutor(self.settings, num_workers=world)
        try:
            ex.start()
            return ex.run(worker_fn)
        finally:
            ex.shutdown()

    def run(self, worker_fn: Callable) -> List[Any]:
        """Elastic loop (reference ``run``, ``elastic.py:266-300``):
        retry with refreshed membership until success or reset_limit."""
        assert self.driver is not None, "call start() first"
        resets = 0
        while True:
            hosts_map = self.driver.wait_for_available_slots(self.min_np)
            try:
                return self._launch_world(hosts_map, worker_fn)
            except Exception as e:  # worker failure → re-place
                resets += 1
                log.warning("elastic ray generation failed: %s", e)
                if (
                    self.reset_limit is not None
                    and resets >= self.reset_limit
                ):
                    raise
                self.driver.consume_membership_change()

    def shutdown(self) -> None:
        if self.driver is not None:
            self.driver.stop()
            self.driver = None
