"""Queue-depth-driven elastic scaling (the serving workload's policy).

The port of the JAX package's ``elastic/scale.py``. :class:`QueueDepthPolicy`:
per-worker backlog (``queue_depth / workers``) above ``high`` adds a
worker, backlog below ``low`` (with nothing in flight) removes one, never
past ``min_workers``/``max_workers``, and no two decisions land within
``cooldown_secs`` (hysteresis -- a bursty queue must not flap the pool).
:class:`horovod_tpu_torch.serve.ServePool` asks it for a target worker
count from the live dispatcher gauges when ``autoscale=True``;
:class:`PolicyDiscovery` lets the elastic driver scale serving worker
processes by the same policy (``ElasticDriver(scale_policy=...)``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..utils import env as _env


class QueueDepthPolicy:
    """Target-size decisions from queue-depth gauges.

    Pure and clock-injectable (``now=`` in :meth:`decide`), so tests
    drive it against fake gauges without sleeping. Defaults come from the
    serve knobs in ``utils/env.py``.
    """

    def __init__(
        self,
        min_workers: int = 1,
        max_workers: Optional[int] = None,
        high: Optional[float] = None,
        low: Optional[float] = None,
        cooldown_secs: Optional[float] = None,
    ):
        self.min_workers = max(1, int(min_workers))
        self.max_workers = (
            int(max_workers) if max_workers is not None
            else _env.serve_max_workers()
        )
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers={self.max_workers} < "
                f"min_workers={self.min_workers}"
            )
        self.high = high if high is not None else _env.serve_queue_high()
        self.low = low if low is not None else _env.serve_queue_low()
        if self.low >= self.high:
            raise ValueError(
                f"scale-down watermark low={self.low} must sit below "
                f"high={self.high}"
            )
        self.cooldown_secs = (
            cooldown_secs if cooldown_secs is not None
            else _env.serve_scale_cooldown_secs()
        )
        self._last_change = 0.0

    def decide(
        self,
        *,
        queue_depth: float,
        workers: int,
        in_flight: float = 0.0,
        now: Optional[float] = None,
    ) -> int:
        """Target worker count for the observed load (== ``workers``
        means hold). One step per decision."""
        now = time.time() if now is None else now
        workers = max(1, int(workers))
        if now - self._last_change < self.cooldown_secs:
            return workers
        backlog = queue_depth / workers
        target = workers
        if backlog > self.high and workers < self.max_workers:
            target = workers + 1
        elif (
            backlog < self.low
            and in_flight == 0
            and workers > self.min_workers
        ):
            target = workers - 1
        if target != workers:
            self._last_change = now
        return target


class PolicyDiscovery:
    """``HostDiscovery`` wrapper: the inner discovery says what *could*
    run; the policy says how much of it the serving load *needs*.

    ``gauges_fn`` returns the load observation (``queue_depth``, and
    optionally ``in_flight``). Host order is kept stable (sorted), and the
    trim keeps a prefix, so scale-down always removes the same tail host
    -- the driver's survivor-stable rank ordering then drains exactly one
    worker.
    """

    def __init__(
        self,
        inner,
        policy: QueueDepthPolicy,
        gauges_fn: Callable[[], Dict[str, float]],
    ):
        self._inner = inner
        self.policy = policy
        self._gauges_fn = gauges_fn
        self._target: Optional[int] = None
        self._lock = threading.Lock()

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        hosts = self._inner.find_available_hosts_and_slots()
        if not hosts:
            return hosts
        try:
            gauges = self._gauges_fn() or {}
        except Exception:  # a torn gauge read must not kill discovery
            gauges = {}
        with self._lock:
            current = (
                self._target if self._target is not None
                else min(len(hosts), self.policy.min_workers)
            )
            current = max(1, min(current, len(hosts)))
            self._target = self.policy.decide(
                queue_depth=float(gauges.get("queue_depth", 0.0)),
                in_flight=float(gauges.get("in_flight", 0.0)),
                workers=current,
            )
            target = min(self._target, len(hosts))
        kept = sorted(hosts)[:target]
        return {h: hosts[h] for h in kept}
