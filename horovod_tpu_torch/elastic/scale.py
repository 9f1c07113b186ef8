"""Queue-depth-driven elastic scaling (the serving workload's policy).

The port of the JAX package's ``elastic/scale.py::QueueDepthPolicy``:
per-worker backlog (``queue_depth / workers``) above ``high`` adds a
worker, backlog below ``low`` (with nothing in flight) removes one, never
past ``min_workers``/``max_workers``, and no two decisions land within
``cooldown_secs`` (hysteresis -- a bursty queue must not flap the pool).
:class:`horovod_tpu_torch.serve.ServePool` asks it for a target worker
count from the live dispatcher gauges when ``autoscale=True``.
"""

from __future__ import annotations

import time
from typing import Optional

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
