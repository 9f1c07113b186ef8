"""Stall inspector: detect ranks whose tensors never arrive.

The port of the JAX package's ``utils/stall.py`` (kept as a copy: this
package imports nothing of it). Parity: ``horovod/common/stall_inspector.cc``
(``stall_inspector.h:30-96``) -- rank 0 warns when a tensor was submitted
by some ranks but not all for longer than 60 s (``:76-80``), optionally
shuts the job down after ``HVDTPU_STALL_SHUTDOWN_TIME_SECONDS``.

Used by the coordinator of the dynamic-enqueue runtime
(:mod:`horovod_tpu_torch.native.controller`) and by the eager collectives'
watchdog (:mod:`horovod_tpu_torch.ops.eager`); the ``stall.pending``,
``stall.max_age_s`` and ``stall.age_s.<name>`` gauges go to the metrics
plane (:mod:`horovod_tpu_torch.obs`) under the JAX package's names.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from . import env as _env

log = logging.getLogger("horovod_tpu_torch.stall")


class StallInspector:
    def __init__(
        self,
        warning_time: Optional[float] = None,
        shutdown_time: Optional[float] = None,
        on_shutdown: Optional[Callable[[List[str]], None]] = None,
        local_view: bool = False,
    ):
        # local_view: this process only knows its own join state (the
        # eager watchdog case) — warnings must not claim which peers are
        # missing, because that list would be fabricated.
        self.local_view = local_view
        self.enabled = not _env.get_bool(_env.STALL_CHECK_DISABLE, False)
        self.warning_time = (
            warning_time
            if warning_time is not None
            else _env.get_float(
                _env.STALL_CHECK_TIME_SECONDS, _env.DEFAULT_STALL_WARNING_SECS
            )
        )
        self.shutdown_time = (
            shutdown_time
            if shutdown_time is not None
            else _env.get_float(_env.STALL_SHUTDOWN_TIME_SECONDS, 0.0)
        )
        self._on_shutdown = on_shutdown
        # tensor -> (first_seen_ts, ranks that reported it); callers may
        # record/remove from one thread while a watchdog thread scans, so
        # all state is guarded by a lock.
        self._pending: Dict[str, tuple] = {}
        self._warned: Set[str] = set()
        # Tensors whose age gauge is live in the metrics plane, and
        # whether check() ever exported (guarded by the lock: check()
        # runs in watcher threads, remove_tensor on the caller's).
        self._gauged: Set[str] = set()
        self._exported = False
        self._lock = threading.Lock()

    def record_uncached_tensor(self, name: str, rank: int) -> None:
        """A rank submitted ``name``; the collective is still incomplete."""
        if not self.enabled:
            return
        with self._lock:
            ts, ranks = self._pending.get(name, (time.time(), set()))
            ranks.add(rank)
            self._pending[name] = (ts, ranks)

    def remove_tensor(self, name: str) -> None:
        """The collective completed everywhere.

        Also refreshes the stall gauges: the watcher thread that runs
        ``check()`` exits when its collective completes, so without this
        the last exported pending-count/age would stay frozen in every
        later flush — a phantom permanent stall in ``hvdtpu_top``.
        """
        from ..obs import registry as _obs

        with self._lock:
            self._pending.pop(name, None)
            self._warned.discard(name)
            if not self._exported or not _obs.enabled():
                return  # no gauges ever written; nothing to refresh
            # Registry updates stay under the lock so a concurrent
            # check() export cannot resurrect this tensor's gauge.
            reg = _obs.metrics()
            if name in self._gauged:
                self._gauged.discard(name)
                reg.remove_gauge(f"stall.age_s.{name}")
            now = time.time()
            reg.gauge("stall.pending").set(len(self._pending))
            reg.gauge("stall.max_age_s").set(
                max(
                    (now - ts for ts, _r in self._pending.values()),
                    default=0.0,
                )
            )

    def check(self, world_size: int) -> List[str]:
        """Scan for stalls; returns currently-stalled tensor names.

        Logs one warning per stalled tensor listing the missing ranks
        (the reference's message shape); triggers shutdown when a stall
        exceeds ``shutdown_time``.

        One locked pass computes everything — snapshot, first-warn
        decisions and the kill list — so the scan takes the lock once
        instead of re-locking per pending tensor, and all logging (which
        can block on slow handlers) happens outside the lock.
        """
        if not self.enabled:
            return []
        now = time.time()
        stalled: List[str] = []
        to_kill: List[str] = []
        warn_now: List[tuple] = []
        ages: Dict[str, float] = {}
        with self._lock:
            for name, (ts, ranks) in self._pending.items():
                age = now - ts
                ages[name] = age
                if age < self.warning_time:
                    continue
                stalled.append(name)
                if name not in self._warned:
                    self._warned.add(name)
                    warn_now.append((name, age, set(ranks)))
                if self.shutdown_time and age > self.shutdown_time:
                    to_kill.append(name)
        self._export_gauges(ages)
        for name, age, ranks in warn_now:
            if self.local_view:
                log.warning(
                    "Collective %s has not completed after %.0fs — one or "
                    "more peer processes have likely not joined it (peer "
                    "join state unknown from this process)",
                    name, age,
                )
            else:
                missing = sorted(set(range(world_size)) - ranks)
                log.warning(
                    "One or more tensors were submitted to be reduced/"
                    "gathered but some ranks have not yet joined: %s "
                    "(waited %.0fs; missing ranks: %s)",
                    name, age, missing,
                )
        if to_kill:
            # The shutdown breach IS a hang verdict: ship the flight
            # recorder before tearing anything down, so the post-mortem
            # has the stalled collectives' spans, not just this log line.
            from ..obs import trace as _trace

            _trace.instant(
                "stall.shutdown", cat="elastic",
                args={"tensors": sorted(to_kill)[:8]},
            )
            _trace.flight_dump("stall_shutdown")
            log.error(
                "Stalled tensors exceeded shutdown threshold: %s", to_kill
            )
            if self._on_shutdown:
                self._on_shutdown(to_kill)
            else:
                raise RuntimeError(
                    f"stalled collectives exceeded "
                    f"{self.shutdown_time}s: {to_kill}"
                )
        return stalled

    def _export_gauges(self, ages: Dict[str, float]) -> None:
        """Surface the scan into the metrics plane: pending count, the
        oldest pending age, and a per-tensor age gauge (removed — not
        zeroed — when the tensor completes: eager op labels are unique
        per call, so retired gauges would otherwise accumulate in the
        registry and bloat every later export). Registry updates happen
        under the lock, re-filtered against the live pending set, so a
        completion racing this export can't leave a phantom gauge."""
        from ..obs import registry as _obs

        if not _obs.enabled():
            return
        reg = _obs.metrics()
        with self._lock:
            ages = {n: a for n, a in ages.items() if n in self._pending}
            self._exported = True
            reg.gauge("stall.pending").set(len(ages))
            reg.gauge("stall.max_age_s").set(
                max(ages.values()) if ages else 0.0
            )
            stale = self._gauged - set(ages)
            self._gauged -= stale
            for name, age in ages.items():
                self._gauged.add(name)
                reg.gauge(f"stall.age_s.{name}").set(age)
            for name in stale:
                reg.remove_gauge(f"stall.age_s.{name}")
