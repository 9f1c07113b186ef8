"""Thread-safe metrics registry: counters, gauges, ring-buffer histograms.

The port of the JAX package's ``obs/registry.py``, unchanged in its
names and arithmetic (percentiles are nearest-rank on the same ring).

Design constraints, in order:

1. **Near-zero cost when disabled.** Every instrumentation site guards
   with :func:`enabled` (one cached module-level boolean read) or uses
   the shared :data:`null_registry`, whose instruments are no-op
   singletons — no locks, no allocation, no string formatting on the
   disabled path.
2. **Cheap when enabled.** Increments are single bytecode-atomic ops
   under the GIL plus one dict lookup; instrument *creation* takes the
   registry lock, so hot paths should hold the instrument object
   (``C = metrics().counter("x")`` once, ``C.inc()`` per event) — every
   in-tree call site does.
3. **Bounded memory.** Histograms are fixed-size ring buffers (default
   512 samples): percentiles reflect the recent window, total count and
   sum are cumulative, and a long job cannot grow the registry.

The reference keeps the analogous books inside ``HorovodGlobalState``
and surfaces them only through the timeline; here they are a first-class
queryable plane (``snapshot()`` → plain dicts) that the exporters in
:mod:`horovod_tpu_torch.obs.export` serialize.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

from ..utils import env as _env

DEFAULT_HISTOGRAM_WINDOW = 512
# Events (elastic rescales, blacklists, …) kept for export; a ring so an
# event storm cannot grow without bound.
DEFAULT_EVENT_WINDOW = 256


class Counter:
    """Monotonic counter. ``inc`` is GIL-atomic enough for telemetry:
    ``+=`` on an int is one value race at worst, never corruption."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def get(self) -> int:
        return self.value


class Gauge:
    """Last-value instrument (set-only; ``add`` for convenience)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, v: float) -> None:
        self.value += float(v)

    def get(self) -> float:
        return self.value


class Histogram:
    """Ring-buffer histogram: cumulative count/sum, windowed percentiles.

    ``observe`` appends into a preallocated list under a small per-
    instrument lock (contention is per-metric, not registry-wide).
    ``summary()`` sorts a copy of the window — export-time cost, not
    hot-path cost.
    """

    __slots__ = ("name", "window", "_buf", "_idx", "count", "sum", "max", "_lock")

    def __init__(self, name: str, window: int = DEFAULT_HISTOGRAM_WINDOW):
        self.name = name
        self.window = window
        self._buf: List[float] = []
        self._idx = 0
        self.count = 0
        self.sum = 0.0
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if len(self._buf) < self.window:
                self._buf.append(v)
            else:
                self._buf[self._idx] = v
                self._idx = (self._idx + 1) % self.window
            self.count += 1
            self.sum += v
            if v > self.max:
                self.max = v

    def _percentile(self, sorted_buf: List[float], q: float) -> float:
        # Nearest-rank on the sorted window (simple, monotone, exact at
        # the edges); the window is small so exactness beats interpolation.
        if not sorted_buf:
            return float("nan")
        k = min(len(sorted_buf) - 1, max(0, math.ceil(q * len(sorted_buf)) - 1))
        return sorted_buf[k]

    def summary(self) -> Dict[str, Optional[float]]:
        # Empty histograms report None (JSON null), never NaN: the JSONL
        # schema must stay parseable by strict consumers (jq), and
        # json.dumps would otherwise emit a bare NaN literal.
        with self._lock:
            buf = list(self._buf)
            count, total, vmax = self.count, self.sum, self.max
        if not count:
            return {
                "count": 0, "mean": None, "p50": None, "p95": None,
                "p99": None, "max": None,
            }
        buf.sort()
        return {
            "count": count,
            "mean": total / count,
            "p50": self._percentile(buf, 0.50),
            "p95": self._percentile(buf, 0.95),
            "p99": self._percentile(buf, 0.99),
            "max": vmax,
        }


class _NullInstrument:
    """Shared no-op stand-in for every instrument kind."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def get(self) -> float:
        return 0.0

    def summary(self) -> Dict[str, float]:
        return {}


_NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Named instruments, created on first use, snapshotted for export."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._events: List[dict] = []
        self._lock = threading.Lock()

    # -- instrument accessors (create-on-first-use, then lock-free) -----
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(
        self, name: str, window: int = DEFAULT_HISTOGRAM_WINDOW
    ) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name, window))
        return h

    def remove_gauge(self, name: str) -> None:
        """Drop a gauge entirely (dynamic per-entity gauges — e.g. the
        per-tensor stall ages — must be removed when the entity goes
        away, or a long job grows the registry without bound)."""
        with self._lock:
            self._gauges.pop(name, None)

    def event(self, kind: str, **fields) -> None:
        """Record a discrete occurrence (rescale, blacklist, …) with a
        wall-clock timestamp; exported once then retired (the JSONL is
        the durable record, the ring only buffers between flushes)."""
        rec = {"ts": time.time(), "kind": kind}
        rec.update(fields)
        with self._lock:
            self._events.append(rec)
            if len(self._events) > DEFAULT_EVENT_WINDOW:
                del self._events[: -DEFAULT_EVENT_WINDOW]

    def drain_events(self) -> List[dict]:
        with self._lock:
            out, self._events = self._events, []
        return out

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-dict view of every instrument (histograms summarized)."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        return {
            "counters": {c.name: c.get() for c in counters},
            "gauges": {g.name: g.get() for g in gauges},
            "histograms": {h.name: h.summary() for h in hists},
        }

    def reset(self) -> None:
        """Drop every instrument (tests; a live job never needs this)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._events.clear()


class _NullRegistry(MetricsRegistry):
    """Registry whose instruments are all the shared no-op singleton."""

    def counter(self, name: str):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def gauge(self, name: str):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def histogram(self, name: str, window: int = 0):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def event(self, kind: str, **fields) -> None:
        pass


null_registry = _NullRegistry()

_registry = MetricsRegistry()
# Tri-state: None = read HVDTPU_METRICS lazily on first ask, else the
# programmatic override (enable()/disable()) wins over the env.
_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()


def enabled() -> bool:
    """Is the metrics plane on? First call reads ``HVDTPU_METRICS``;
    the result is cached so hot paths pay one global read + is-check."""
    global _enabled
    if _enabled is None:
        with _enabled_lock:
            if _enabled is None:
                _enabled = _env.get_bool(_env.METRICS, False)
    return _enabled


def enable() -> MetricsRegistry:
    """Programmatically turn the plane on (overrides the env knob)."""
    global _enabled
    _enabled = True
    return _registry


def disable() -> None:
    global _enabled
    _enabled = False


def metrics() -> MetricsRegistry:
    """The process registry when enabled, else the no-op registry —
    call sites never branch themselves."""
    return _registry if enabled() else null_registry
