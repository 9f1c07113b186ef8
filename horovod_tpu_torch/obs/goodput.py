"""Goodput ledger: wall-clock attribution, every second exactly once.

The port of the JAX package's ``obs/goodput.py``, line for line: the
categories, priorities, sweep and journal state are the same, so either
package's report tools read the other's exports.

Per-process accounting state machine that attributes elapsed wall-clock
time into a **closed** category set, fed from the instrumentation points
the other planes already own (the dp step bracket, the prefetch stall
arg, the elastic join bracket, driver round-publish / lease-expiry
windows, serve lifecycle spans, guard skip instants). The conservation
contract — ``sum(categories) == elapsed`` within float tolerance — holds
by construction: attribution is a sweep over elementary time segments,
each segment assigned to exactly one category (highest-priority covering
interval wins; uncovered time is the explicit ``other`` residual, never
silently dropped).

Categories (also the runbook triage rows ``horovod_tpu_torch/tools/check_metric_names.py``
enforces against ``docs/runbook.md``):

====================  ====================================================
``compute``           device busy on useful work (step device bracket,
                      decode rounds)
``host_dispatch``     jitted-call return path: Python + tracing cache +
                      transfer enqueue
``input_stall``       prefetch queue empty when the step needed a batch
``exposed_comm``      device-time excess over the rolling-min baseline —
                      the non-overlapped collective / straggler stretch
``checkpoint``        blocking save bracket
``guard_retry``       steps discarded by the gradient guard
``rescale_downtime``  elastic world rebuild: join/rejoin brackets,
                      driver round publish + lease-expiry windows
``adoption_gap``      wall-clock between a driver's last journaled
                      heartbeat and its adopter restoring state
``autotune_search``   autotuner trial windows (measuring, not converged)
``serve_idle``        decode worker parked, queue empty
``serve_queue``       decode worker waiting with work queued (admission /
                      KV-pressure blocked)
``serve_swap``        hot-swap bracket (weights reload)
``other``             uninstrumented residual (the conservation remainder)
====================  ====================================================

Metric names owned here (single-owner scan): ``goodput.<category>_s``
gauges, ``goodput.elapsed_s``, ``goodput.fraction``.

Enablement mirrors the metrics plane: ``HVDTPU_GOODPUT`` env (or
``enable()``/``disable()``), tri-state cached so the off path costs one
boolean per feed call. The ledger itself is bounded: at most
``HVDTPU_GOODPUT_WINDOW`` pending intervals; older ones are settled
(swept into per-category totals behind a watermark) and late arrivals
behind the watermark reclassify settled ``other`` time, preserving the
conservation sum.

``state_dict()``/``load_state_dict()`` let the driver's roll-up ride the
control-plane journal (``_driver_state()["goodput"]``): an adopter loads
the dead driver's totals and attributes the takeover gap itself to
``adoption_gap`` (a clock running backwards across the adoption clamps
the gap to zero rather than corrupting the sum).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from . import registry as _obs
from ..utils import env as _env

# Closed category set. Order here is the canonical presentation order
# (reports, panels); attribution priority is separate, below.
CATEGORIES: Tuple[str, ...] = (
    "compute",
    "host_dispatch",
    "input_stall",
    "exposed_comm",
    "checkpoint",
    "guard_retry",
    "rescale_downtime",
    "adoption_gap",
    "autotune_search",
    "serve_idle",
    "serve_queue",
    "serve_swap",
    "other",
)

# Overlap resolution: when intervals cover the same instant, the highest
# priority wins (ties: later start wins — innermost bracket). Fault /
# recovery time outranks steady-state phases so an injected fault's lost
# seconds land in its category even when a step bracket spans it.
PRIORITY: Dict[str, int] = {
    "adoption_gap": 110,
    "rescale_downtime": 100,
    "checkpoint": 90,
    "guard_retry": 80,
    "autotune_search": 70,
    "input_stall": 60,
    "serve_swap": 50,
    "serve_queue": 40,
    "serve_idle": 30,
    "exposed_comm": 20,
    "host_dispatch": 10,
    "compute": 0,
    "other": -1,  # residual only; never attached to an interval
}

# Samples of device time kept for the exposed_comm rolling-min baseline,
# and the warmup before the estimator trusts it.
_BASELINE_SAMPLES = 64
_BASELINE_WARMUP = 5

# Runbook triage row per category — the report tool links each downtime
# cause to its remediation row, and the goodput-runbook lint gate checks
# docs/runbook.md names every category.
RUNBOOK_ROWS: Dict[str, str] = {
    "compute": "goodput: compute",
    "host_dispatch": "goodput: host_dispatch",
    "input_stall": "goodput: input_stall",
    "exposed_comm": "goodput: exposed_comm",
    "checkpoint": "goodput: checkpoint",
    "guard_retry": "goodput: guard_retry",
    "rescale_downtime": "goodput: rescale_downtime",
    "adoption_gap": "goodput: adoption_gap",
    "autotune_search": "goodput: autotune_search",
    "serve_idle": "goodput: serve_idle",
    "serve_queue": "goodput: serve_queue",
    "serve_swap": "goodput: serve_swap",
    "other": "goodput: other",
}


def _attribute(
    intervals: List[Tuple[float, float, str]], lo: float, hi: float
) -> Dict[str, float]:
    """Sweep ``[lo, hi]``: each elementary segment goes to the covering
    interval with the highest ``(priority, start)``; uncovered segments
    go to ``other``. The returned seconds sum to exactly ``hi - lo``
    (modulo float addition), which is the conservation invariant."""
    out = {c: 0.0 for c in CATEGORIES}
    if hi <= lo:
        return out
    clipped: List[Tuple[float, float, str]] = []
    points = {lo, hi}
    for start, end, cat in intervals:
        s, e = max(start, lo), min(end, hi)
        if e > s:
            clipped.append((s, e, cat))
            points.add(s)
            points.add(e)
    cuts = sorted(points)
    for a, b in zip(cuts, cuts[1:]):
        best_key: Optional[Tuple[int, float]] = None
        best_cat = "other"
        for s, e, cat in clipped:
            if s <= a and e >= b:
                key = (PRIORITY[cat], s)
                if best_key is None or key > best_key:
                    best_key = key
                    best_cat = cat
        out[best_cat] += b - a
    return out


class GoodputLedger:
    """Interval ledger with bounded memory and exact conservation.

    Thread-safe: feeds arrive from the training loop, prefetch consumer,
    decode workers, and the driver poll loop; every mutation holds
    ``_lock``. Attribution cost is paid on ``totals()`` (a sweep over
    the pending window), not per feed — feeds are list appends.
    """

    def __init__(self, window: Optional[int] = None):
        self._lock = threading.Lock()
        self._window = int(window) if window else _env.goodput_window()
        self._pending: List[Tuple[float, float, str]] = []
        self._settled: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self._settled_upto: Optional[float] = None  # watermark (wall s)
        self._origin: Optional[float] = None  # earliest instant seen
        self._last_ts: Optional[float] = None  # latest instant seen
        # Carried over an adoption: the predecessor's totals + elapsed.
        self._carried: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self._carried_elapsed = 0.0
        # exposed_comm estimator state: recent device-bracket durations;
        # the rolling min is the no-interference baseline.
        self._device_samples: List[float] = []
        # Last step bracket, for guard-skip reclassification (the guard
        # verdict for step N is read at step N+1).
        self._last_step: Optional[Tuple[float, float]] = None

    # -- feeding -----------------------------------------------------------

    def add(self, category: str, start: float, duration: float) -> None:
        """Record ``duration`` seconds starting at wall-clock ``start``
        as ``category``. Overlaps with other intervals are resolved at
        attribution time; a non-positive duration is a no-op."""
        if category not in PRIORITY or category == "other":
            raise ValueError(f"unknown goodput category: {category!r}")
        if duration <= 0:
            return
        end = start + duration
        with self._lock:
            self._note_span_locked(start, end)
            wm = self._settled_upto
            if wm is not None and start < wm:
                # Late arrival behind the watermark: reclassify what we
                # can from the settled residual so conservation holds.
                late = min(end, wm) - start
                take = min(late, self._settled["other"])
                if take > 0:
                    self._settled["other"] -= take
                    self._settled[category] += take
                start = wm
                if end <= start:
                    return
            self._pending.append((start, end, category))
            if len(self._pending) > self._window:
                self._settle_oldest_locked()

    def record_step(
        self, w0: float, total_s: float, dispatch_s: float, device_s: float
    ) -> None:
        """One training-step bracket: ``[w0, w0+dispatch_s]`` is
        host_dispatch, the rest compute — minus the exposed_comm tail,
        the device time in excess of the rolling-min baseline (lockstep
        collectives stretch every rank's device bracket when one rank
        straggles, so the excess is the exposed communication)."""
        if total_s <= 0:
            return
        self.add("host_dispatch", w0, dispatch_s)
        compute_s = max(0.0, total_s - dispatch_s)
        self.add("compute", w0 + dispatch_s, compute_s)
        with self._lock:
            self._last_step = (w0, total_s)
            excess = self._baseline_excess_locked(device_s)
        if excess > 0:
            # Carve the tail of the device slice: exposed_comm outranks
            # compute in the sweep, so this reclassifies, not double
            # counts.
            self.add("exposed_comm", w0 + total_s - excess, excess)

    def record_guard_skip(self) -> None:
        """The guard discarded the previous step: reclassify its bracket
        (guard_retry outranks compute/host_dispatch in the sweep)."""
        with self._lock:
            last = self._last_step
        if last is not None:
            self.add("guard_retry", last[0], last[1])

    def touch(self, now: Optional[float] = None) -> None:
        """Mark the ledger's owner alive at ``now`` without attributing
        any category: advances the elapsed span (the unattributed stretch
        sweeps to ``other``) and, through ``state_dict``'s ``last_ts``,
        the adoption-gap anchor — a journaling driver is alive at every
        state write even when no downtime window is open."""
        if now is None:
            now = time.time()
        with self._lock:
            self._note_span_locked(now, now)

    def note_gap(self, last_ts: float, now: Optional[float] = None) -> float:
        """Attribute ``now - last_ts`` to ``adoption_gap`` (clamped at
        zero when the adopter's clock is behind the journaled stamp).
        Returns the gap actually recorded."""
        if now is None:
            now = time.time()
        gap = max(0.0, now - float(last_ts))
        if gap > 0:
            self.add("adoption_gap", now - gap, gap)
        return gap

    # -- internal ----------------------------------------------------------

    def _note_span_locked(self, start: float, end: float) -> None:
        if self._origin is None or start < self._origin:
            self._origin = start
        if self._last_ts is None or end > self._last_ts:
            self._last_ts = end

    def _baseline_excess_locked(self, device_s: float) -> float:
        samples = self._device_samples
        samples.append(device_s)
        if len(samples) > _BASELINE_SAMPLES:
            del samples[0]
        if len(samples) < _BASELINE_WARMUP:
            return 0.0
        return max(0.0, device_s - min(samples))

    def _settle_oldest_locked(self) -> None:
        """Fold the oldest half of the pending window into settled
        totals behind an advanced watermark. Intervals spanning the cut
        are split; the settled region is swept exactly once."""
        self._pending.sort(key=lambda iv: iv[0])
        cut_idx = max(1, len(self._pending) // 2)
        cut = self._pending[cut_idx][0]
        lo = self._settled_upto
        if lo is None:
            lo = self._origin if self._origin is not None else cut
        if cut <= lo:
            # Degenerate (identical starts): push the cut past them.
            cut = max(end for _, end, _ in self._pending[:cut_idx])
            if cut <= lo:
                return
        swept = _attribute(self._pending, lo, cut)
        for cat, secs in swept.items():
            self._settled[cat] += secs
        self._pending = [
            (max(s, cut), e, c) for s, e, c in self._pending if e > cut
        ]
        self._settled_upto = cut

    # -- reading -----------------------------------------------------------

    def totals(self) -> Dict[str, float]:
        """Per-category seconds over everything observed (carried +
        settled + a non-destructive sweep of the pending window).
        ``sum(totals().values()) == elapsed_s()`` within tolerance."""
        with self._lock:
            return self._totals_locked()

    def _totals_locked(self) -> Dict[str, float]:
        out = {c: self._carried[c] + self._settled[c] for c in CATEGORIES}
        if self._last_ts is not None:
            lo = self._settled_upto
            if lo is None:
                lo = self._origin if self._origin is not None else self._last_ts
            for cat, secs in _attribute(self._pending, lo, self._last_ts).items():
                out[cat] += secs
        return out

    def elapsed_s(self) -> float:
        with self._lock:
            return self._elapsed_locked()

    def _elapsed_locked(self) -> float:
        local = 0.0
        if self._origin is not None and self._last_ts is not None:
            local = self._last_ts - self._origin
        return self._carried_elapsed + local

    def snapshot(self) -> Dict[str, object]:
        """Totals + elapsed + goodput fraction (compute / elapsed), one
        consistent read."""
        with self._lock:
            totals = self._totals_locked()
            elapsed = self._elapsed_locked()
        fraction = (totals["compute"] / elapsed) if elapsed > 0 else 0.0
        return {
            "totals": totals,
            "elapsed_s": elapsed,
            "fraction": fraction,
        }

    # -- journal / adoption ------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        """Journalable state: totals, elapsed, and the last wall-clock
        instant this ledger observed (the adoption-gap anchor)."""
        with self._lock:
            return {
                "version": 1,
                "totals": self._totals_locked(),
                "elapsed_s": self._elapsed_locked(),
                "last_ts": (
                    self._last_ts if self._last_ts is not None else time.time()
                ),
            }

    def load_state_dict(
        self, state: Dict[str, object], now: Optional[float] = None
    ) -> float:
        """Adopt a predecessor's ledger: carry its totals + elapsed and
        attribute the takeover gap (``now - state['last_ts']``, clamped
        at zero for a backwards clock) to ``adoption_gap``. Raises
        ``ValueError`` on malformed state so the caller can fall back to
        a fresh ledger. Returns the gap recorded."""
        if not isinstance(state, dict) or state.get("version") != 1:
            raise ValueError(f"unsupported goodput state: {state!r}")
        try:
            totals = dict(state["totals"])
            elapsed = float(state["elapsed_s"])
            last_ts = float(state["last_ts"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed goodput state: {e}") from e
        if now is None:
            now = time.time()
        gap = max(0.0, now - last_ts)
        with self._lock:
            for cat in CATEGORIES:
                self._carried[cat] += float(totals.get(cat, 0.0))
            self._carried["adoption_gap"] += gap
            self._carried_elapsed += elapsed + gap
        return gap


# -- module plane (per-process singleton + feed helpers) --------------------

_state_lock = threading.Lock()
_enabled: Optional[bool] = None  # tri-state: None = ask the env
_ledger: Optional[GoodputLedger] = None
_publish_every = 16  # feeds between gauge refreshes (sweep cost cap)
_feeds_since_publish = 0


def enabled() -> bool:
    """Cached tri-state enablement (``HVDTPU_GOODPUT``)."""
    global _enabled
    if _enabled is None:
        _enabled = _env.goodput_default()
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def ledger() -> GoodputLedger:
    """The process ledger (created on first use)."""
    global _ledger
    with _state_lock:
        if _ledger is None:
            _ledger = GoodputLedger()
        return _ledger


def _reset_for_tests() -> None:
    global _enabled, _ledger, _feeds_since_publish
    with _state_lock:
        _enabled = None
        _ledger = None
        _feeds_since_publish = 0


def _fed() -> None:
    """Throttled gauge refresh: publishing sweeps the pending window, so
    it runs every ``_publish_every`` feeds, not on each one."""
    global _feeds_since_publish
    with _state_lock:
        _feeds_since_publish += 1
        due = _feeds_since_publish >= _publish_every
        if due:
            _feeds_since_publish = 0
    if due:
        publish()


def record_step(
    w0: float, total_s: float, dispatch_s: float, device_s: float
) -> None:
    if not enabled():
        return
    ledger().record_step(w0, total_s, dispatch_s, device_s)
    _fed()


def record_input_stall(w0: float, duration_s: float) -> None:
    if not enabled():
        return
    ledger().add("input_stall", w0, duration_s)
    _fed()


def record_checkpoint(w0: float, duration_s: float) -> None:
    if not enabled():
        return
    ledger().add("checkpoint", w0, duration_s)
    _fed()


def record_guard_skip() -> None:
    if not enabled():
        return
    ledger().record_guard_skip()
    _fed()


def record_rescale(w0: float, duration_s: float) -> None:
    if not enabled():
        return
    ledger().add("rescale_downtime", w0, duration_s)
    _fed()


def record_autotune(w0: float, duration_s: float) -> None:
    if not enabled():
        return
    ledger().add("autotune_search", w0, duration_s)
    _fed()


_SERVE_KINDS = {
    "idle": "serve_idle",
    "queue": "serve_queue",
    "swap": "serve_swap",
    "compute": "compute",
}


def record_serve(kind: str, w0: float, duration_s: float) -> None:
    """Decode-engine lifecycle feed: ``kind`` is one of ``idle`` (parked,
    queue empty), ``queue`` (waiting with work queued), ``swap`` (hot
    swap), ``compute`` (a decode round)."""
    if not enabled():
        return
    ledger().add(_SERVE_KINDS[kind], w0, duration_s)
    _fed()


def publish(source: Optional[GoodputLedger] = None) -> Dict[str, object]:
    """Export a ledger snapshot as gauges — the ONLY place ``goodput.*``
    metric names are written (single-owner scan). Returns the snapshot
    so callers (bench, driver) can reuse the consistent read."""
    src = source if source is not None else ledger()
    snap = src.snapshot()
    reg = _obs.metrics()
    for cat in CATEGORIES:
        reg.gauge(f"goodput.{cat}_s").set(snap["totals"][cat])
    reg.gauge("goodput.elapsed_s").set(snap["elapsed_s"])
    reg.gauge("goodput.fraction").set(snap["fraction"])
    return snap
