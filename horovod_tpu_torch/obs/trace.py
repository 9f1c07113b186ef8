"""Unified distributed tracing plane + crash/hang flight recorder.

The port of the JAX package's ``obs/trace.py``: the ring, the dump
schema and the clock model are the same, so either package's
``hvdtpu_trace`` merges the other's dumps.

The scalar metrics plane (:mod:`horovod_tpu_torch.obs.registry`) answers *how
much* — counters, gauges, percentiles. This module answers *when and
where*: a thread-safe, ring-buffer-backed **span recorder** whose events
are Chrome/Perfetto ``trace_event`` dicts, so one merged file shows a
rank's step phases, the driver's round publishes, a serve request's
queue wait and a chaos injection on a single timeline (the reference's
Timeline is the lineage — ``csrc/timeline.{h,cc}`` — generalized from
eager collectives to every plane this repo owns).

Design constraints, in the registry's order:

1. **Near-zero cost when off.** Every site guards on :func:`enabled`
   (one cached module-bool read); :func:`span` returns a shared no-op
   context manager, :func:`instant`/:func:`complete` fall through
   without allocating.
2. **Bounded memory when on.** Events land in a fixed-capacity ring
   (``HVDTPU_TRACE_BUFFER``, default 4096): a week-long job keeps the
   *last* N events — exactly what a flight recorder wants — and an
   event storm cannot grow the process.
3. **Crash evidence survives.** :func:`flight_dump` serializes the ring
   (plus every still-open span, emitted as ``B`` begin events so a hang
   shows WHERE each thread was) to ``HVDTPU_TRACE_DIR`` atomically.
   Dumps fire on SIGTERM/SIGABRT (installed at arm time, chaining any
   existing handler), at interpreter exit, on guard escalation
   (:mod:`horovod_tpu_torch.guard.runtime`), before a chaos ``crash``/
   ``hang`` executes, and from ``horovod_tpu_torch/tools/chaos_soak.py``'s
   deadline teardown.

Clock model: timestamps are **wall-clock microseconds** per process.
Cross-host clocks skew, so ranks record ``clock_sync`` instants when
they observe a driver-published round timestamp (``elastic.worker.
join_world``); ``horovod_tpu_torch/tools/hvdtpu_trace.py`` recovers each rank's offset as
the minimum observed ``local - driver`` delta (KV propagation only adds
positive delay, so the min over rounds converges on the true skew) and
shifts every rank onto the driver's clock at merge time.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils import env as _env

DEFAULT_CAPACITY = 4096

# Schema constants shared with tools/hvdtpu_trace.py and the tests.
CLOCK_SYNC = "clock_sync"
TRACE_FILE_PREFIX = "trace_"


def _now_us() -> int:
    return int(time.time() * 1e6)


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One open span: records ``B`` on the thread's open-stack at entry,
    retires to a single ``X`` (complete) ring event at exit."""

    __slots__ = ("_rec", "_frame")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str,
                 args: Optional[dict]):
        self._rec = rec
        self._frame = {"name": name, "cat": cat, "ts": 0, "args": args}

    def __enter__(self):
        self._frame["ts"] = _now_us()
        self._rec._push_open(self._frame)
        return self

    def __exit__(self, *exc):
        self._rec._pop_open(self._frame)
        return False


class TraceRecorder:
    """Process-wide span ring + open-span books.

    The ring holds finished events (``X``/``i`` dicts in trace_event
    shape, minus ``pid`` which is stamped at dump); ``_open`` maps each
    thread id to its stack of in-flight span frames so a dump taken
    mid-hang can show every thread's current position as ``B`` events.
    """

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = max(16, _env.get_int(
                _env.TRACE_BUFFER, DEFAULT_CAPACITY
            ))
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._open: Dict[int, List[dict]] = {}
        self._lock = threading.Lock()
        self.role: Optional[str] = None
        self.directory: Optional[str] = None
        self.dump_reasons: List[str] = []

    # -- recording (hot path) ---------------------------------------------

    def _emit(self, rec: dict) -> None:
        # deque.append with maxlen is GIL-atomic: oldest event evicted,
        # no lock on the hot path.
        self._ring.append(rec)

    def instant(self, name: str, cat: str = "app",
                args: Optional[dict] = None, scope: str = "t") -> None:
        self._emit({
            "ph": "i", "name": name, "cat": cat, "ts": _now_us(),
            "tid": threading.get_ident(), "s": scope,
            "args": args or {},
        })

    def complete(self, name: str, cat: str, ts_us: int, dur_us: int,
                 args: Optional[dict] = None) -> None:
        """An already-measured span (explicit wall start + duration) —
        what call sites that bracket with ``perf_counter`` use."""
        self._emit({
            "ph": "X", "name": name, "cat": cat, "ts": int(ts_us),
            "dur": max(0, int(dur_us)), "tid": threading.get_ident(),
            "args": args or {},
        })

    def span(self, name: str, cat: str = "app", **args) -> _Span:
        return _Span(self, name, cat, args or None)

    def clock_sync(self, driver_ts: float, **args) -> None:
        """Record an observation of the driver's clock: ``driver_ts``
        is the KV-published wall time (seconds), the event's own ``ts``
        the local wall clock at observation. The merge tool derives
        this rank's offset from the pair."""
        a = {"driver_ts": float(driver_ts)}
        a.update(args)
        self.instant(CLOCK_SYNC, cat="clock", args=a)

    # -- open-span books ---------------------------------------------------

    def _push_open(self, frame: dict) -> None:
        tid = threading.get_ident()
        with self._lock:
            self._open.setdefault(tid, []).append(frame)

    def _pop_open(self, frame: dict) -> None:
        end = _now_us()
        tid = threading.get_ident()
        with self._lock:
            stack = self._open.get(tid)
            if stack and frame in stack:
                stack.remove(frame)
                if not stack:
                    del self._open[tid]
        self._emit({
            "ph": "X", "name": frame["name"], "cat": frame["cat"],
            "ts": frame["ts"], "dur": max(0, end - frame["ts"]),
            "tid": tid, "args": frame["args"] or {},
        })

    def open_spans(self) -> List[dict]:
        """Snapshot of every in-flight span as ``B`` events (the "who
        was where" half of a hang dump)."""
        with self._lock:
            frames = [
                dict(f, tid=tid)
                for tid, stack in self._open.items()
                for f in stack
            ]
        return [
            {"ph": "B", "name": f["name"], "cat": f["cat"],
             "ts": f["ts"], "tid": f["tid"], "args": f["args"] or {}}
            for f in frames
        ]

    # -- identity ----------------------------------------------------------

    def _stem(self) -> str:
        if self.role:
            return self.role
        host = os.environ.get("HVDTPU_HOST_ID")
        if host:
            return host.replace("/", "_")
        return f"rank{_env.launcher_rank_world()[0]}"

    def _dir(self) -> str:
        return self.directory or _env.get_str(
            _env.TRACE_DIR, os.path.join(os.getcwd(), "hvdtpu_trace")
        )

    # -- the flight recorder ----------------------------------------------

    def dump(self, reason: str) -> Optional[str]:
        """Write ring + open spans to ``<dir>/trace_<stem>.<pid>.json``
        atomically (tmp + rename: a merge racing a dump reads the
        previous complete file, never a torn one). The pid suffix keeps
        process GENERATIONS apart: a worker respawned after a blacklist
        shares its predecessor's host stem, and overwriting the dead
        process's dump would discard its clock_sync observations — the
        merge tool pools same-stem files instead. Returns the path, or
        None when the write failed (telemetry is best-effort — a full
        disk must not mask the crash being recorded)."""
        rank, world = _env.launcher_rank_world()
        self.dump_reasons.append(reason)
        stem = self._stem()
        events: List[dict] = [{
            "ph": "M", "name": "process_name", "ts": 0, "tid": 0,
            "args": {"name": stem},
        }]
        events.extend(self._ring)  # snapshot: deque iteration is safe
        events.extend(self.open_spans())
        for ev in events:
            ev.setdefault("pid", rank)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "stem": stem,
                "rank": rank,
                "world": world,
                "role": self.role,
                "host": os.environ.get("HVDTPU_HOST_ID"),
                "os_pid": os.getpid(),
                "reason": reason,
                "reasons": list(self.dump_reasons),
                "dump_ts": time.time(),
            },
        }
        path = os.path.join(
            self._dir(), f"{TRACE_FILE_PREFIX}{stem}.{os.getpid()}.json"
        )
        # pid alone is not unique enough: concurrent dumps from two
        # threads of one process (signal handler vs atexit vs stall
        # breach) would interleave writes into a shared tmp file and
        # os.replace would publish the mangled result.
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(self._dir(), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            return None
        return path

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open.clear()
            self.dump_reasons = []


_recorder: Optional[TraceRecorder] = None
_recorder_lock = threading.Lock()
# Tri-state like the registry: None = read HVDTPU_TRACE lazily, else the
# programmatic override wins over the env.
_enabled: Optional[bool] = None
_armed = False


def recorder() -> TraceRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = TraceRecorder()
    return _recorder


def enabled() -> bool:
    """Is the trace plane on? First ask reads ``HVDTPU_TRACE``; hot
    paths then pay one global read + is-check."""
    global _enabled
    if _enabled is None:
        with _recorder_lock:
            if _enabled is None:
                _enabled = _env.get_bool(_env.TRACE, False)
    if _enabled and not _armed:
        _arm()
    return _enabled


def enable(directory: Optional[str] = None, role: Optional[str] = None,
           capacity: Optional[int] = None) -> TraceRecorder:
    """Programmatically turn tracing on (overrides the env knob);
    optional overrides for the dump directory / file stem / ring size."""
    global _enabled, _recorder
    rec = recorder()
    if capacity is not None and capacity != rec.capacity:
        # Resizing rebuilds the ring (events drop — configure-at-start
        # API); identity settings carry over.
        fresh = TraceRecorder(capacity=capacity)
        fresh.role, fresh.directory = rec.role, rec.directory
        with _recorder_lock:
            _recorder = rec = fresh
    if directory is not None:
        rec.directory = directory
    if role is not None:
        rec.role = role
    _enabled = True
    _arm()
    return rec


def disable() -> None:
    global _enabled
    _enabled = False


def set_role(role: Optional[str]) -> None:
    """Override the dump-file stem (the elastic driver uses ``driver``,
    exactly like :class:`~horovod_tpu_torch.obs.export.MetricsReporter`)."""
    recorder().role = role


def _reset_for_tests() -> None:
    global _enabled, _recorder
    with _recorder_lock:
        _enabled = None
        _recorder = None


# -- module-level recording API (what instrumentation sites call) ---------


def span(name: str, cat: str = "app", **args):
    """Context manager timing one phase; the shared no-op when off."""
    if not enabled():
        return _NULL_SPAN
    return recorder().span(name, cat, **args)


def instant(name: str, cat: str = "app", args: Optional[dict] = None,
            scope: str = "t") -> None:
    if enabled():
        recorder().instant(name, cat, args=args, scope=scope)


def complete(name: str, cat: str, ts_s: float, dur_s: float,
             args: Optional[dict] = None) -> None:
    """Record an already-measured span from wall seconds + duration."""
    if enabled():
        recorder().complete(
            name, cat, int(ts_s * 1e6), int(dur_s * 1e6), args=args
        )


def clock_sync(driver_ts: float, **args) -> None:
    if enabled():
        recorder().clock_sync(driver_ts, **args)


def flight_dump(reason: str) -> Optional[str]:
    """Dump the flight recorder now (no-op when tracing is off)."""
    if not enabled():
        return None
    return recorder().dump(reason)


def mirror_native(ph: str, tid: int, name: str,
                  args: Optional[dict] = None) -> None:
    """Bridge hook for :mod:`horovod_tpu_torch.utils.timeline`: mirror one
    host-timeline record (the eager-collective plane, parity with the
    reference's ``csrc/timeline.cc`` stream) into the span ring under
    ``cat="native"`` — one trace, both planes. The timeline's per-tensor
    pid becomes the mirrored event's ``tid``, so each tensor renders as
    a thread row under this rank's process in the merged view."""
    if not enabled():
        return
    recorder()._emit({
        "ph": ph, "name": name, "cat": "native", "ts": _now_us(),
        "tid": int(tid), "args": args or {},
    })


# -- arming: signal + atexit dump hooks -----------------------------------


def _arm() -> None:
    """One-time installation of the crash-evidence hooks. SIGTERM/
    SIGABRT handlers chain whatever was installed before (and the
    elastic worker's preemption handler — installed later, replacing
    ours — calls :func:`flight_dump` itself, so the dump survives
    either installation order). Signal installation needs the main
    thread; elsewhere the atexit + explicit-dump paths still run."""
    global _armed
    with _recorder_lock:
        if _armed:
            return
        _armed = True
    atexit.register(_atexit_dump)
    import signal as _signal

    for signum in (_signal.SIGTERM, _signal.SIGABRT):
        try:
            prev = _signal.getsignal(signum)

            def _handler(sig, frame, _prev=prev):
                flight_dump(_signal.Signals(sig).name.lower())
                if _prev is _signal.SIG_IGN:
                    return  # the process chose to survive this signal
                if callable(_prev) and _prev is not _signal.SIG_DFL:
                    _prev(sig, frame)
                else:
                    _signal.signal(sig, _signal.SIG_DFL)
                    os.kill(os.getpid(), sig)

            _signal.signal(signum, _handler)
        except (ValueError, OSError):
            # Not the main thread (in-process harness) or an exotic
            # platform: the explicit dump sites still cover us.
            pass


def _atexit_dump() -> None:
    # Only when something was recorded: an idle import must not litter
    # trace files into the cwd of every short-lived process.
    if _enabled and _recorder is not None and (
        len(_recorder._ring) or _recorder._open
    ):
        try:
            _recorder.dump("atexit")
        except Exception:
            pass
