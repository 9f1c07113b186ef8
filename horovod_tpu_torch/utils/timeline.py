"""Timeline: chrome-tracing JSON of per-tensor collective lifecycles.

The port of the JAX package's ``utils/timeline.py`` (parity with the
reference's ``horovod/common/timeline.cc``: a writer thread, tensors as
pids, NEGOTIATE/QUEUE/op activities, runtime start/stop, cycle marks via
``HOROVOD_TIMELINE_MARK_CYCLES``). Host-side lifecycle events -- the
fusion buckets' pack, reduce and unpack -- are recorded here and mirrored
into the span ring (:mod:`..obs.trace`) when tracing is on. The device
half is :mod:`torch.profiler`: :func:`start_torch_profiler` /
:func:`stop_torch_profiler` bracket the run and write its Chrome trace
beside the timeline (``<path>.torch.json``), where the JAX package
brackets it with ``jax.profiler``. Enabled via ``HVDTPU_TIMELINE``
(``HOROVOD_TIMELINE`` accepted), written by a dedicated writer thread so
the hot path only pays a queue put.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict, Optional

from . import env as _env

# Activity names (reference common.h:32-63).
NEGOTIATE_ALLREDUCE = "NEGOTIATE_ALLREDUCE"
NEGOTIATE_ALLGATHER = "NEGOTIATE_ALLGATHER"
NEGOTIATE_BROADCAST = "NEGOTIATE_BROADCAST"
NEGOTIATE_ALLTOALL = "NEGOTIATE_ALLTOALL"
QUEUE = "QUEUE"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
XLA_ALLREDUCE = "XLA_ALLREDUCE"
XLA_ALLGATHER = "XLA_ALLGATHER"
XLA_BROADCAST = "XLA_BROADCAST"
XLA_ALLTOALL = "XLA_ALLTOALL"
# The port's collective activity (a torch.distributed call on a bucket).
DIST_ALLREDUCE = "DIST_ALLREDUCE"
DIST_REDUCE_SCATTER = "DIST_REDUCE_SCATTER"
DIST_ALLGATHER = "DIST_ALLGATHER"


class Timeline:
    """Chrome-trace writer; one pid per tensor name, writer thread owns IO."""

    def __init__(self, path: Optional[str] = None,
                 mark_cycles: Optional[bool] = None):
        self._path = path
        self._queue: "queue.Queue" = queue.Queue()
        self._pids: Dict[str, int] = {}
        self._next_pid = 1
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._file = None
        self._started = False
        self._drained = threading.Event()
        self._mark_cycles = (_env.get_bool(_env.TIMELINE_MARK_CYCLES, False)
                             if mark_cycles is None else mark_cycles)
        self._t0 = time.perf_counter()

    # -- lifecycle ---------------------------------------------------------
    # threadlint: start/stop are main-thread lifecycle transitions. The
    # writer thread receives its queue/file/event as ARGUMENTS (never
    # reads them off self), so rebinding these attributes here cannot
    # race it; _started is a monotonic latch whose worst-case stale read
    # drops one enqueue during shutdown, by design.
    def start(self, path: Optional[str] = None) -> None:
        """Runtime start (parity: ``horovod_start_timeline``)."""
        if self._started:
            return
        self._path = path or self._path or _env.get_str(_env.TIMELINE)  # threadlint: allow[unlocked-attr-write] pre-thread setup
        if not self._path:
            return
        self._file = open(self._path, "w")  # threadlint: allow[unlocked-attr-write] pre-thread setup
        self._file.write("[\n")
        # Wall epoch of this file's ts=0: timeline stamps are relative
        # perf_counter µs, and tools/hvdtpu_trace.py uses this metadata
        # record to rebase a standalone timeline file onto wall clock
        # when merging it with the span plane's dumps.
        self._file.write(json.dumps({
            "ph": "M", "pid": 0, "tid": 0, "ts": 0, "name": "trace_epoch",
            "args": {"wall": time.time() - (time.perf_counter() - self._t0)},
        }) + ",\n")
        self._drained = threading.Event()  # threadlint: allow[unlocked-attr-write] pre-thread setup
        # Fresh queue per start, and the writer gets its queue/file/event
        # as arguments: a writer left wedged by a drain-timeout stop()
        # keeps its OWN file object and can never write into (or steal
        # records from) a restarted timeline.
        self._queue = queue.Queue()  # threadlint: allow[unlocked-attr-write] pre-thread setup
        self._thread = threading.Thread(  # threadlint: allow[unlocked-attr-write] pre-thread setup
            target=self._writer_loop,
            args=(self._queue, self._file, self._drained),
            daemon=True,
        )
        self._started = True  # threadlint: allow[unlocked-attr-write] monotonic latch, armed before thread start
        self._thread.start()

    def stop(self) -> None:
        """Runtime stop (parity: ``horovod_stop_timeline``).

        The writer thread drains every queued record after seeing the
        sentinel and then signals ``_drained``; the file is closed only
        after that signal, so a slow writer can never race a write
        against ``close()`` (the old 10 s ``join`` timeout closed the
        file while the thread could still be mid-``write``). If the
        writer is truly wedged past the timeout the file is left open
        (leaked, reported) rather than yanked from under it.
        """
        if not self._started:
            return
        self._started = False  # new events stop enqueueing first  # threadlint: allow[unlocked-attr-write] monotonic latch; writer drains via sentinel
        self._queue.put(None)
        drained = self._drained.wait(timeout=10)
        self._thread.join(timeout=1)
        if not drained:
            import logging

            logging.getLogger("horovod_tpu_torch.timeline").warning(
                "timeline writer did not drain within 10s; %s left open "
                "(unterminated JSON array — chrome://tracing still loads it)",
                self._path,
            )
            return
        self._file.write("{}]\n")
        self._file.close()

    @property
    def enabled(self) -> bool:
        return self._started

    # -- event API ---------------------------------------------------------
    def _pid(self, tensor: str) -> int:
        with self._lock:
            pid = self._pids.get(tensor)
            if pid is None:
                pid = self._next_pid
                self._next_pid += 1
                self._pids[tensor] = pid
                self._emit(
                    {
                        "ph": "M",
                        "pid": pid,
                        "name": "process_name",
                        "args": {"name": tensor},
                    }
                )
            return pid

    def _emit(self, record: dict) -> None:
        self._queue.put(record)

    def _us(self) -> int:
        return int((time.perf_counter() - self._t0) * 1e6)

    def _mirror(self, ph: str, tensor: str, name: str,
                args: Optional[dict] = None) -> None:
        """Bridge into the unified trace plane (obs.trace): the same
        lifecycle record lands in the flight-recorder ring under
        ``cat="native"`` with a wall-clock stamp, so one merged file
        shows the eager-collective stream next to step/control spans."""
        from ..obs import trace as _trace

        if _trace.enabled():
            a = dict(args or ())
            a["tensor"] = tensor
            _trace.mirror_native(ph, self._pid(tensor), name, args=a)

    def start_activity(self, tensor: str, activity: str) -> None:
        if not self._started:
            return
        self._emit(
            {"ph": "B", "pid": self._pid(tensor), "ts": self._us(),
             "name": activity}
        )
        self._mirror("B", tensor, activity)

    def end_activity(self, tensor: str, activity: str) -> None:
        if not self._started:
            return
        self._emit(
            {"ph": "E", "pid": self._pid(tensor), "ts": self._us(),
             "name": activity}
        )
        self._mirror("E", tensor, activity)

    def instant(self, tensor: str, name: str, args: Optional[dict] = None):
        if not self._started:
            return
        self._emit(
            {"ph": "i", "pid": self._pid(tensor), "ts": self._us(),
             "name": name, "s": "p", "args": args or {}}
        )
        self._mirror("i", tensor, name, args)

    def mark_cycle(self) -> None:
        """Cycle marker (``HOROVOD_TIMELINE_MARK_CYCLES``)."""
        if self._started and self._mark_cycles:
            self.instant("_cycle", "CYCLE")

    class _Activity:
        def __init__(self, tl, tensor, activity):
            self._tl, self._tensor, self._activity = tl, tensor, activity

        def __enter__(self):
            self._tl.start_activity(self._tensor, self._activity)
            return self

        def __exit__(self, *exc):
            self._tl.end_activity(self._tensor, self._activity)
            return False

    def activity(self, tensor: str, activity: str) -> "Timeline._Activity":
        return Timeline._Activity(self, tensor, activity)

    # -- writer thread -----------------------------------------------------
    @staticmethod
    def _write_record(rec: dict, f) -> None:
        rec.setdefault("tid", 0)
        rec.setdefault("cat", "hvdtpu")
        f.write(json.dumps(rec) + ",\n")

    def _writer_loop(self, q, f, drained) -> None:
        while True:
            rec = q.get()
            if rec is None:
                # Drain everything enqueued before (or racing) the stop
                # sentinel, then signal: stop() closes the file only
                # after this, so no write can hit a closed file.
                while True:
                    try:
                        rec = q.get_nowait()
                    except queue.Empty:
                        break
                    if rec is not None:
                        self._write_record(rec, f)
                drained.set()
                return
            self._write_record(rec, f)


_global_timeline: Optional[Timeline] = None


def global_timeline() -> Timeline:
    global _global_timeline
    if _global_timeline is None:
        _global_timeline = Timeline()
        if _env.get_str(_env.TIMELINE):
            _global_timeline.start()
    return _global_timeline


def start_timeline(path: str) -> None:
    """Parity: runtime timeline start (``operations.cc:740``): the host
    timeline of the fusion buckets' lifecycles, written to ``path``."""
    global_timeline().start(path)


def stop_timeline() -> None:
    global_timeline().stop()


_profiler = None
_profiler_path: Optional[str] = None


def start_torch_profiler(path: str) -> None:
    """Bracket device-side profiling with :mod:`torch.profiler` (CPU and,
    where a card is present, CUDA activities); :func:`stop_torch_profiler`
    writes its Chrome trace to ``path``. The JAX package's
    ``start_jax_trace`` does the same with ``jax.profiler``."""
    global _profiler, _profiler_path
    import torch

    if _profiler is not None:
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _profiler, _profiler_path = prof, path


def stop_torch_profiler() -> Optional[str]:
    """Stop the profiler :func:`start_torch_profiler` started and write its
    Chrome trace; returns the path, or None when none was running."""
    global _profiler, _profiler_path
    prof, path = _profiler, _profiler_path
    if prof is None:
        return None
    _profiler = _profiler_path = None
    prof.__exit__(None, None, None)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    prof.export_chrome_trace(path)
    return path


def profiler_path(timeline_path: str) -> str:
    """Where the device half of a timeline at ``timeline_path`` goes."""
    return timeline_path + ".torch.json"
