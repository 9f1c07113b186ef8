"""Metrics exporters: per-rank JSON-lines, Prometheus textfile, rank-0 log.

The port of the JAX package's ``obs/export.py``: the files, their schema
and the Prometheus names are the same. Since A16a the dynamic-enqueue
runtime's counters (``native.*``, :mod:`.native_bridge`) are merged into
every snapshot as the JAX package merges its native library's; its
ParameterManager exports nothing, as the JAX package's does not. The
rank-0 summary is one ``torch.distributed.all_reduce``.

Layout under ``HVDTPU_METRICS_DIR`` (default ``./hvdtpu_metrics``):

* ``rank<k>.jsonl`` — one JSON object per flush, append-only. Schema::

      {"ts": <unix seconds>, "rank": k, "world": n,
       "counters": {name: int, ...},
       "gauges": {name: float, ...},
       "histograms": {name: {"count","mean","p50","p95","p99","max"}},
                                              # fields null when count==0
       "events": [{"ts","kind",...}, ...]}    # drained since last flush

  ``python -m horovod_tpu_torch.tools.hvdtpu_top`` tails these; rates are derived from counter
  deltas between consecutive lines.
* ``rank<k>.prom`` — Prometheus textfile-collector format, atomically
  replaced each flush (write temp + fsync + rename — a scraper sees
  the old complete file or the new one, never a torn prefix, even
  across a crash before writeback). Metric names are the
  registry names with ``.``/``/`` mapped to ``_`` and a ``hvdtpu_``
  prefix; histograms export ``_count``/``_mean``/``_p50``/``_p95``/
  ``_p99``/``_max`` series.

Flushing is driven by the instrumented train step (``parallel/dp.py``
ticks the reporter), by ``atexit`` (a 10-step bench run that never
crosses the interval still lands its final snapshot), or manually via
:func:`flush`.

The periodic rank-0 summary aggregates [steps, tokens, collective bytes]
across processes with ONE ``torch.distributed.all_reduce`` on the world's
group (a tensor on the card under NCCL, on the CPU under gloo) and logs a
single line -- the live cluster view without any rank scraping files from
its peers. Because that exchange is collective, it fires on *step-count*
boundaries (``HVDTPU_METRICS_SUMMARY_STEPS``) of the step wrapper's own
counter, in lockstep on every rank, never on wall-clock timers whose skew
across hosts would deadlock the world.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
import weakref
from typing import Optional

from . import registry as _registry
from ..utils import env as _env

log = logging.getLogger("horovod_tpu_torch.obs")

DEFAULT_INTERVAL_SECS = 5.0


def _rank_world():
    """(rank, world): a live ``torch.distributed`` world wins, else the
    launcher's injected env, else (0, 1)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:
        pass
    return _env.launcher_rank_world()


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    return "hvdtpu_" + "".join(out)


def snapshot() -> dict:
    """Registry + runtime counters as one export-shaped dict."""
    from .native_bridge import read_native

    rank, world = _rank_world()
    snap = _registry.metrics().snapshot()
    counters = dict(snap["counters"])
    gauges = dict(snap["gauges"])
    for k, v in read_native().items():
        (gauges if isinstance(v, float) else counters)[k] = v
    return {
        "ts": time.time(),
        "rank": rank,
        "world": world,
        "counters": counters,
        "gauges": gauges,
        "histograms": snap["histograms"],
    }


class MetricsReporter:
    """Owns the export files for this process; one per process suffices
    (the module-level :func:`reporter` singleton)."""

    def __init__(
        self,
        directory: Optional[str] = None,
        interval: Optional[float] = None,
        role: Optional[str] = None,
    ):
        # ``role`` replaces the rank-derived file stem (e.g. "driver"
        # for the elastic launcher, which shares neither a rank nor a
        # train loop with the workers and must not interleave with
        # rank0.jsonl).
        self.role = role
        self.directory = directory or _env.get_str(
            _env.METRICS_DIR, os.path.join(os.getcwd(), "hvdtpu_metrics")
        )
        self.interval = (
            interval
            if interval is not None
            else _env.get_float(_env.METRICS_INTERVAL, DEFAULT_INTERVAL_SECS)
        )
        self.summary_every = _env.get_int(_env.METRICS_SUMMARY_STEPS, 100)
        self._last_flush = 0.0  # epoch: first tick always flushes
        self._last_summary: Optional[dict] = None
        self._lock = threading.Lock()
        self._export_error_logged = False
        # The step counts at which this reporter joined the rank-0
        # summary (every rank's list is the same: the lockstep contract).
        self.summary_steps: list = []
        _live_reporters.add(self)

    # -- paths -----------------------------------------------------------
    def _stem(self, rank: Optional[int]) -> str:
        if self.role:
            return self.role
        return f"rank{_rank_world()[0] if rank is None else rank}"

    def jsonl_path(self, rank: Optional[int] = None) -> str:
        return os.path.join(self.directory, self._stem(rank) + ".jsonl")

    def prom_path(self, rank: Optional[int] = None) -> str:
        return os.path.join(self.directory, self._stem(rank) + ".prom")

    # -- flushing --------------------------------------------------------
    def tick(self, step: Optional[int] = None) -> None:
        """Flush iff the wall interval elapsed (local files only); emit
        the cross-process summary on ``summary_every`` step boundaries
        (deterministic, so every SPMD rank joins the one allreduce).
        Called from the instrumented step wrapper; cheap when it's not
        time yet (one clock read + one modulo)."""
        if not _registry.enabled():
            return
        if step is not None and self.summary_every > 0 and step > 0 and (
            step % self.summary_every == 0
        ):
            self.summary_steps.append(step)
            self.flush(summarize=True)
            return
        if time.monotonic() - self._last_flush >= self.interval:
            self.flush(summarize=None)

    def flush(self, summarize: Optional[bool] = None) -> Optional[dict]:
        """Write one JSONL record + rewrite the Prometheus textfile.

        ``summarize``: True forces the rank-0 summary (collective in a
        multi-process world — caller must guarantee every rank calls in
        lockstep), False suppresses it, None (default) logs it only when
        the world is a single process (no collective involved)."""
        if not _registry.enabled():
            return None
        with self._lock:
            record = snapshot()
            record["events"] = _registry.metrics().drain_events()
            try:
                os.makedirs(self.directory, exist_ok=True)
                with open(self.jsonl_path(record["rank"]), "a") as f:
                    f.write(json.dumps(record) + "\n")
                self._write_prom(record)
            except OSError as e:
                # Telemetry is best-effort: a full/unwritable metrics
                # filesystem must never take down the train loop or the
                # elastic driver's failure handling. Warn once per
                # reporter, then stay quiet.
                if not self._export_error_logged:
                    self._export_error_logged = True
                    log.warning(
                        "metrics export to %s failed (suppressing further "
                        "warnings): %s", self.directory, e,
                    )
            self._last_flush = time.monotonic()
            self._last_summary = record
        if summarize or (summarize is None and record["world"] == 1):
            self._log_summary(record)
        return record


    def _write_prom(self, record: dict) -> None:
        lines = []
        for name, v in sorted(record["counters"].items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} counter")
            lines.append(f'{pn}{{rank="{record["rank"]}"}} {v}')
        for name, v in sorted(record["gauges"].items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f'{pn}{{rank="{record["rank"]}"}} {v}')
        for name, s in sorted(record["histograms"].items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} summary")
            for field in ("count", "mean", "p50", "p95", "p99", "max"):
                val = s.get(field)
                if val is None:  # empty histogram: JSON carries null,
                    val = "NaN"  # the prom text format spells it NaN
                lines.append(
                    f'{pn}_{field}{{rank="{record["rank"]}"}} {val}'
                )
        path = self.prom_path(record["rank"])
        tmp = path + ".tmp"
        # Atomic publish: write the temp fully, fsync it, THEN rename.
        # os.replace alone keeps a same-filesystem reader from seeing a
        # torn file, but without the fsync a crash between rename and
        # writeback can leave the *renamed* path holding zero-length or
        # partial data on some filesystems — a scraper must only ever
        # see the old complete file or the new complete file.
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- rank-0 cluster summary -----------------------------------------
    _SUMMARY_KEYS = (
        ("counters", "step.count"),
        ("counters", "step.tokens"),
        ("counters", "eager.bytes"),
        ("gauges", "fusion.allreduce.bytes_per_step"),
    )

    def _log_summary(self, record: dict) -> None:
        """One all-reduce across processes of the headline counters,
        logged by rank 0. World 1 logs locally; a failed exchange degrades
        to the local line rather than failing the flush."""
        vals = [float(record[sec].get(key, 0.0))
                for sec, key in self._SUMMARY_KEYS]
        rank, world = record["rank"], record["world"]
        if world > 1:
            try:
                vals = summary_allreduce(vals)
            except Exception as e:
                log.debug("metrics summary all-reduce skipped: %s", e)
        if rank != 0:
            return
        steps, tokens, eager_bytes, step_bytes = vals
        log.info(
            "metrics[world=%d]: steps=%d tokens=%d eager_bytes=%d "
            "collective_bytes/step=%d",
            world, int(steps), int(tokens), int(eager_bytes), int(step_bytes),
        )


def summary_allreduce(values):
    """Sum ``values`` (floats) over the ``torch.distributed`` world: one
    ``all_reduce`` on the default group, its fp64 tensor on this rank's
    card under NCCL (which takes no CPU tensor) and on the CPU otherwise."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cpu")
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return t.cpu().tolist()


_reporter: Optional[MetricsReporter] = None
_reporter_lock = threading.Lock()
# Every reporter still alive, for the atexit sweep: role reporters (the
# elastic driver's "driver" stem) must flush to THEIR files at exit, not
# be shadowed by a default rank-stemmed one. Weak so short-lived test
# reporters don't resurrect deleted tmp dirs at interpreter teardown.
_live_reporters: "weakref.WeakSet[MetricsReporter]" = weakref.WeakSet()


def reporter() -> MetricsReporter:
    global _reporter
    if _reporter is None:
        with _reporter_lock:
            if _reporter is None:
                _reporter = MetricsReporter()
    return _reporter


def flush() -> Optional[dict]:
    """Flush the process reporter now (no-op when metrics are off)."""
    return reporter().flush()


def _atexit_flush() -> None:
    # Registered at import — i.e. on any first touch of the obs plane —
    # not on first flush(): a job that never ticks a reporter (a serving
    # process) would otherwise lose its telemetry at exit. Flush the reporters that
    # actually exist (a process that only made a role reporter — the
    # elastic driver — must not grow a default rank-stemmed one here and
    # clobber a worker's rank0.prom in a shared metrics dir); fall back
    # to creating the default reporter only when there is none at all.
    # No cross-process summary: peers may already be gone and a blocking
    # collective would hang interpreter teardown.
    if not _registry.enabled():
        return
    reps = list(_live_reporters) or [reporter()]
    for rep in reps:
        try:
            rep.flush(summarize=False)
        except Exception:
            pass


atexit.register(_atexit_flush)
