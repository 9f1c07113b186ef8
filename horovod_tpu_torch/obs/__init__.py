"""The port's telemetry planes: metrics, spans, goodput, FLOPs.

The port of the JAX package's ``obs`` package, under the same metric names,
knobs and file formats:

* :class:`~.registry.MetricsRegistry` -- thread-safe counters, gauges and
  ring-buffer histograms (p50/p95/p99), behind ``HVDTPU_METRICS``; off, a
  site costs one cached boolean and the shared null registry.
* :mod:`.export` -- per-rank JSON lines and the Prometheus textfile under
  ``HVDTPU_METRICS_DIR``, and the lockstep rank-0 summary (one
  ``torch.distributed.all_reduce``).
* :mod:`.trace` -- the span ring and crash/hang flight recorder
  (``HVDTPU_TRACE``), merged clock-aligned by
  ``python -m horovod_tpu_torch.tools.hvdtpu_trace``.
* :mod:`.goodput` -- the wall-clock ledger (``HVDTPU_GOODPUT``): every
  second in exactly one category.
* :mod:`.control`, :mod:`.guard`, :mod:`.serve` -- the single owners of
  the control-plane, guard and serving names.
* :mod:`.flops` and :mod:`.overlap` -- the FLOP/peak model behind
  ``step.mfu`` and the overlap accounting behind the ``overlap.*`` gauges.

Instrumented layers: ``parallel/dp.py`` (the step bracket), ``ops/fusion.py``,
``optimizer.py``, ``data.py``, ``checkpoint.py``, ``serve/``, ``guard/``,
``chaos/``, ``elastic/`` and ``runner/``. Since A16a the eager path brings
the dynamic-enqueue runtime's counters (``native.*``, merged by
:mod:`.native_bridge` into every export), the eager collectives' latencies
and counts (``eager.<KIND>.ms``, ``eager.ops``, ``eager.bytes``) and the
stall inspector's gauges (``stall.pending``, ``stall.max_age_s``,
``stall.age_s.<name>``). The runtime's ParameterManager exports no metric,
as the JAX package's native one exports none: read it with
``native.autotune_best()`` and its ``HVDTPU_AUTOTUNE_LOG`` rows.
"""

from __future__ import annotations

from .registry import (  # noqa: F401
    MetricsRegistry,
    enabled,
    enable,
    disable,
    metrics,
    null_registry,
)
from .export import (  # noqa: F401
    MetricsReporter,
    flush,
    reporter,
    snapshot,
)
from . import flops  # noqa: F401
from . import goodput  # noqa: F401
from . import overlap  # noqa: F401
from . import trace  # noqa: F401

__all__ = [
    "MetricsRegistry",
    "MetricsReporter",
    "enabled",
    "enable",
    "disable",
    "metrics",
    "null_registry",
    "reporter",
    "flush",
    "snapshot",
    "flops",
    "goodput",
    "overlap",
    "trace",
]
