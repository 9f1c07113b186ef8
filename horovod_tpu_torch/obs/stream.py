"""Weight-streaming instruments: one home for every ``stream.*`` name
(the JAX package's names).

The publisher (:mod:`horovod_tpu_torch.stream.publisher`) and subscriber
(:mod:`horovod_tpu_torch.stream.subscriber`) record exclusively through these
helpers so the names the exporters serialize (and ``tools/hvdtpu_top.py``'s
stream panel parses) cannot drift per call site. Naming:

===============================  =======================================
``stream.published_versions``  count  complete versions published (all
                                      buckets + manifest on the KV)
``stream.publish_blocked``     count  publishes held back by the guard
                                      gate (audit has not yet verified
                                      the delta's step)
``stream.publish_dropped``     count  pending deltas dropped past the
                                      ``HVDTPU_STREAM_MAX_PENDING`` cap
``stream.applied_versions``    count  CRC-verified versions atomically
                                      flipped into serving
``stream.torn_rejected``       count  incomplete / CRC-mismatched sets
                                      rejected wholesale (never applied)
``stream.epoch_rejected``      count  versions rejected for a stale
                                      publisher epoch (dead trainer)
``stream.fallbacks``           count  staleness-watchdog falls back to
                                      the :class:`CheckpointWatcher` path
``stream.rollbacks``           count  guard-strike walk-backs to the
                                      checkpoint manifest
``stream.staleness_s``         gauge  seconds since the last applied
                                      version (or subscriber start)
``stream.version``             gauge  version currently being served
``stream.apply_ms``            histo  stage + verify + flip latency
``stream.kv_retained_keys``    gauge  bucket blobs live on the KV after
                                      the publisher's GC pass (growth
                                      here = superseded blobs piling up
                                      on a delete-less KV)
===============================  =======================================
"""

from __future__ import annotations

from . import registry as _obs


def record_published(version: int) -> None:
    _obs.metrics().counter("stream.published_versions").inc()


def record_publish_blocked() -> None:
    _obs.metrics().counter("stream.publish_blocked").inc()


def record_publish_dropped(n: int = 1) -> None:
    _obs.metrics().counter("stream.publish_dropped").inc(n)


def record_applied(version: int, ms: float) -> None:
    reg = _obs.metrics()
    reg.counter("stream.applied_versions").inc()
    reg.gauge("stream.version").set(version)
    reg.histogram("stream.apply_ms").observe(ms)


def record_torn_rejected() -> None:
    _obs.metrics().counter("stream.torn_rejected").inc()


def record_epoch_rejected() -> None:
    _obs.metrics().counter("stream.epoch_rejected").inc()


def record_fallback() -> None:
    _obs.metrics().counter("stream.fallbacks").inc()


def record_rollback() -> None:
    _obs.metrics().counter("stream.rollbacks").inc()


def set_staleness(secs: float) -> None:
    _obs.metrics().gauge("stream.staleness_s").set(secs)


def set_kv_retained(n: int) -> None:
    _obs.metrics().gauge("stream.kv_retained_keys").set(n)
