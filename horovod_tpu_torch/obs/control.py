"""Control-plane instruments: one home for the journal / adoption /
preemption metric names.

The journal, the rendezvous KV client, and the elastic driver all
record through these helpers so the names the exporters serialize (and
``horovod_tpu_torch/tools/hvdtpu_top.py``'s elastic panel parses) cannot drift per call
site. Naming:

===================================  ===================================
``journal.bytes``             gauge  current journal file size
``journal.records``           gauge  records appended since the last
                                     compaction (replay lag)
``journal.compactions``       count  snapshot+truncate passes
``journal.replayed_records``  count  records replayed at recovery
``journal.torn_tails``        count  recoveries that hit a damaged tail
``recovery.kv_reconnects``    count  KV client observed a new server
                                     identity epoch (restart survived)
``recovery.driver_adoptions`` count  a respawned driver adopted a live
                                     job from the journal
``elastic.driver_epoch``      gauge  driver incarnation (0 = original,
                                     +1 per adoption)
``recovery.preempt_notices``  count  preemption flags consumed by the
                                     driver
``recovery.preempt_drains``   count  preempted workers that left
                                     cleanly (shrink, not blacklist)
``recovery.preempt_ckpts``    count  priority checkpoints taken during
                                     a preemption drain
``elastic.preempt_drain.<h>`` gauge  1 while host ``<h>`` is draining
                                     (removed once it departs)
===================================  ===================================
"""

from __future__ import annotations

from . import registry as _obs


def journal_appended(size_bytes: int, records_since_compact: int) -> None:
    reg = _obs.metrics()
    reg.gauge("journal.bytes").set(float(size_bytes))
    reg.gauge("journal.records").set(float(records_since_compact))


def journal_compacted() -> None:
    _obs.metrics().counter("journal.compactions").inc()


def journal_recovered(replayed: int, torn: int) -> None:
    reg = _obs.metrics()
    if replayed:
        reg.counter("journal.replayed_records").inc(replayed)
    if torn:
        reg.counter("journal.torn_tails").inc()


def kv_reconnected() -> None:
    _obs.metrics().counter("recovery.kv_reconnects").inc()


def driver_adopted(epoch: int, hosts: int) -> None:
    reg = _obs.metrics()
    reg.counter("recovery.driver_adoptions").inc()
    reg.gauge("elastic.driver_epoch").set(float(epoch))
    reg.event("elastic.adopted", epoch=epoch, hosts=hosts)


def set_driver_epoch(epoch: int) -> None:
    _obs.metrics().gauge("elastic.driver_epoch").set(float(epoch))


def preempt_noticed(host: str) -> None:
    reg = _obs.metrics()
    reg.counter("recovery.preempt_notices").inc()
    reg.gauge(f"elastic.preempt_drain.{host}").set(1.0)
    reg.event("elastic.preempt", host=host)


def preempt_drained(host: str) -> None:
    reg = _obs.metrics()
    reg.counter("recovery.preempt_drains").inc()
    reg.remove_gauge(f"elastic.preempt_drain.{host}")
    reg.event("elastic.preempt_drained", host=host)


def preempt_cleared(host: str) -> None:
    """Drop the draining gauge WITHOUT counting a drain — for a
    preempted host that died before finishing its grace (platform
    SIGKILL beat the drain) or whose mark simply expired."""
    _obs.metrics().remove_gauge(f"elastic.preempt_drain.{host}")


def preempt_checkpointed() -> None:
    _obs.metrics().counter("recovery.preempt_ckpts").inc()
