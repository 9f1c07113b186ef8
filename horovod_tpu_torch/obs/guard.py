"""Guard-plane metric names (the fail-silent defense's telemetry).

One home for every ``guard.*`` name, like :mod:`horovod_tpu_torch.obs.serve`
for the serving plane — the runtime wrapper records through these
helpers, ``hvdtpu_top``'s guard panel reads the same names back.

Counters: ``guard.steps_skipped`` (guard-screened steps),
``guard.escalations`` (consecutive-skip storms surfaced as recoverable
errors), ``guard.audits`` / ``guard.divergences`` / ``guard.resyncs`` /
``guard.walkbacks`` (consistency-audit rounds and outcomes), and —
driver-side — ``guard.divergence_reports`` plus
``recovery.host_penalties``.  Gauges: ``guard.enabled``,
``guard.grad_norm`` (last global gradient norm; −1 when non-finite),
``guard.consecutive_skips``.
"""

from __future__ import annotations

from . import goodput as _goodput
from . import registry as _obs
from . import trace as _trace


def record_step(consecutive: int, last_norm: float, new_skips: int) -> None:
    """Per-step bookkeeping from the previous step's committed guard
    state (read host-side by the runtime wrapper)."""
    if new_skips > 0:
        # Verdict on the timeline: a skipped step is an instant next to
        # the step span it voided, so a merged trace shows the storm's
        # shape (which ranks, which steps) without log archaeology.
        _trace.instant(
            "guard.skip", cat="guard",
            args={"consecutive": consecutive, "grad_norm": last_norm},
        )
        # The voided step's wall time was not useful work: the ledger
        # reclassifies its bracket (the verdict reads one step delayed,
        # so "the previous step" is exactly what the ledger remembers).
        _goodput.record_guard_skip()
    if not _obs.enabled():
        return
    reg = _obs.metrics()
    reg.gauge("guard.enabled").set(1.0)
    reg.gauge("guard.consecutive_skips").set(consecutive)
    reg.gauge("guard.grad_norm").set(last_norm)
    if new_skips > 0:
        reg.counter("guard.steps_skipped").inc(new_skips)


def record_escalation(consecutive: int) -> None:
    reg = _obs.metrics()
    reg.counter("guard.escalations").inc()
    reg.event("guard.escalation", consecutive=consecutive)
    _trace.instant(
        "guard.escalation", cat="guard", args={"consecutive": consecutive}
    )
    # A skip storm hands control to the elastic restore path — dump the
    # flight recorder first, while the evidence (the storm's skip
    # instants, the last open spans) is still in the ring.
    _trace.flight_dump("guard_escalation")
