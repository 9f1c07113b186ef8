"""Host side of the gradient guard: the wrapper around a guarded step.

The port of the JAX package's ``guard/runtime.py``. The guard's decision
and the skip live in the step (:mod:`.gradient`,
:func:`~..optimizer.guarded_commit`); this wrapper owns what happens on
the host:

* **seeding** -- a ``TrainState`` whose ``guard`` is None gets a fresh
  :class:`~.gradient.GuardState` before its first step;
* **escalation** -- ``max_skips`` *consecutive* skips raise a recoverable
  :class:`~..exceptions.HorovodInternalError`, handing the storm to the
  elastic restore path. The streak is read from the previous step's
  committed counters (``int(state.guard.skipped)``): that read waits for
  the previous step to finish on the device, never for the one about to
  be launched. The streak resets when an escalation fires, so a restored
  snapshot cannot escalate again at once;
* **fail-silent chaos** -- the ``grad.nan`` site before the step, and
  ``grad.bitflip`` / ``param.corrupt`` after it (:mod:`.inject`), armed
  only with a chaos schedule;
* **consistency audit** -- every ``audit_every`` committed steps, in a
  world of more than one process, the cross-replica audit
  (:mod:`.audit`) over the step's output state, healed in place by
  resync or escalated to walk-back.

The reference's ``guard.*`` gauges wait for the metrics registry (A14);
until then the runtime keeps ``consecutive``, ``last_norm``, ``skips``
and ``escalations`` as attributes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Optional

import torch

from .. import chaos as _chaos
from ..exceptions import HorovodInternalError
from . import inject as _inject
from .audit import ConsistencyAuditor
from .gradient import GuardConfig, fresh_state

__all__ = ["GuardRuntime"]

log = logging.getLogger("horovod_tpu_torch.guard")


def _world() -> int:
    from .. import context as _ctx

    return _ctx.size() if _ctx.is_initialized() else 1


def _rank() -> Optional[int]:
    from .. import context as _ctx

    return _ctx.rank() if _ctx.is_initialized() else None


def _write_back(live, corrupted) -> None:
    """Copy the perturbed leaves of ``corrupted`` into the live parameter
    tensors (a silent local fault hits the memory the step trains)."""
    with torch.no_grad():
        for name, new in corrupted.items():
            if new is not live[name]:
                live[name].copy_(new)


class GuardRuntime:
    """Per-built-step guard bookkeeping (one instance per
    ``make_train_step(guard=...)`` call)."""

    def __init__(self, cfg: GuardConfig, *, sharded: bool = False):
        self.cfg = cfg
        self.sharded = sharded
        self._prev_skipped: Optional[int] = None
        self._last_audit: Optional[int] = None
        self._auditor: Optional[ConsistencyAuditor] = None
        self.consecutive = 0
        self.last_norm: Optional[float] = None
        self.skips = 0
        self.escalations = 0
        self.last_report = None  # the latest AuditReport

    # -- pieces -----------------------------------------------------------

    def _escalate_and_record(self, state) -> None:
        """Read the previous step's committed guard scalars and raise when
        the consecutive-skip budget is spent."""
        g = state.guard
        skipped = int(g.skipped)
        if self._prev_skipped is None or skipped < self._prev_skipped:
            # First call, or an elastic restore rewound the counters: a
            # fresh streak; never blame a restored snapshot for its
            # predecessor's storm.
            self.consecutive = 0
        elif skipped > self._prev_skipped:
            self.consecutive += skipped - self._prev_skipped
            self.skips += skipped - self._prev_skipped
        else:
            self.consecutive = 0  # the previous step committed
        self._prev_skipped = skipped
        self.last_norm = float(g.last_norm)
        if self.consecutive >= self.cfg.max_skips:
            streak = self.consecutive
            self.consecutive = 0
            self._prev_skipped = None
            self.escalations += 1
            raise HorovodInternalError(
                f"gradient guard skipped {streak} consecutive steps "
                f"(HVDTPU_GUARD_MAX_SKIPS={self.cfg.max_skips}); "
                "escalating so the elastic path can restore known-good "
                "state"
            )

    @property
    def last_verified_step(self):
        """Step of the last clean (or resync-healed) audit, None before
        any audit verified state."""
        if self._auditor is None:
            return None
        return self._auditor.last_verified_step

    @property
    def audit_armed(self) -> bool:
        """Whether this runtime will ever run cross-replica audits."""
        return self.cfg.audit_every > 0 and _world() > 1

    def _maybe_audit(self, state):
        """The audit, keyed to the committed step count so every rank
        reaches the collective at the same point (a host read of the step
        just launched, in a multi-process world only)."""
        every = self.cfg.audit_every
        if every <= 0 or _world() <= 1:
            return
        step_val = int(state.step)
        if step_val <= 0 or step_val % every or step_val == self._last_audit:
            return
        self._last_audit = step_val
        if self._auditor is None:
            self._auditor = ConsistencyAuditor(
                host_id=os.environ.get("HVDTPU_HOST_ID", ""),
            )
        from ..optimizer import has_sharded_state

        audit_tree = (state.params, state.opt_state, state.step, state.extra)
        try:
            _, report = self._auditor.audit(
                audit_tree, step_val,
                has_sharded=self.sharded
                or has_sharded_state(state.opt_state),
            )
        finally:
            self.last_report = self._auditor.last_report
        if report.diverged:
            log.warning(
                "consistency audit at step %d: divergence healed by %s "
                "(minority ranks %s)",
                step_val, report.healed, report.minority_ranks,
            )

    # -- the wrapper ------------------------------------------------------

    def wrap(self, fn: Callable) -> Callable:
        def guarded(state, batch):
            if getattr(state, "guard", None) is None:
                device = state.step.device
                state = dataclasses.replace(state, guard=fresh_state(device))
            else:
                self._escalate_and_record(state)
            chaos_on = _chaos.enabled()
            if chaos_on:
                # grad.nan poisons the ATTEMPTED step's batch.
                batch = _inject.maybe_poison_batch(
                    batch, int(state.step) + 1, _rank()
                )
            out = fn(state, batch)
            new_state = out[0]
            if chaos_on:
                # grad.bitflip / param.corrupt land after the commit: the
                # silent local corruption only the audit can see.
                corrupted = _inject.maybe_corrupt_params(
                    new_state.params, int(new_state.step), _rank()
                )
                if corrupted is not new_state.params:
                    _write_back(new_state.params, corrupted)
            self._maybe_audit(new_state)
            return out

        guarded.guard_runtime = self
        return guarded
