"""Fail-silent fault defense (the guard plane).

The port of the JAX package's ``guard`` package: the faults that corrupt
the model while every heartbeat stays green.

* **the gradient guard** (:mod:`.gradient`) -- a finite and global-norm
  screen over every step's gradients; NaN/Inf storms and EW z-score norm
  spikes skip the step (parameters, optimizer state and EF residuals
  stay as they were, the fused AdamW kernel through its skip flag), and
  ``HVDTPU_GUARD_MAX_SKIPS`` consecutive skips escalate to a recoverable
  ``HorovodInternalError``;
* **the consistency audit** (:mod:`.audit`) -- periodic crc32 checksums
  of the replicated state, all-gathered and majority-voted to localize a
  silently diverged rank, healed by broadcast-resync or by walk-back;
* **fail-silent chaos** (:mod:`.inject`) -- the ``grad.nan``,
  ``grad.bitflip`` and ``param.corrupt`` sites.

Arm it with ``make_train_step(guard=True)`` (or ``HVDTPU_GUARD=1``).
"""

from .audit import (  # noqa: F401
    AuditReport,
    ConsistencyAuditor,
    fingerprint,
    majority_vote,
)
from .gradient import (  # noqa: F401
    GuardConfig,
    GuardState,
    check_gradients,
    fresh_state,
    resolve,
)
from .runtime import GuardRuntime  # noqa: F401

__all__ = [
    "AuditReport",
    "ConsistencyAuditor",
    "GuardConfig",
    "GuardRuntime",
    "GuardState",
    "check_gradients",
    "fingerprint",
    "fresh_state",
    "majority_vote",
    "resolve",
]
