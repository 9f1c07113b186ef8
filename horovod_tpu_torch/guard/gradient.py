"""The gradient guard: screen every step's gradients before the update
commits.

The port of the JAX package's ``guard/gradient.py``. A NaN/Inf storm from
an overflowing microbatch, or a norm spike from a flipped exponent bit,
corrupts the model while every heartbeat stays green. The guard screens
the gradients (:func:`~..ops.guards.finite_and_sumsq`), makes the verdict
**replica-uniform** with one all-reduce of the bad count and the sum of
squares (a skip decision that differed across ranks would itself diverge
the model), and on an anomaly the step is skipped: parameters, optimizer
state and EF residuals stay as they were
(:func:`~..optimizer.guarded_commit`, and the skip flag of the fused
AdamW kernel) and ``state.step`` does not advance, so a deterministic
input pipeline retries the step.

Spike detection keeps an exponentially weighted mean and variance of the
global gradient norm in :class:`GuardState` (0-d tensors on the device
riding the ``TrainState``); a norm more than ``spike_sigma`` EW standard
deviations above the mean, after ``warmup`` committed steps, is an
anomaly. Skipped steps do not feed the baseline. Every decision stays on
the device: ``ok`` is a 0-d bool tensor and nothing here reads it on the
host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.collectives import Sum, allreduce
from ..ops.guards import finite_and_sumsq
from ..utils import env as _env

__all__ = [
    "GuardConfig",
    "GuardState",
    "check_gradients",
    "fresh_state",
    "resolve",
]


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Knobs of the gradient guard (env twins in parentheses, read by
    :meth:`from_env`): ``spike_sigma`` (``HVDTPU_GUARD_SPIKE_SIGMA``), the
    norm z-score above the EW baseline that skips a step; ``max_skips``
    (``HVDTPU_GUARD_MAX_SKIPS``), consecutive skips before the step
    wrapper raises a recoverable ``HorovodInternalError``; ``warmup``
    (``HVDTPU_GUARD_WARMUP``), committed steps before spike detection arms
    (NaN/Inf screening is always on); ``ema_decay``
    (``HVDTPU_GUARD_EMA_DECAY``); ``audit_every``
    (``HVDTPU_GUARD_AUDIT_EVERY``), the consistency audit's cadence in
    committed steps (0 = off; it runs only in a world of more than one
    process, see :mod:`.audit`)."""

    spike_sigma: float = 6.0
    max_skips: int = 8
    warmup: int = 20
    ema_decay: float = 0.99
    audit_every: int = 100

    def __post_init__(self):
        if self.spike_sigma <= 0:
            raise ValueError(f"spike_sigma must be > 0, got {self.spike_sigma}")
        if self.max_skips < 1:
            raise ValueError(f"max_skips must be >= 1, got {self.max_skips}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in (0, 1), got {self.ema_decay}"
            )
        if self.warmup < 0 or self.audit_every < 0:
            raise ValueError("warmup and audit_every must be >= 0")

    @classmethod
    def from_env(cls) -> "GuardConfig":
        return cls(
            spike_sigma=_env.guard_spike_sigma(),
            max_skips=_env.guard_max_skips(),
            warmup=_env.guard_warmup(),
            ema_decay=_env.guard_ema_decay(),
            audit_every=_env.guard_audit_every(),
        )


class GuardState(NamedTuple):
    """The guard's bookkeeping riding ``TrainState.guard``: 0-d fp32/int32
    tensors on the parameters' device, so it checkpoints like any other
    state. ``mean``/``var`` are the EW norm baseline, ``seen`` counts
    committed (baseline-feeding) steps, ``skipped`` and ``consecutive``
    count skips, ``last_norm`` is the latest global gradient norm (-1
    when it was not finite, so a host read never meets a NaN)."""

    mean: torch.Tensor
    var: torch.Tensor
    seen: torch.Tensor
    skipped: torch.Tensor
    consecutive: torch.Tensor
    last_norm: torch.Tensor


def fresh_state(device=None) -> GuardState:
    """A zeroed :class:`GuardState` on ``device``, every field a distinct
    tensor (the step replaces fields independently)."""
    f32, i32 = torch.float32, torch.int32
    return GuardState(
        mean=torch.zeros((), dtype=f32, device=device),
        var=torch.zeros((), dtype=f32, device=device),
        seen=torch.zeros((), dtype=i32, device=device),
        skipped=torch.zeros((), dtype=i32, device=device),
        consecutive=torch.zeros((), dtype=i32, device=device),
        last_norm=torch.zeros((), dtype=f32, device=device),
    )


def check_gradients(
    grads,
    gstate: GuardState,
    cfg: GuardConfig,
    axis=None,
) -> Tuple[torch.Tensor, torch.Tensor, GuardState]:
    """Screen one step's gradients; returns ``(ok, norm, new_state)``.

    ``ok`` is a replica-uniform 0-d bool tensor: this rank's screen and
    its sum of squares are summed across ``axis`` (one all-reduce of two
    fp32 scalars, the reference's two psums in one), so every rank
    reaches the same verdict. ``norm`` is the global gradient norm (NaN or
    Inf on a poisoned step; ``new_state.last_norm`` is host-safe). The EW
    baseline takes committed steps only."""
    finite, sumsq = finite_and_sumsq(grads)
    device = gstate.mean.device
    local = torch.stack([(~finite).to(torch.float32), sumsq.to(device)])
    bad, total = allreduce(local, op=Sum, axis=axis).unbind()
    norm = torch.sqrt(total)
    finite_g = (bad == 0) & torch.isfinite(norm)
    # Spike detection needs at least one committed sample in the baseline:
    # with warmup=0 an unseeded (mean = var = 0) baseline would flag every
    # nonzero norm, and skipped steps never feed it -- a skip livelock.
    warmed = gstate.seen >= max(cfg.warmup, 1)
    # A std floor at 10% of the mean: the EW variance starts at zero, and a
    # real spike (a flipped exponent bit is a 2^k jump) clears 1 + sigma/10
    # times the baseline by orders of magnitude.
    std = torch.maximum(torch.sqrt(gstate.var), 0.1 * gstate.mean)
    spike = warmed & (norm > gstate.mean + cfg.spike_sigma * std)
    ok = finite_g & ~spike

    # EW mean and variance: committed steps only, the first one seeds. The
    # decay and its complement are rounded as the reference's fp32 ones.
    d = float(np.float32(cfg.ema_decay))
    one_minus_d = float(np.float32(1.0) - np.float32(cfg.ema_decay))
    delta = norm - gstate.mean
    first = gstate.seen == 0
    mean_ok = torch.where(first, norm, gstate.mean + one_minus_d * delta)
    var_ok = torch.where(first, torch.zeros_like(gstate.var),
                         d * (gstate.var + one_minus_d * delta * delta))
    oki = ok.to(torch.int32)
    new_state = GuardState(
        mean=torch.where(ok, mean_ok, gstate.mean),
        var=torch.where(ok, var_ok, gstate.var),
        seen=gstate.seen + oki,
        skipped=gstate.skipped + (1 - oki),
        consecutive=torch.where(ok, torch.zeros_like(gstate.consecutive),
                                gstate.consecutive + 1),
        last_norm=torch.where(torch.isfinite(norm), norm,
                              torch.full_like(norm, -1.0)),
    )
    return ok, norm, new_state


def resolve(guard) -> Optional[GuardConfig]:
    """``make_train_step``'s ``guard=``: None reads ``HVDTPU_GUARD``, True
    builds a config from the env, False disables, a :class:`GuardConfig`
    passes through."""
    if guard is None:
        guard = _env.guard_default()
    if guard is False:
        return None
    if guard is True:
        return GuardConfig.from_env()
    if isinstance(guard, GuardConfig):
        return guard
    raise ValueError(
        f"guard must be None/True/False or a GuardConfig, got {guard!r}"
    )
