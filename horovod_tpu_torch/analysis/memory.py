"""Static per-device memory planner over a fake-tensor record.

The port of ``horovod_tpu/analysis/memory.py``: the same
:class:`MemoryLintConfig`, :class:`MemoryPlan` (the same breakdown keys),
:func:`plan_traced`, :func:`project_sharding` and
:func:`compare_to_measured`, so the two packages' plans read alike.

Model
=====

The reference linearizes a jaxpr and assigns each value a lifetime from
its producer to its last reader. The port's step is eager, so the record
(:mod:`.record`) already holds the lifetimes the caching allocator sees:
each fake storage is born at the op that makes it and dies when its last
reference dies (a weakref finalizer, in op order). Autograd's saved
tensors, the recompute of a checkpointed region and in-place updates
(which allocate nothing) come out as they happen on the card. The plan
sweeps those intervals for the peak sum of live bytes, per device: the
record runs one rank of the world, whose batch is its shard and whose
ZeRO-1 state is its 1/N shard.

What is counted: every storage the step's ops make, at its byte size, and
the state and batch it was handed (held by the caller for the whole
step). What is not: the caching allocator's rounding and fragmentation,
library workspaces (cuBLAS), what a kernel allocates inside its op (the
flash backward's ``delta``), and NCCL's buffers. The contract is the
reference's: relative fidelity (remat, sharding, world) plus a measured
check on the card within ``HVDTPU_MEMPLAN_TOLERANCE``, where only an
under-prediction fails (:func:`compare_to_measured`).

The reference's donation becomes in-place reuse: the port's step has no
donation, and a state tensor the step replaces with a new one of the
same shape (instead of updating it in place) is a
``donation-missed-reuse`` candidate.

Surfaces: lint rules ``oom-risk`` / ``donation-missed-reuse`` /
``peak-regression`` (:mod:`.rules`), ``step.memplan(state, batch)``
(:func:`horovod_tpu_torch.parallel.dp.make_train_step`),
``horovod_tpu_torch/tools/hvdtpu_memplan.py``, and the
``memplan.peak_bytes`` gauge.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..utils import env as _env

__all__ = [
    "CATEGORIES",
    "MemoryLintConfig",
    "MemoryPlan",
    "compare_to_measured",
    "measure_step_bytes",
    "plan_record",
    "plan_traced",
    "project_sharding",
    "state_bytes",
]

# Report categories, in breakdown order. "workspace" absorbs the batch
# slice, step counters, guard scalars and anything unclassified.
CATEGORIES = ("params", "opt_state", "activations", "wire", "workspace")


@dataclasses.dataclass(frozen=True)
class MemoryLintConfig:
    """What the memory rule pass gates against (see
    :func:`~horovod_tpu_torch.analysis.rules.rule_memory`): ``None``
    budget / baseline leaves the corresponding rule silent."""

    budget_bytes: Optional[int] = None
    baseline_bytes: Optional[int] = None
    baseline_key: str = ""
    donation_threshold: float = 0.05
    regression_tolerance: float = 1.05


@dataclasses.dataclass
class MemoryPlan:
    """Per-device memory plan for one recorded step (module docstring)."""

    peak_bytes: int
    breakdown: Dict[str, int]  # at-peak live bytes per category (sums to peak)
    resident_bytes: int  # per-device persistent state (params + opt)
    global_state_bytes: int  # the (state, batch) bytes handed to the step
    params_bytes: int
    opt_state_bytes: int
    batch_bytes: int
    wire_bytes: int  # at-peak live collective buffers
    activation_bytes: int
    donation_saved_bytes: int  # no donation in the eager step: 0
    undonated_candidates: Tuple[Dict[str, Any], ...]
    world: int
    n_eqns: int
    n_buffers: int
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "peak_bytes": self.peak_bytes,
            "breakdown": dict(self.breakdown),
            "resident_bytes": self.resident_bytes,
            "global_state_bytes": self.global_state_bytes,
            "params_bytes": self.params_bytes,
            "opt_state_bytes": self.opt_state_bytes,
            "batch_bytes": self.batch_bytes,
            "wire_bytes": self.wire_bytes,
            "activation_bytes": self.activation_bytes,
            "donation_saved_bytes": self.donation_saved_bytes,
            "undonated_candidates": [dict(c) for c in
                                     self.undonated_candidates],
            "world": self.world,
            "n_eqns": self.n_eqns,
            "n_buffers": self.n_buffers,
            "meta": dict(self.meta),
        }

    def fmt(self) -> str:
        """Human breakdown table (the CLI's per-model block)."""
        lines = [f"peak {_fmt_bytes(self.peak_bytes)}/device"]
        for cat in CATEGORIES:
            b = self.breakdown.get(cat, 0)
            pct = 100.0 * b / self.peak_bytes if self.peak_bytes else 0.0
            lines.append(f"  {cat:<12} {_fmt_bytes(b):>10}  {pct:5.1f}%")
        lines.append(
            f"  {'(donation saves':<12} "
            f"{_fmt_bytes(self.donation_saved_bytes):>10})")
        return "\n".join(lines)


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024.0
    return f"{n}B"  # pragma: no cover


def _sweep(buffers, horizon: int) -> Tuple[int, int, Dict[str, int]]:
    """Peak of live bytes over the buffers' ``[born, freed]`` intervals
    (inputs from 0, survivors to ``horizon``): ``(peak_bytes, peak_time,
    at-peak breakdown)``."""
    delta = [0] * (horizon + 2)
    spans = []
    for b in buffers:
        lo = max(0, b.born)
        hi = horizon if b.freed is None else min(horizon, b.freed)
        if hi < lo:
            continue
        spans.append((lo, hi, b))
        delta[lo] += b.nbytes
        delta[hi + 1] -= b.nbytes
    peak, peak_t, live = 0, 0, 0
    for t in range(horizon + 1):
        live += delta[t]
        if live > peak:
            peak, peak_t = live, t
    breakdown = {c: 0 for c in CATEGORIES}
    for lo, hi, b in spans:
        if lo <= peak_t <= hi:
            cls = b.cls if b.cls in breakdown else "workspace"
            breakdown[cls] += b.nbytes
    return peak, peak_t, breakdown


def plan_record(rec, *, world: Optional[int] = None,
                meta: Optional[Dict[str, Any]] = None) -> MemoryPlan:
    """The plan of one record (:func:`.record.record`)."""
    horizon = rec.n_eqns + 1
    peak, peak_t, breakdown = _sweep(rec.buffers, horizon)
    params_b = rec.input_bytes.get("params", 0)
    opt_b = rec.input_bytes.get("opt_state", 0)
    batch_b = sum(b.nbytes for b in rec.buffers
                  if b.born < 0 and b.label.startswith("arg1"))
    undonated = tuple(
        {"label": c["label"], "class": c["class"], "bytes": c["bytes"],
         "saving_bytes": c["bytes"]}
        for c in rec.replaced if 0 <= c["out_born"] <= peak_t)
    return MemoryPlan(
        peak_bytes=peak,
        breakdown=breakdown,
        resident_bytes=params_b + opt_b,
        global_state_bytes=rec.global_state_bytes,
        params_bytes=params_b,
        opt_state_bytes=opt_b,
        batch_bytes=batch_b,
        wire_bytes=breakdown.get("wire", 0),
        activation_bytes=breakdown.get("activations", 0),
        donation_saved_bytes=0,
        undonated_candidates=undonated,
        world=int(world or rec.world),
        n_eqns=rec.n_eqns,
        n_buffers=len(rec.buffers),
        meta=dict(meta or {}),
    )


def plan_traced(
    fn,
    args: Tuple,
    *,
    world: Optional[int] = None,
    jaxpr=None,
    meta: Optional[Dict[str, Any]] = None,
) -> MemoryPlan:
    """Plan one step (see the module docstring): record ``fn(*args)``
    (``args`` real tensors or nests of them; nothing executes) or take
    the caller's record as ``jaxpr=`` (the reference's keyword, shared
    with lint and cert)."""
    from .record import record

    rec = jaxpr if jaxpr is not None else record(fn, args, world=world,
                                                 rank_check=False)
    return plan_record(rec, world=world, meta=meta)


# -- projections (ZeRO-2/3 what-ifs, costed before they exist) -----------


def project_sharding(plan: MemoryPlan, world: Optional[int] = None) -> Dict:
    """Analytic ZeRO-stage projections from one planned step: what the
    per-device peak becomes when gradients (ZeRO-2) and parameters
    (ZeRO-3) shard 1/N like the ZeRO-1 optimizer state already does.
    Gradient bytes are approximated by the params footprint (one grad
    per param, same dtype) and activations are held fixed — the honest
    first-order model for pure data parallelism."""
    n = world or plan.world
    grad_b = plan.params_bytes  # transient, currently full-size per device
    zero2 = plan.peak_bytes - grad_b * (n - 1) // n
    zero3 = zero2 - plan.params_bytes * (n - 1) // n
    return {
        "world": n,
        "zero1_peak_bytes": plan.peak_bytes,
        "zero2_peak_bytes": max(0, zero2),
        "zero3_peak_bytes": max(0, zero3),
        "grad_bytes_assumed": grad_b,
    }


# -- measurement (predicted-vs-actual) -----------------------------------


def state_bytes(*trees) -> int:
    """Bytes of the distinct storages of every tensor in ``trees`` (a
    ``TrainState``, a batch, nests of them): the CPU's "actual" that the
    plan's ``global_state_bytes`` is held against."""
    from .record import _leaves

    seen, total = set(), 0
    for tree in trees:
        for _, t in _leaves(tree):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += int(st.nbytes())
    return total


def measure_step_bytes(run_fn, *, device=None,
                       inputs: Sequence[Any] = ()) -> Tuple[int, str]:
    """Run ``run_fn()`` and measure memory. On the card: the step's own
    peak, ``torch.cuda.max_memory_allocated`` over the call (after
    ``reset_peak_memory_stats``) minus ``memory_allocated`` before it,
    source ``"device_peak"``. On the CPU: the live bytes of the state the
    step returns and of ``inputs`` (the batch), source ``"live_arrays"``
    (the reference's name), comparable to ``plan.global_state_bytes``.
    Returns ``(bytes, source)``."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = run_fn()
        torch.cuda.synchronize(dev)
        return int(torch.cuda.max_memory_allocated(dev) - before), \
            "device_peak"
    out = run_fn()
    state = out[0] if isinstance(out, (tuple, list)) else out
    return state_bytes(state, *inputs), "live_arrays"


def compare_to_measured(
    plan: MemoryPlan, measured: int, source: str,
    tolerance: Optional[float] = None,
) -> Dict[str, Any]:
    """Predicted vs measured with a relative-error tolerance
    (``HVDTPU_MEMPLAN_TOLERANCE`` default). ``live_arrays`` compares
    resident state; ``device_peak`` compares the modeled peak (an upper
    bound on what the allocator holds, so only the *under*-prediction
    side is a hard failure there)."""
    if tolerance is None:
        tolerance = _env.memplan_tolerance()
    predicted = (
        plan.global_state_bytes if source == "live_arrays" else plan.peak_bytes
    )
    ratio = predicted / measured if measured else float("inf")
    if source == "device_peak":
        ok = predicted >= measured * (1.0 - tolerance)
    elif source == "device_peak_stale":
        ok = None  # the peak predates the measured step: no verdict
    else:
        ok = abs(ratio - 1.0) <= tolerance
    return {
        "predicted_peak_bytes": plan.peak_bytes,
        "predicted_resident_bytes": plan.global_state_bytes,
        "measured_bytes": int(measured),
        "source": source,
        "ratio": round(ratio, 4),
        "tolerance": tolerance,
        "ok": None if ok is None else bool(ok),
        "breakdown": dict(plan.breakdown),
    }
