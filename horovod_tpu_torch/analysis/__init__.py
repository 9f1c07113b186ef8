"""Static SPMD analysis of a train step: collective, precision and memory
lints, and schedule certification — the port of
``horovod_tpu/analysis``.

The reference traces its step with ``jax.make_jaxpr`` and walks the
jaxpr. The port's step is eager Python, so its counterpart of the trace
is one call of the built step under fake tensors (:mod:`.record`): no
kernel launches, no device memory, no communication, and a simulated
world of any size. Everything else reads that record with the
reference's rules, rule ids, messages, cert layout and plan keys:

* :func:`lint_traced` — record a step and run the rule families over it:
  collective consistency, fusion parity, precision, memory (rule
  catalog: :mod:`.findings`). ``jaxpr=`` takes a record.
* :func:`trace_collectives` — just the record (collective sites + loop
  carries), for custom checks.
* :func:`compare_collectives` / :func:`static_parity` — cross-build
  checks: co-executable builds must issue identical collective
  sequences; the sharded (ZeRO-1) build must hold byte parity with the
  replicated one.
* :func:`schedule_cert` / :class:`~.certify.ScheduleCert` — the
  collective schedule's fingerprint, the cross-rank preflight gate
  (:func:`publish_and_verify`, armed by ``HVDTPU_CERT``) and the
  first-divergence diagnosis (:func:`diff_certs`). CLI:
  ``horovod_tpu_torch/tools/hvdtpu_verify.py``.
* :func:`plan_traced` / :class:`~.memory.MemoryPlan` — the per-device
  memory planner (:mod:`.memory`) over the record's storage lifetimes.

Entry points for daily use: ``parallel.dp.make_train_step(lint=...)``
(every built step exposes ``step.lint``, ``step.memplan``,
``step.certify``, ``step.preflight`` and ``step.trace``),
``horovod_tpu_torch/tools/hvdtpu_lint.py`` / ``hvdtpu_memplan.py`` /
``hvdtpu_verify.py`` (CLIs over the port's model zoo) and
``run_lints.py`` (the CI umbrella).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..utils import env as _env
from .certify import (  # noqa: F401
    CertMismatchError,
    KVCertChannel,
    ScheduleCert,
    diff_certs,
    publish_and_verify,
    schedule_cert,
    schedule_entries,
)
from .findings import (  # noqa: F401
    LintError,
    LintFinding,
    Severity,
    apply_allowlist,
    errors,
    max_severity,
)
from .memory import (  # noqa: F401
    MemoryLintConfig,
    MemoryPlan,
    compare_to_measured,
    measure_step_bytes,
    plan_record,
    plan_traced,
    project_sharding,
)
from .record import (  # noqa: F401
    Aval,
    CollectiveSite,
    ControlFrame,
    LoopCarry,
    Record,
    WalkResult,
    simulated_world,
)
from . import record as _record
from . import rules as _rules


def publish_peak_bytes(plan) -> None:
    """ONE home for the ``memplan.peak_bytes`` gauge (metric-name lint:
    a name has exactly one owning module). Both surfaces that compute a
    plan — ``step.memplan()`` and the armed-lint path — publish through
    here, so hvdtpu_top's "hbm plan" column fills on either recipe."""
    from ..obs import registry as _obs

    _obs.metrics().gauge("memplan.peak_bytes").set(plan.peak_bytes)


def trace_collectives(fn, args: Tuple, *, world: Optional[int] = None):
    """Record ``fn(*args)`` (nothing executes) and return the walk:
    collective sites and loop carries."""
    return _record.record(fn, args, world=world)


def lint_traced(
    fn,
    args: Tuple,
    *,
    donate_argnums: Sequence[int] = (),
    declared_axes=None,
    params=None,
    sharded: bool = False,
    threshold_bytes: Optional[int] = None,
    world: Optional[int] = None,
    allow_low_precision_collectives: bool = False,
    allowlist: Sequence[str] = (),
    jaxpr=None,
    quant=None,
    compute_dtype: str = "",
    act_quant: str = "",
    wire_dtype=None,
    gather_wire_dtype=None,
    memory: Optional[MemoryLintConfig] = None,
) -> Tuple[LintFinding, ...]:
    """Run every applicable lint pass over a recorded step.

    The reference's signature. ``fn(*args)`` is recorded once (twice at
    ``world > 1``, for rank dependence) unless ``jaxpr=`` hands over a
    record (:func:`.record.record`). ``donate_argnums`` is accepted for
    the reference's callers and unused: the eager step donates nothing,
    and replaced state is the memory pass's ``donation-missed-reuse``.
    ``params`` with ``world`` arms fusion parity; ``quant`` switches it to
    the quantized-wire prediction; ``wire_dtype`` / ``gather_wire_dtype``
    re-express cast-compressed buckets; ``memory`` arms the memory pass
    over the same record. Returns the findings that survive the
    allowlist, most severe first."""
    del donate_argnums
    if threshold_bytes is None:
        threshold_bytes = _env.fusion_threshold_bytes()
    rec = jaxpr if jaxpr is not None else _record.record(fn, args,
                                                          world=world)
    world = world or rec.world

    findings: list = []
    findings += _rules.rule_axis_names(rec.collectives, declared_axes)
    findings += _rules.rule_control_flow(rec.collectives)
    findings += _rules.rule_rs_ag_pairing(rec.collectives)
    findings += _rules.rule_precision_collectives(
        rec.collectives,
        allow_low_precision=allow_low_precision_collectives,
    )
    findings += _rules.rule_precision_accumulators(rec)
    findings += _rules.rule_low_precision(
        rec, params, compute_dtype=compute_dtype, act_quant=act_quant
    )
    findings += _rules.rule_host_reads(rec)
    if params is not None and world:
        findings += _rules.rule_fusion_parity(
            rec.collectives,
            params,
            threshold_bytes=threshold_bytes,
            world=world,
            sharded=sharded,
            quant=quant,
            wire_dtype=wire_dtype,
            gather_wire_dtype=gather_wire_dtype,
        )
    if memory is not None:
        plan = plan_record(rec, world=world)
        publish_peak_bytes(plan)
        findings += _rules.rule_memory(
            plan,
            budget_bytes=memory.budget_bytes,
            baseline_bytes=memory.baseline_bytes,
            baseline_key=memory.baseline_key,
            donation_threshold=memory.donation_threshold,
            regression_tolerance=memory.regression_tolerance,
        )
    kept = apply_allowlist(findings, allowlist)
    return tuple(sorted(kept, key=lambda f: -int(f.severity)))


def compare_collectives(
    fn_a,
    args_a: Tuple,
    fn_b,
    args_b: Tuple,
    *,
    label_a: str = "build A",
    label_b: str = "build B",
    world: Optional[int] = None,
) -> Tuple[LintFinding, ...]:
    """Static deadlock check between two builds that must co-execute
    (e.g. the same step at ``accum_steps=1`` vs ``K`` during a rolling
    reconfiguration): identical collective count, order and signatures."""
    wa = trace_collectives(fn_a, args_a, world=world)
    wb = trace_collectives(fn_b, args_b, world=world)
    return _rules.rule_order_divergence(
        wa.collectives, wb.collectives, label_a=label_a, label_b=label_b
    )


def static_parity(
    fn_replicated,
    args_replicated: Tuple,
    fn_sharded,
    args_sharded: Tuple,
    *,
    params,
    world: int,
    threshold_bytes: Optional[int] = None,
    tolerance: float = 1.1,
) -> Tuple[LintFinding, ...]:
    """Replicated-vs-sharded byte parity from two records (no
    communication, no device). Returns findings on bucket-count or
    ring-wire divergence."""
    if threshold_bytes is None:
        threshold_bytes = _env.fusion_threshold_bytes()
    rep = trace_collectives(fn_replicated, args_replicated, world=world)
    shard = trace_collectives(fn_sharded, args_sharded, world=world)
    return _rules.rule_wire_parity(
        rep.collectives,
        shard.collectives,
        params,
        threshold_bytes=threshold_bytes,
        world=world,
        tolerance=tolerance,
    )


def ring_wire_bytes(sites: Sequence[CollectiveSite], world: int) -> int:
    """Re-export of the ring accounting."""
    return _rules.ring_wire_bytes(sites, world)
