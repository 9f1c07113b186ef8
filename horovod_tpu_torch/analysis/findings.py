"""Lint finding records, severities and the allowlist mechanism.

The port of ``horovod_tpu/analysis/findings.py``: the same records, rule
ids, severities and allowlist, so the two packages' reports read alike.
The static analyzer (:mod:`horovod_tpu_torch.analysis`) reports
everything as structured :class:`LintFinding` records, produced from a
fake-tensor record of the step (:mod:`.record`) before any device
executes. Each finding carries a stable rule id (the catalog below), a
severity, a human message and provenance (the frame path of the op that
triggered it), so CI gates can filter, allowlist and diff them.

Rule catalog
============

Collective consistency (``SPMD``):
  * ``undeclared-axis`` (ERROR) — a collective names an axis outside the
    declared world/mesh axes.
  * ``collective-in-control-flow`` (WARNING) — a collective nested under
    ``cond``/``while``/``scan``; collective count then depends on trace-
    invisible trip counts (the fused-reduction-per-step invariant needs
    collectives OUTSIDE the accumulation loop).
  * ``rank-dependent-collective`` (ERROR) — the records of rank 0 and of
    rank ``world - 1`` issue different collective sequences here: ranks
    can execute different collectives, the static form of the deadlock
    a StallInspector only catches at runtime.
  * ``rs-without-ag`` (ERROR) / ``ag-without-rs`` (INFO) — the sharded
    (ZeRO-1) update must pair every reduce-scatter leg with exactly one
    all-gather leg of the same shard shape.
  * ``collective-order-divergence`` (ERROR) — two builds that must be
    co-executable (e.g. accum_steps=1 vs K) emit different collective
    sequences.
  * ``bucket-count-divergence`` (ERROR) / ``wire-parity`` (ERROR) — the
    replicated and sharded builds of one model disagree on gradient
    bucket count or ring-wire bytes (static twin of
    ``tools/comm_audit.py --parity``).

Fusion parity (``FUSE``):
  * ``fusion-parity`` (ERROR) — a bucket predicted by the fusion policy
    (:func:`horovod_tpu_torch.ops.fusion.bucket_byte_layout`) has no
    matching collective group in the record.

Memory (``MEM``, from the static HBM planner :mod:`.memory`):
  * ``oom-risk`` (ERROR) — the planner's predicted per-device peak
    exceeds the declared HBM budget (``HVDTPU_HBM_BUDGET_GB``).
  * ``donation-missed-reuse`` (WARNING) — a state tensor the step
    replaces with a new one of the same shape instead of updating it in
    place (the eager step's form of a missed donation), where the reuse
    would cut the predicted peak past a threshold (default 5%).
  * ``peak-regression`` (ERROR) — the predicted peak exceeds the
    checked-in per-model baseline (``horovod_tpu_torch/tools/
    memplan_baselines.json``) by more than +5%; re-baseline
    deliberately, never silently.

Precision (``PREC``):
  * ``low-precision-collective`` (ERROR) — a reducing collective
    (psum/reduce-scatter/pmax/pmin) rounds through bf16/fp16 without the
    caller explicitly requesting wire compression.
  * ``low-precision-accumulator`` (ERROR) — a loop-carried pure
    accumulator (carry whose only use is the add producing its next
    value) lives in bf16/fp16: K-1 low-precision adds round the running
    sum every microbatch.
  * ``low-precision-unverified`` (ERROR) — the recorded step runs
    ``hvt::fp8_matmul`` but the parameters hold no ``fp8_*``
    delayed-scaling state: scales are not threaded through
    ``TrainState`` (never checkpointed, never resharded on elastic
    rescale) — the signature of a hand-rolled fp8 cast instead of
    ``ops/fp8.Fp8Linear``.
  * ``act-quant-unconsumed`` (WARNING) — ``act_quant='int8'`` was
    requested but the recorded program stores no int8 boundary: the
    model declares no ``ops/actquant`` boundary, so activation storage
    silently stayed full precision.

Host reads (``HOST``, the port's own):
  * ``host-read-in-step`` (WARNING) — the recorded step reads a device
    value on the host (``.item()``, ``int(t)``): on the card that read
    waits for every launch before it.

Allowlisting
============

An allowlist entry is either a bare rule id (``"donation-dropped"``) or
``"rule-id:substring"`` where the substring must occur in the finding's
provenance or message (``"low-precision-collective:loss"``). Matching
findings are dropped by :func:`apply_allowlist` before reporting.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Sequence, Tuple

from ..exceptions import HorovodTpuError


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "ERROR", not "Severity.ERROR" in reports
        return self.name


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One static-analysis diagnostic.

    ``provenance`` is the frame path of the offending op in the record
    (``"scan/psum[#12]"``); ``details`` carries
    rule-specific structured data (byte counts, axis names, leaf paths)
    for machine consumption — the JSON the CLI emits is exactly
    :func:`LintFinding.to_dict`.
    """

    rule: str
    severity: Severity
    message: str
    provenance: str = ""
    details: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": str(self.severity),
            "message": self.message,
            "provenance": self.provenance,
            "details": self.details or {},
        }

    def __str__(self) -> str:
        loc = f" [{self.provenance}]" if self.provenance else ""
        return f"{self.severity}:{self.rule}: {self.message}{loc}"


class LintError(HorovodTpuError):
    """Raised by ``make_train_step(lint='raise')`` / ``--fail-on`` when a
    step trips ERROR-severity findings."""

    def __init__(self, findings: Sequence[LintFinding]):
        self.findings = tuple(findings)
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            f"SPMD lint failed with {len(self.findings)} finding(s):\n{lines}"
        )


def apply_allowlist(
    findings: Sequence[LintFinding], allowlist: Sequence[str]
) -> Tuple[LintFinding, ...]:
    """Drop findings matched by ``allowlist`` entries (see module doc)."""
    if not allowlist:
        return tuple(findings)
    kept = []
    for f in findings:
        suppressed = False
        for entry in allowlist:
            rule, _, frag = entry.partition(":")
            if rule != f.rule:
                continue
            if not frag or frag in f.provenance or frag in f.message:
                suppressed = True
                break
        if not suppressed:
            kept.append(f)
    return tuple(kept)


def max_severity(findings: Sequence[LintFinding]) -> Optional[Severity]:
    return max((f.severity for f in findings), default=None)


def errors(findings: Sequence[LintFinding]) -> Tuple[LintFinding, ...]:
    return tuple(f for f in findings if f.severity >= Severity.ERROR)
