"""Rule passes of the SPMD linter, over a fake-tensor record.

The port of ``horovod_tpu/analysis/rules.py``: each pass is a pure
function from the record's collective sites and loop carries
(:mod:`.record`) to :class:`~.findings.LintFinding` tuples, with the
reference's rule ids, severities and messages. :func:`horovod_tpu_torch.
analysis.lint_traced` composes them. Where the reference walks jaxpr
equations (fp8 dots, named residuals, donation), the port reads what the
record logged: the ``hvt::fp8_matmul`` ops, the activation boundary's
marker, and the state tensors the step replaced instead of updating in
place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .findings import LintFinding, Severity
from .record import (
    REDUCING_COLLECTIVE_PRIMS,
    CollectiveSite,
    WalkResult,
    is_low_precision,
)


# -- collective consistency ---------------------------------------------


def rule_axis_names(
    sites: Sequence[CollectiveSite], declared_axes
) -> Tuple[LintFinding, ...]:
    """Every collective must name a declared mesh axis."""
    if declared_axes is None:
        return ()
    declared = frozenset(declared_axes)
    out = []
    for s in sites:
        unknown = [a for a in s.axes if a not in declared]
        if unknown:
            out.append(
                LintFinding(
                    rule="undeclared-axis",
                    severity=Severity.ERROR,
                    message=(
                        f"{s.kind} over undeclared axis "
                        f"{unknown} (declared: {sorted(declared)})"
                    ),
                    provenance=s.path,
                    details={"axes": list(s.axes), "unknown": unknown},
                )
            )
    return tuple(out)


def rule_control_flow(
    sites: Sequence[CollectiveSite],
) -> Tuple[LintFinding, ...]:
    """Collectives under cond/while/scan; rank-dependent nesting is the
    static deadlock signature."""
    out = []
    for s in sites:
        if not s.control_flow:
            continue
        kinds = [f.kind for f in s.control_flow]
        if any(f.rank_dependent for f in s.control_flow):
            out.append(
                LintFinding(
                    rule="rank-dependent-collective",
                    severity=Severity.ERROR,
                    message=(
                        f"{s.kind} nested under rank-dependent control "
                        f"flow {kinds}: ranks may execute different "
                        "collective sequences (deadlock on real hardware)"
                    ),
                    provenance=s.path,
                    details={"control_flow": kinds},
                )
            )
        else:
            out.append(
                LintFinding(
                    rule="collective-in-control-flow",
                    severity=Severity.WARNING,
                    message=(
                        f"{s.kind} nested under {kinds}: collective count "
                        "scales with the trip count — the one-fused-"
                        "reduction-per-step invariant wants collectives "
                        "outside accumulation loops"
                    ),
                    provenance=s.path,
                    details={"control_flow": kinds},
                )
            )
    return tuple(out)


def _aval_key(aval) -> Tuple:
    return (tuple(getattr(aval, "shape", ())), str(aval.dtype))


def rule_rs_ag_pairing(
    sites: Sequence[CollectiveSite],
) -> Tuple[LintFinding, ...]:
    """Sharded (ZeRO-1) steps must pair each reduce-scatter leg with one
    all-gather leg over the same shard shape, RS before AG."""
    rs = [s for s in sites if s.kind == "reduce_scatter"]
    ag = [
        s
        for s in sites
        if s.kind in ("all_gather", "all_gather_invariant")
    ]
    if not rs and not ag:
        return ()
    out: List[LintFinding] = []
    unpaired_ag = list(ag)
    for r in rs:
        shard_key = _aval_key(r.out_avals[0])
        match = None
        for a in unpaired_ag:
            if (
                _aval_key(a.in_avals[0]) == shard_key
                and a.order > r.order
                and a.axes == r.axes
            ):
                match = a
                break
        if match is not None:
            unpaired_ag.remove(match)
        else:
            out.append(
                LintFinding(
                    rule="rs-without-ag",
                    severity=Severity.ERROR,
                    message=(
                        "reduce-scatter leg has no matching all-gather "
                        f"(shard {shard_key[0]} {shard_key[1]} over "
                        f"{r.axes}); the sharded update would leave the "
                        "tree sharded"
                    ),
                    provenance=r.path,
                    details={
                        "shard_shape": list(shard_key[0]),
                        "dtype": shard_key[1],
                    },
                )
            )
    for a in unpaired_ag:
        if rs:  # AG alone in a program with RS legs — likely a leak
            out.append(
                LintFinding(
                    rule="ag-without-rs",
                    severity=Severity.INFO,
                    message=(
                        "all-gather with no matching reduce-scatter leg "
                        f"(input {_aval_key(a.in_avals[0])})"
                    ),
                    provenance=a.path,
                )
            )
    return tuple(out)


def collective_signature(
    sites: Sequence[CollectiveSite],
) -> Tuple[Tuple, ...]:
    return tuple(s.signature() for s in sorted(sites, key=lambda s: s.order))


def rule_order_divergence(
    sites_a: Sequence[CollectiveSite],
    sites_b: Sequence[CollectiveSite],
    label_a: str = "build A",
    label_b: str = "build B",
) -> Tuple[LintFinding, ...]:
    """Two builds that must co-execute (every rank runs one of them in
    the same step loop) must emit identical collective sequences."""
    sig_a, sig_b = collective_signature(sites_a), collective_signature(sites_b)
    if sig_a == sig_b:
        return ()
    n = min(len(sig_a), len(sig_b))
    idx = next((i for i in range(n) if sig_a[i] != sig_b[i]), n)
    a_at = sig_a[idx] if idx < len(sig_a) else None
    b_at = sig_b[idx] if idx < len(sig_b) else None
    return (
        LintFinding(
            rule="collective-order-divergence",
            severity=Severity.ERROR,
            message=(
                f"collective sequences diverge at position {idx}: "
                f"{label_a} has {len(sig_a)} collectives "
                f"({a_at}), {label_b} has {len(sig_b)} ({b_at}); "
                "co-executing ranks would deadlock"
            ),
            details={
                "index": idx,
                "n_a": len(sig_a),
                "n_b": len(sig_b),
                "a": repr(a_at),
                "b": repr(b_at),
            },
        ),
    )


# -- fusion parity -------------------------------------------------------


def _predicted_buckets(params, threshold_bytes, pad_multiple) -> List[Dict]:
    from ..ops.fusion import bucket_byte_layout

    return [
        {"dtype": d, "bytes": b}
        for d, b in bucket_byte_layout(
            params, threshold_bytes, pad_multiple=pad_multiple
        )
    ]


def _wire_cast(predicted: List[Dict], wire_dtype) -> List[Dict]:
    """Re-express predicted fp-bucket bytes in a cast compressor's wire
    dtype (fp16/bf16): the compressed collectives put the wire dtype on
    the wire, so parity must predict it or every compressed build would
    false-positive."""
    import torch

    wd = wire_dtype
    wd_name = _dtype_name(wd)
    out = []
    for b in predicted:
        dt = getattr(torch, b["dtype"])
        if dt.is_floating_point and dt != wd:
            out.append(
                {
                    "dtype": wd_name,
                    "bytes": b["bytes"] // dt.itemsize * wd.itemsize,
                }
            )
        else:
            out.append(b)
    return out


def _quant_fusion_parity(
    sites: Sequence[CollectiveSite],
    params,
    *,
    threshold_bytes: Optional[int],
    world: int,
    quant,
) -> Tuple[LintFinding, ...]:
    """Quantized-wire twin of fusion parity: every predicted bucket
    (padded to ``world * block``) must appear as ONE all-to-all group
    (the quantized reduce-scatter half) and ONE all-gather group (the
    broadcast half) in the wire dtype — the same accounting
    reference's ``tools/comm_audit.py --quant`` applies to compiled HLO."""
    from ..ops.fusion import quantized_bucket_layout

    predicted = quantized_bucket_layout(
        params, threshold_bytes, world=world, compression=quant
    )
    wire_name = _dtype_name(quant.spec.wire_dtype)
    pools = {
        "all_to_all": [
            (s, s.in_bytes)
            for s in sites
            if s.kind == "all_to_all"
            and s.in_avals
            and str(s.in_avals[0].dtype) == wire_name
        ],
        "all_gather": [
            (s, s.out_bytes)
            for s in sites
            if s.kind in ("all_gather", "all_gather_invariant")
            and s.out_avals
            and str(s.out_avals[0].dtype) == wire_name
        ],
    }
    out: List[LintFinding] = []
    for kind, pool in pools.items():
        remaining = list(pool)
        for bucket in predicted:
            hit = next(
                (e for e in remaining if e[1] == bucket["payload_bytes"]),
                None,
            )
            if hit is not None:
                remaining.remove(hit)
            else:
                out.append(
                    LintFinding(
                        rule="fusion-parity",
                        severity=Severity.ERROR,
                        message=(
                            f"predicted quantized {bucket['wire_dtype']} "
                            f"bucket of {bucket['payload_bytes']} wire "
                            f"bytes (padded to world*block="
                            f"{world}*{quant.block_size()}) has no "
                            f"matching {kind} group in the jaxpr (found "
                            f"{[e[1] for e in pool]})"
                        ),
                        details={
                            "kind": kind,
                            "predicted": predicted,
                            "observed": [e[1] for e in pool],
                        },
                    )
                )
    return tuple(out)


def _dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32`` (the reference's spelling)."""
    return str(dtype).replace("torch.", "")


def rule_fusion_parity(
    sites: Sequence[CollectiveSite],
    params,
    *,
    threshold_bytes: Optional[int],
    world: int,
    sharded: bool,
    quant=None,
    wire_dtype=None,
    gather_wire_dtype=None,
) -> Tuple[LintFinding, ...]:
    """The gradient buckets the fusion policy (``ops/fusion.PackSpec``)
    predicts must appear verbatim as collective groups in the record —
    same byte totals, same
    dtype, one launch each. Only top-level (outside-control-flow) sites
    count: a collective inside a loop runs once per iteration and can
    never be the step's single fused reduction. ``quant`` switches to
    the quantized-wire prediction (all-to-all + all-gather groups in the
    wire dtype, identical for the replicated and sharded builds);
    ``wire_dtype`` re-expresses cast-compressed buckets."""
    out: List[LintFinding] = []
    sites = [s for s in sites if not s.control_flow]
    if quant is not None:
        return _quant_fusion_parity(
            sites,
            params,
            threshold_bytes=threshold_bytes,
            world=world,
            quant=quant,
        )
    if sharded:
        predicted = _predicted_buckets(params, threshold_bytes, world)
        # The reduce-scatter leg carries `compression`'s wire dtype; the
        # all-gather (update) leg carries `gather_compression`'s — each
        # pool's prediction is re-expressed in its own wire dtype.
        predicted_rs = (
            _wire_cast(predicted, wire_dtype) if wire_dtype else predicted
        )
        predicted_ag = (
            _wire_cast(predicted, gather_wire_dtype)
            if gather_wire_dtype
            else predicted
        )
        pools = {
            "reduce_scatter": (
                predicted_rs,
                [
                    (s, s.in_bytes)
                    for s in sites
                    if s.kind == "reduce_scatter"
                ],
            ),
            "all_gather": (
                predicted_ag,
                [
                    (s, s.out_bytes)
                    for s in sites
                    if s.kind in ("all_gather", "all_gather_invariant")
                ],
            ),
        }
        for kind, (predicted_k, pool) in pools.items():
            remaining = list(pool)
            for bucket in predicted_k:
                hit = next(
                    (
                        e
                        for e in remaining
                        if e[1] == bucket["bytes"]
                        and str(e[0].in_avals[0].dtype) == bucket["dtype"]
                    ),
                    None,
                )
                if hit is not None:
                    remaining.remove(hit)
                else:
                    out.append(
                        LintFinding(
                            rule="fusion-parity",
                            severity=Severity.ERROR,
                            message=(
                                f"predicted {bucket['dtype']} bucket of "
                                f"{bucket['bytes']} bytes (padded to "
                                f"world={world}) has no matching {kind} "
                                f"group in the jaxpr (found "
                                f"{[e[1] for e in pool]})"
                            ),
                            details={
                                "kind": kind,
                                "predicted": predicted,
                                "observed": [e[1] for e in pool],
                            },
                        )
                    )
    else:
        predicted = _predicted_buckets(params, threshold_bytes, 1)
        if wire_dtype:
            predicted = _wire_cast(predicted, wire_dtype)
        groups = [
            (s, s.in_bytes, str(s.in_avals[0].dtype) if s.in_avals else "")
            for s in sites
            if s.kind in ("psum", "psum_invariant")
        ]
        remaining = list(groups)
        for bucket in predicted:
            hit = next(
                (
                    e
                    for e in remaining
                    if e[1] == bucket["bytes"] and e[2] == bucket["dtype"]
                ),
                None,
            )
            if hit is not None:
                remaining.remove(hit)
            else:
                out.append(
                    LintFinding(
                        rule="fusion-parity",
                        severity=Severity.ERROR,
                        message=(
                            f"predicted {bucket['dtype']} bucket of "
                            f"{bucket['bytes']} bytes has no matching "
                            "variadic psum group in the jaxpr (found "
                            f"{[e[1] for e in groups]})"
                        ),
                        details={
                            "kind": "psum",
                            "predicted": predicted,
                            "observed": [e[1] for e in groups],
                        },
                    )
                )
    return tuple(out)


def ring_wire_bytes(sites: Sequence[CollectiveSite], world: int) -> int:
    """Ring-schedule bytes over the slowest link — the same accounting as
    reference's ``tools/comm_audit.py`` (all-reduce ``2(n-1)/n*b`` on the full
    payload, reduce-scatter ``(n-1)*shard``, all-gather ``(n-1)/n*full``)
    computed from the record's shapes instead of compiled HLO."""
    n = world
    total = 0.0
    for s in sites:
        if s.kind in ("psum", "psum_invariant", "pmax", "pmin"):
            total += 2 * (n - 1) / n * s.out_bytes
        elif s.kind == "reduce_scatter":
            total += (n - 1) * s.out_bytes
        elif s.kind in ("all_gather", "all_gather_invariant"):
            total += (n - 1) / n * s.out_bytes
        elif s.kind == "all_to_all":
            total += (n - 1) / n * s.out_bytes
        else:
            total += s.out_bytes
    return int(total)


def rule_wire_parity(
    rep_sites: Sequence[CollectiveSite],
    shard_sites: Sequence[CollectiveSite],
    params,
    *,
    threshold_bytes: Optional[int],
    world: int,
    tolerance: float = 1.1,
) -> Tuple[LintFinding, ...]:
    """Replicated vs sharded build of one model: same gradient bucket
    count, ring-wire bytes within ``tolerance`` (static
    ``comm_audit --parity``)."""
    out: List[LintFinding] = []
    n_pred = len(_predicted_buckets(params, threshold_bytes, 1))
    n_rs = sum(1 for s in shard_sites if s.kind == "reduce_scatter")
    if n_rs != n_pred:
        out.append(
            LintFinding(
                rule="bucket-count-divergence",
                severity=Severity.ERROR,
                message=(
                    f"sharded build has {n_rs} reduce-scatter buckets but "
                    f"the fusion policy predicts {n_pred}"
                ),
                details={"reduce_scatters": n_rs, "predicted": n_pred},
            )
        )
    rep = ring_wire_bytes(rep_sites, world)
    shard = ring_wire_bytes(shard_sites, world)
    ratio = shard / max(1, rep)
    if ratio > tolerance:
        out.append(
            LintFinding(
                rule="wire-parity",
                severity=Severity.ERROR,
                message=(
                    f"sharded build moves {ratio:.3f}x the replicated "
                    f"build's ring-wire bytes ({shard} vs {rep}; "
                    f"tolerance {tolerance}x)"
                ),
                details={
                    "replicated_wire_bytes": rep,
                    "sharded_wire_bytes": shard,
                    "ratio": round(ratio, 4),
                },
            )
        )
    return tuple(out)


# -- precision -----------------------------------------------------------


def rule_precision_collectives(
    sites: Sequence[CollectiveSite], *, allow_low_precision: bool = False
) -> Tuple[LintFinding, ...]:
    if allow_low_precision:
        return ()
    out = []
    for s in sites:
        if s.kind not in REDUCING_COLLECTIVE_PRIMS:
            continue
        low = [str(a.dtype) for a in s.in_avals if is_low_precision(a)]
        if low:
            out.append(
                LintFinding(
                    rule="low-precision-collective",
                    severity=Severity.ERROR,
                    message=(
                        f"{s.kind} reduces in {sorted(set(low))} — the "
                        "reduction rounds on the wire; cast to fp32 or "
                        "request compression explicitly"
                    ),
                    provenance=s.path,
                    details={"dtypes": sorted(set(low))},
                )
            )
    return tuple(out)


def rule_precision_accumulators(walk: WalkResult) -> Tuple[LintFinding, ...]:
    out = []
    for c in walk.loop_carries:
        if c.is_pure_add_accumulator and is_low_precision(c.aval):
            out.append(
                LintFinding(
                    rule="low-precision-accumulator",
                    severity=Severity.ERROR,
                    message=(
                        f"{c.loop_kind}-carried accumulator at carry "
                        f"position {c.position} runs in {c.aval.dtype}: "
                        "every iteration rounds the running sum "
                        "(accumulate in fp32 like dp.accumulate_gradients)"
                    ),
                    provenance=c.path,
                    details={
                        "position": c.position,
                        "dtype": str(c.aval.dtype),
                        "shape": list(getattr(c.aval, "shape", ())),
                    },
                )
            )
    return tuple(out)


# -- low-precision compute (ops/fp8.py + ops/actquant.py) ----------------


def rule_low_precision(
    record,
    params,
    *,
    compute_dtype: str = "",
    act_quant: str = "",
) -> Tuple[LintFinding, ...]:
    """Low-precision compute must be *verified* low-precision compute:

    * ``low-precision-unverified`` (ERROR) — the recorded step runs
      ``hvt::fp8_matmul`` but the parameters carry no ``fp8_*``
      delayed-scaling state: the scales are not threaded through
      ``TrainState`` (never checkpointed, never resharded on elastic
      rescale), the signature of a hand-rolled fp8 cast instead of
      ``ops/fp8.Fp8Linear``.
    * ``act-quant-unconsumed`` (WARNING) — ``act_quant`` was requested
      but the recorded program stores no int8 boundary: the model
      declares no :func:`horovod_tpu_torch.ops.actquant.boundary`, so
      the request silently changed nothing.

    ``compute_dtype`` declared with *no* fp8 matmul in the record stays
    silent — the knob is opt-in-until-consumed, so a zoo sweep over
    models that ignore it stays clean.
    """
    del compute_dtype  # opt-in until consumed; the record is the truth
    out: List[LintFinding] = []
    dots = list(getattr(record, "fp8_ops", ()))
    if dots:
        from ..ops.fp8 import has_fp8_state

        if params is None or not has_fp8_state(params):
            dtypes = sorted({d for _, low in dots for d in low})
            out.append(
                LintFinding(
                    rule="low-precision-unverified",
                    severity=Severity.ERROR,
                    message=(
                        f"{len(dots)} fp8 matmul(s) ({dtypes}) in "
                        "the recorded step but the parameters carry "
                        "no fp8_* delayed-scaling state: scales are not "
                        "threaded through TrainState (not checkpointed, "
                        "not resharded canonically) — build the model "
                        "with compute_dtype='fp8' (ops/fp8.Fp8Linear) "
                        "instead of hand-rolling fp8 casts"
                    ),
                    provenance=dots[0][0],
                    details={
                        "fp8_dots": len(dots),
                        "dtypes": dtypes,
                        "first": dots[0][0],
                    },
                )
            )
    if act_quant:
        from ..ops.actquant import Q_NAME

        if not getattr(record, "markers", {}).get(Q_NAME):
            out.append(
                LintFinding(
                    rule="act-quant-unconsumed",
                    severity=Severity.WARNING,
                    message=(
                        f"act_quant={act_quant!r} was requested but the "
                        "recorded program stores no int8 boundary "
                        f"('{Q_NAME}'): the model declares no "
                        "ops/actquant.boundary, so activation storage is "
                        "unchanged full precision"
                    ),
                    details={"act_quant": act_quant},
                )
            )
    return tuple(out)


def rule_host_reads(record) -> Tuple[LintFinding, ...]:
    """``host-read-in-step`` (WARNING): the recorded step read a device
    value on the host (``.item()``, ``int(t)``); on the card that read
    waits for every launch before it. The record read it as zero."""
    return tuple(
        LintFinding(
            rule="host-read-in-step",
            severity=Severity.WARNING,
            message=(
                "the step reads a device value on the host: the card "
                "drains every launch before it, and the record read zero"
            ),
            provenance=path,
        )
        for path in getattr(record, "host_reads", ())
    )


# -- memory (static HBM planner, analysis/memory.py) ---------------------


def rule_memory(
    plan,
    *,
    budget_bytes: Optional[int] = None,
    baseline_bytes: Optional[int] = None,
    baseline_key: str = "",
    donation_threshold: float = 0.05,
    regression_tolerance: float = 1.05,
) -> Tuple[LintFinding, ...]:
    """Memory-plan rules over one :class:`~.memory.MemoryPlan`:

    * ``oom-risk`` (ERROR) — the predicted per-device peak exceeds the
      declared HBM budget (``HVDTPU_HBM_BUDGET_GB`` or the caller's);
    * ``donation-missed-reuse`` (WARNING) — a state tensor the step
      replaces instead of updating in place, where the reuse would cut
      the predicted peak by more than ``donation_threshold`` of it;
    * ``peak-regression`` (ERROR) — the predicted peak exceeds the
      checked-in per-model baseline by more than
      ``regression_tolerance`` (default +5%).

    Rules with no reference declared (no budget / no baseline) stay
    silent — a step that never states its envelope cannot violate it.
    """
    out: List[LintFinding] = []
    if budget_bytes and plan.peak_bytes > budget_bytes:
        out.append(
            LintFinding(
                rule="oom-risk",
                severity=Severity.ERROR,
                message=(
                    f"predicted per-device peak {plan.peak_bytes} bytes "
                    f"exceeds the declared HBM budget {budget_bytes} "
                    f"({plan.peak_bytes / budget_bytes:.2f}x); biggest "
                    "categories: "
                    + ", ".join(
                        f"{k}={v}"
                        for k, v in sorted(
                            plan.breakdown.items(), key=lambda kv: -kv[1]
                        )[:3]
                    )
                ),
                details={
                    "peak_bytes": plan.peak_bytes,
                    "budget_bytes": int(budget_bytes),
                    "breakdown": dict(plan.breakdown),
                },
            )
        )
    peak = plan.peak_bytes
    if peak:
        for cand in plan.undonated_candidates:
            if cand["saving_bytes"] < donation_threshold * plan.peak_bytes:
                continue
            out.append(
                LintFinding(
                    rule="donation-missed-reuse",
                    severity=Severity.WARNING,
                    message=(
                        f"undonated input {cand['label']} "
                        f"({cand['class']}, {cand['bytes']} bytes) has an "
                        "aliasable same-shape output; donating it would "
                        f"cut the predicted peak by ~{cand['saving_bytes']}"
                        f" bytes ({100.0 * cand['saving_bytes'] / peak:.1f}%)"
                    ),
                    provenance=cand["label"],
                    details=dict(cand),
                )
            )
    if baseline_bytes and peak > baseline_bytes * regression_tolerance:
        out.append(
            LintFinding(
                rule="peak-regression",
                severity=Severity.ERROR,
                message=(
                    f"predicted peak {plan.peak_bytes} bytes exceeds the "
                    f"checked-in baseline {int(baseline_bytes)} for "
                    f"{baseline_key or 'this step'} by "
                    f"{100.0 * (peak / baseline_bytes - 1.0):.1f}% "
                    f"(tolerance "
                    f"+{100.0 * (regression_tolerance - 1.0):.0f}%; "
                    "re-baseline deliberately with "
                    "tools/hvdtpu_memplan.py --write-baselines)"
                ),
                provenance=baseline_key,
                details={
                    "peak_bytes": plan.peak_bytes,
                    "baseline_bytes": int(baseline_bytes),
                    "tolerance": regression_tolerance,
                },
            )
        )
    return tuple(out)
