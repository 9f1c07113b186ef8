#!/usr/bin/env python
"""hvdtpu_goodput — job-level goodput report from exported metrics.

The port of the JAX package's ``tools/hvdtpu_goodput.py``. The file
formats are the same in both packages, so this tool reads either
package's files, and the JAX package's tool reads the port's.

Reads the per-rank JSONL files the metrics plane exports (plus the
elastic driver's ``driver.jsonl``) and reports the goodput ledger's
wall-clock attribution (:mod:`horovod_tpu_torch.obs.goodput`): per-rank
category seconds, the job roll-up (summed rank-seconds), the goodput
fraction (``compute / elapsed``), and the top-N downtime causes — each
linked to its ``docs/runbook.md`` triage row so the report ends in a
remediation, not a number.

``--trace`` cross-checks the ledger against the merged flight-recorder
spans (:mod:`.hvdtpu_trace`): per category, the ledger's seconds
vs the summed durations of the spans that feed it. The two measure the
same brackets through independent code paths, so a large relative delta
means an instrumentation regression, not a slow job.

Usage::

    python -m horovod_tpu_torch.tools.hvdtpu_goodput --dir ./hvdtpu_metrics
    python -m horovod_tpu_torch.tools.hvdtpu_goodput --dir ./hvdtpu_metrics --json
    python -m horovod_tpu_torch.tools.hvdtpu_goodput --dir m --trace ./hvdtpu_trace
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.obs.goodput import CATEGORIES, RUNBOOK_ROWS

# Ledger category -> trace span names that feed it (the --trace
# cross-check's mapping). Spans absent from the mapping (and categories
# with no span source, like adoption_gap) are skipped, not failed.
TRACE_SOURCES: Dict[str, Tuple[str, ...]] = {
    "compute": ("step.device", "serve.decode.round"),
    "host_dispatch": ("step.host_dispatch",),
    "input_stall": ("prefetch.fill",),
    "checkpoint": (),
    "rescale_downtime": ("elastic.join", "round.publish", "lease.expiry"),
}


def _tail_record(path: str) -> Optional[dict]:
    """Last parseable JSONL record of ``path`` (exports append; the
    final line may be torn by a crash — walk back to a whole one)."""
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        line = line.strip()
        if not line:
            continue
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def collect(directory: str) -> List[dict]:
    """One row per exporter stem that carries goodput gauges:
    ``{"stem", "rank", "totals": {cat: s}, "elapsed_s", "fraction"}``."""
    rows: List[dict] = []
    for path in sorted(glob.glob(os.path.join(directory, "*.jsonl"))):
        rec = _tail_record(path)
        if rec is None:
            continue
        gauges = rec.get("gauges", {})
        if "goodput.elapsed_s" not in gauges:
            continue
        totals = {
            cat: float(gauges.get(f"goodput.{cat}_s", 0.0))
            for cat in CATEGORIES
        }
        rows.append({
            "stem": os.path.splitext(os.path.basename(path))[0],
            "rank": rec.get("rank"),
            "totals": totals,
            "elapsed_s": float(gauges["goodput.elapsed_s"]),
            "fraction": float(gauges.get("goodput.fraction", 0.0)),
        })
    return rows


def rollup(rows: List[dict]) -> dict:
    """Job view: summed rank-seconds (every exporting process weighted
    by its own elapsed time), fraction = Σ compute / Σ elapsed, and the
    downtime causes ranked by stolen seconds."""
    totals = {cat: 0.0 for cat in CATEGORIES}
    elapsed = 0.0
    for row in rows:
        for cat in CATEGORIES:
            totals[cat] += row["totals"][cat]
        elapsed += row["elapsed_s"]
    fraction = (totals["compute"] / elapsed) if elapsed > 0 else 0.0
    causes = sorted(
        (
            {"category": c, "seconds": s, "runbook": RUNBOOK_ROWS[c]}
            for c, s in totals.items()
            if c != "compute" and s > 0
        ),
        key=lambda d: -d["seconds"],
    )
    return {
        "totals": totals,
        "elapsed_s": elapsed,
        "fraction": fraction,
        "causes": causes,
        "n_processes": len(rows),
    }


def trace_crosscheck(
    rows: List[dict], trace_dir: str, tolerance: float = 0.25
) -> List[dict]:
    """Ledger seconds vs merged-span seconds per mapped category.

    Returns one entry per category with a span source present in the
    trace: ``{"category", "ledger_s", "trace_s", "ok"}``. ``ok`` is a
    relative agreement check with an absolute floor (sub-second
    categories are noise, not evidence)."""
    from . import hvdtpu_trace as _tr

    merged = _tr.merge_dir(trace_dir)
    if merged is None:
        return []
    span_secs: Dict[str, float] = {}
    for ev in merged["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name")
        args = ev.get("args") or {}
        # A prefetch fill only fed the ledger when it stalled the
        # consumer (the span records both kinds; the arg disambiguates).
        if name == "prefetch.fill" and not args.get("stalled"):
            continue
        span_secs[name] = span_secs.get(name, 0.0) + float(
            ev.get("dur", 0)
        ) / 1e6
    job = rollup(rows)
    out: List[dict] = []
    for cat, sources in TRACE_SOURCES.items():
        trace_s = sum(span_secs.get(n, 0.0) for n in sources)
        if not any(n in span_secs for n in sources):
            continue
        ledger_s = job["totals"][cat]
        # exposed_comm is carved OUT of the device span, so the trace's
        # device total naturally exceeds the ledger's compute by it.
        if cat == "compute":
            ledger_s += job["totals"]["exposed_comm"]
        big = max(ledger_s, trace_s)
        ok = big < 1.0 or abs(ledger_s - trace_s) <= tolerance * big
        out.append({
            "category": cat,
            "ledger_s": round(ledger_s, 3),
            "trace_s": round(trace_s, 3),
            "ok": ok,
        })
    return out


def render(rows: List[dict], job: dict, checks: List[dict],
           top: int) -> str:
    lines: List[str] = []
    lines.append(
        f"goodput: {job['fraction'] * 100:.1f}% of "
        f"{job['elapsed_s']:.1f} rank-seconds across "
        f"{job['n_processes']} process(es)"
    )
    lines.append("")
    header = f"{'process':>10} {'fraction':>9} {'elapsed_s':>10}  top categories"
    lines.append(header)
    for row in rows:
        tops = sorted(
            ((c, s) for c, s in row["totals"].items() if s > 0),
            key=lambda cs: -cs[1],
        )[:3]
        cats = "  ".join(f"{c}={s:.1f}s" for c, s in tops)
        lines.append(
            f"{row['stem']:>10} {row['fraction'] * 100:>8.1f}% "
            f"{row['elapsed_s']:>10.1f}  {cats}"
        )
    if job["causes"]:
        lines.append("")
        lines.append(f"top downtime causes (runbook: docs/runbook.md):")
        for cause in job["causes"][:top]:
            lines.append(
                f"  {cause['category']:>18} {cause['seconds']:>9.1f}s"
                f"  -> {cause['runbook']}"
            )
    for chk in checks:
        verdict = "ok" if chk["ok"] else "MISMATCH"
        lines.append(
            f"trace cross-check {chk['category']:>18}: "
            f"ledger={chk['ledger_s']}s trace={chk['trace_s']}s "
            f"[{verdict}]"
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="hvdtpu_goodput")
    ap.add_argument(
        "--dir", default=None,
        help="metrics export directory (default: HVDTPU_METRICS_DIR or "
        "./hvdtpu_metrics)",
    )
    ap.add_argument(
        "--trace", default=None, metavar="TRACE_DIR",
        help="cross-check the ledger against merged flight-recorder "
        "spans from this directory",
    )
    ap.add_argument("--top", type=int, default=5,
                    help="downtime causes to list (default 5)")
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    directory = args.dir or os.environ.get(
        "HVDTPU_METRICS_DIR", os.path.join(os.getcwd(), "hvdtpu_metrics")
    )
    rows = collect(directory)
    if not rows:
        print(
            f"hvdtpu_goodput: no goodput gauges under {directory} "
            "(is HVDTPU_GOODPUT=1 and HVDTPU_METRICS=1?)",
            file=sys.stderr,
        )
        return 1
    job = rollup(rows)
    checks = trace_crosscheck(rows, args.trace) if args.trace else []
    if args.json:
        print(json.dumps({
            "rows": rows,
            "job": job,
            "trace_checks": checks,
        }, sort_keys=True))
    else:
        print(render(rows, job, checks, args.top))
    return 0 if all(c["ok"] for c in checks) else 2


if __name__ == "__main__":
    sys.exit(main())
