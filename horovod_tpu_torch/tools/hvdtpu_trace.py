#!/usr/bin/env python
"""hvdtpu_trace — merge per-rank flight-recorder dumps into one Perfetto
session, clock-aligned, with per-phase statistics.

The port of the JAX package's ``tools/hvdtpu_trace.py``. The file formats
are the same in both packages, so this tool reads either package's files,
and the JAX package's tool reads the port's.

The span recorder (:mod:`horovod_tpu_torch.obs.trace`) dumps one
``trace_<stem>.<pid>.json`` per process (ranks, plus the elastic
driver's ``trace_driver.<pid>.json``), each stamped in that host's OWN
wall clock. This tool:

* **aligns clocks**: each rank records ``clock_sync`` instants when it
  observes a driver-published round timestamp (the KV plane's ts keys).
  The observed delta ``local - driver`` is the rank's true offset plus
  a non-negative KV propagation delay, so the MINIMUM over observations
  estimates the offset — pooled across every file sharing a stem
  (process generations on one host share its clock); a stem with no
  sync events anywhere is left unshifted.
* **merges**: one Perfetto/Chrome JSON with a process row per input
  file (``process_name`` metadata from the dump's stem) — load it in
  https://ui.perfetto.dev or ``chrome://tracing``.
* **pins correlation lines**: every driver ``round.publish`` span and
  every distinct training step become global instant markers, so "rank
  3's step 41" and "the KV republished round 7" sit on one grid.
* **reports** (``--report``): per-phase p50/p95 durations per category
  and the cross-rank start skew of each step — the per-phase timing
  that localizes comm/compute pathologies (arXiv:1810.11112's method,
  automated).

Standalone host-timeline files (``HVDTPU_TIMELINE`` output,
``utils/timeline.py``) can be merged too: their ``trace_epoch``
metadata record rebases their relative timestamps onto wall clock.

Usage::

    python -m horovod_tpu_torch.tools.hvdtpu_trace --dir ./hvdtpu_trace --out merged.json
    python -m horovod_tpu_torch.tools.hvdtpu_trace --dir ./hvdtpu_trace --report
    python -m horovod_tpu_torch.tools.hvdtpu_trace trace_rank0.json trace_driver.json \
        --timeline /tmp/tl.json --out merged.json
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

CLOCK_SYNC = "clock_sync"
# Span names treated as "a training step" for skew/correlation purposes:
# the jit step wrapper's span and the elastic commit bracket.
STEP_NAMES = ("step", "worker.step")

_REQUIRED_BY_PH = {
    "X": ("name", "ts", "dur"),
    "B": ("name", "ts"),
    "E": ("name", "ts"),
    "i": ("name", "ts"),
    "M": ("name",),
}


def validate_events(events: List[dict]) -> List[str]:
    """Chrome ``trace_event`` schema check; returns human-readable
    problems ([] = valid). Used by the tests to pin the emitted schema
    and by ``--report`` to refuse garbage input early."""
    problems: List[str] = []
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = ev.get("ph")
        if ph not in _REQUIRED_BY_PH:
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        for key in _REQUIRED_BY_PH[ph]:
            if key not in ev:
                problems.append(f"event {i} ({ph}): missing {key!r}")
        for key in ("ts", "dur", "pid"):
            if key in ev and not isinstance(ev[key], (int, float)):
                problems.append(f"event {i}: {key} is not numeric")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"event {i}: args is not an object")
    return problems


def load_trace(path: str) -> dict:
    """One input file → ``{"traceEvents": [...], "metadata": {...}}``.

    Accepts flight-recorder dumps (JSON object), finished timeline
    files (JSON array) and *unterminated* timeline arrays — the writer
    thread appends ``rec,\\n`` per record, so a crash leaves a valid
    prefix that a trailing-comma repair recovers (the same leniency
    chrome://tracing applies)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        repaired = text.rstrip().rstrip(",") + "\n]"
        doc = json.loads(repaired)
    if isinstance(doc, list):
        doc = {"traceEvents": doc, "metadata": {}}
    # Timeline files close their array with an empty {} sentinel (the
    # chrome-trace idiom for "trailing comma is fine"); drop it.
    doc["traceEvents"] = [e for e in doc.get("traceEvents", []) if e]
    doc.setdefault("metadata", {})
    doc["metadata"].setdefault(
        "stem", os.path.splitext(os.path.basename(path))[0]
    )
    # Timeline files: relative µs + a trace_epoch metadata record →
    # rebase onto wall clock so they merge with the span dumps.
    epoch = None
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "trace_epoch":
            epoch = float(ev.get("args", {}).get("wall", 0.0))
            break
    if epoch:
        base = int(epoch * 1e6)
        for ev in doc["traceEvents"]:
            if ev.get("ph") != "M":
                ev["ts"] = int(ev.get("ts", 0)) + base
        doc["metadata"]["rebased_from_epoch"] = epoch
    return doc


def clock_offset_us(events: List[dict]) -> Optional[int]:
    """This file's clock offset vs the driver, in µs: min over
    ``clock_sync`` observations of ``local - driver`` (propagation
    delay only ever adds, so the min converges on the true skew).
    None when the file never observed the driver's clock."""
    deltas = [
        int(ev["ts"]) - int(float(ev["args"]["driver_ts"]) * 1e6)
        for ev in events
        if ev.get("name") == CLOCK_SYNC and "driver_ts" in ev.get("args", {})
    ]
    return min(deltas) if deltas else None


def merge(docs: List[dict]) -> dict:
    """Clock-align and merge parsed trace docs into one session."""
    merged: List[dict] = []
    # Driver rows first (pid 0): their clock is the reference.
    docs = sorted(
        docs,
        key=lambda d: (d["metadata"].get("role") != "driver",
                       str(d["metadata"].get("stem"))),
    )
    # Pool clock observations per stem: every process generation on a
    # host reads the same physical clock, so the smallest observation
    # from ANY generation aligns them all. A dump whose only sync is
    # stale — a respawn that joined a round published long before it
    # booted — borrows its predecessor's fresher observation instead of
    # poisoning the stem's offset.
    stems = [
        str(doc["metadata"].get("stem", i)) for i, doc in enumerate(docs)
    ]
    offsets: Dict[str, Optional[int]] = {}
    for stem, doc in zip(stems, docs):
        off = clock_offset_us(doc["traceEvents"])
        prev = offsets.get(stem)
        if prev is None or (off is not None and off < prev):
            offsets[stem] = off
    step_marks: Dict[Tuple[str, int], int] = {}
    for pid, (stem, doc) in enumerate(zip(stems, docs)):
        events = doc["traceEvents"]
        shift = offsets[stem] or 0
        merged.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": stem},
        })
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue  # replaced by the per-file row above
            out = dict(ev)
            out["pid"] = pid
            if out.get("ph") != "M":
                out["ts"] = int(out.get("ts", 0)) - shift
            merged.append(out)
            # Correlation sources: driver round publishes and step spans.
            name = out.get("name")
            args = out.get("args") or {}
            if name == "round.publish" and "round" in args:
                step_marks[("round", int(args["round"]))] = out["ts"]
            elif (
                out.get("ph") == "X"
                and name in STEP_NAMES
                and "step" in args
            ):
                key = ("step", int(args["step"]))
                ts = int(out["ts"])
                if key not in step_marks or ts < step_marks[key]:
                    step_marks[key] = ts
    # Global instant markers: one vertical line per round / step across
    # every process row (Perfetto renders s:"g" instants full-height).
    for (kind, num), ts in sorted(step_marks.items(), key=lambda kv: kv[1]):
        merged.append({
            "ph": "i", "name": f"{kind} {num}", "cat": "correlation",
            "ts": ts, "pid": 0, "tid": 0, "s": "g",
            "args": {kind: num},
        })
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "merged_from": [str(d["metadata"].get("stem")) for d in docs],
            "clock_offsets_us": offsets,
        },
    }


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    k = min(len(sorted_vals) - 1,
            max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[k]


def report(merged: dict) -> dict:
    """Per-phase p50/p95 (ms) and per-step cross-rank start skew."""
    phases: Dict[Tuple[str, str], List[float]] = {}
    step_starts: Dict[int, Dict[int, int]] = {}
    for ev in merged["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        key = (ev.get("cat", "?"), ev["name"])
        phases.setdefault(key, []).append(float(ev.get("dur", 0)) / 1e3)
        args = ev.get("args") or {}
        if ev["name"] in STEP_NAMES and "step" in args:
            per = step_starts.setdefault(int(args["step"]), {})
            pid = int(ev.get("pid", 0))
            ts = int(ev["ts"])
            if pid not in per or ts < per[pid]:
                per[pid] = ts
    phase_rows = {}
    for (cat, name), durs in sorted(phases.items()):
        durs.sort()
        phase_rows[f"{cat}:{name}"] = {
            "count": len(durs),
            "p50_ms": round(_pctl(durs, 0.50), 3),
            "p95_ms": round(_pctl(durs, 0.95), 3),
            "max_ms": round(durs[-1], 3),
        }
    skews = {}
    for step, per in sorted(step_starts.items()):
        if len(per) < 2:
            continue
        skews[step] = {
            "ranks": len(per),
            "skew_ms": round((max(per.values()) - min(per.values())) / 1e3,
                             3),
        }
    return {
        "phases": phase_rows,
        "step_skew": skews,
        "max_step_skew_ms": max(
            (row["skew_ms"] for row in skews.values()), default=0.0
        ),
        "clock_offsets_us": merged["metadata"].get("clock_offsets_us", {}),
    }


def discover(directory: str) -> List[str]:
    return sorted(glob.glob(os.path.join(directory, "trace_*.json")))


def merge_dir(directory: str, out: Optional[str] = None,
              extra: Tuple[str, ...] = ()) -> Optional[dict]:
    """Merge every dump under ``directory`` (+ explicit extras); write
    ``out`` when given. Returns the merged doc, or None when there was
    nothing to merge — the chaos-soak diagnostics path calls this."""
    paths = discover(directory) + list(extra)
    if not paths:
        return None
    merged = merge([load_trace(p) for p in paths])
    if out:
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, out)
    return merged


def main() -> int:
    ap = argparse.ArgumentParser(prog="hvdtpu_trace")
    ap.add_argument("files", nargs="*", help="explicit trace files")
    ap.add_argument(
        "--dir", default=None,
        help="directory of flight-recorder dumps (default: "
        "HVDTPU_TRACE_DIR or ./hvdtpu_trace)",
    )
    ap.add_argument(
        "--timeline", action="append", default=[],
        help="host-timeline file (HVDTPU_TIMELINE output) to merge in",
    )
    ap.add_argument("--out", default=None, help="merged JSON output path")
    ap.add_argument(
        "--report", action="store_true",
        help="print per-phase p50/p95 + cross-rank step skew",
    )
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args()

    paths = list(args.files) + list(args.timeline)
    if not paths or args.dir:
        directory = args.dir or os.environ.get(
            "HVDTPU_TRACE_DIR",
            os.path.join(os.getcwd(), "hvdtpu_trace"),
        )
        paths = discover(directory) + paths
    if not paths:
        print("hvdtpu_trace: no trace files found", file=sys.stderr)
        return 1
    docs = [load_trace(p) for p in paths]
    for p, d in zip(paths, docs):
        problems = validate_events(d["traceEvents"])
        if problems:
            print(
                f"hvdtpu_trace: {p}: {len(problems)} schema problem(s): "
                + "; ".join(problems[:5]),
                file=sys.stderr,
            )
            return 1
    merged = merge(docs)
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, args.out)
        if not args.json:
            print(
                f"merged {len(paths)} file(s), "
                f"{len(merged['traceEvents'])} events -> {args.out}"
            )
    if args.report or not args.out:
        rep = report(merged)
        if args.json:
            print(json.dumps(rep))
        else:
            print("clock offsets (us, vs driver):")
            for stem, off in rep["clock_offsets_us"].items():
                print(f"  {stem}: {off if off is not None else 'n/a'}")
            print("phase durations (ms):")
            for name, row in rep["phases"].items():
                print(
                    f"  {name}: n={row['count']} p50={row['p50_ms']} "
                    f"p95={row['p95_ms']} max={row['max_ms']}"
                )
            if rep["step_skew"]:
                print(
                    "cross-rank step skew (ms): max "
                    f"{rep['max_step_skew_ms']}"
                )
                for step, row in rep["step_skew"].items():
                    print(
                        f"  step {step}: ranks={row['ranks']} "
                        f"skew={row['skew_ms']}"
                    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
