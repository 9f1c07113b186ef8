"""run_lints — one-process umbrella over the port's lint gates.

The port of the JAX package's ``tools/run_lints.py``. Runs, in order:

1. **metric-name lint** (:mod:`.check_metric_names`) — every metric name
   the port emits has exactly one owning module and appears in
   ``docs/api.md``'s metric index;
2. **goodput-runbook lint** — every goodput ledger category has a triage
   row in ``docs/runbook.md``;
3. **thread lint** (:mod:`.hvdtpu_threadlint`) — the AST lock-discipline
   sweep of the port's threaded control plane;
4. **SPMD lint sweep** (``analysis.harness.sweep``) — every zoo model
   under every sweep variant, recorded and run through the rule catalog;
   the gate fails on ERROR findings (the port's eager steps carry the
   ``donation-missed-reuse`` WARNINGs the memory pass reports for state
   they replace, ROADMAP §C);
5. **memplan sweep** (``harness.memplan_sweep``) — the planner over the
   same records, gated (on ERROR findings, as the SPMD gate) against the
   port's ``memplan_baselines.json`` (``peak-regression``) and
   ``HVDTPU_HBM_BUDGET_GB`` (``oom-risk``);
6. **certify gate** (``harness.cert_sweep``) — one build recorded twice
   must reproduce its digest, a seeded-divergent build (sharded vs
   replicated) must not, and the whole zoo must certify.

The JAX package's env and docs gates read its own ``utils/env.py``; the
port's knobs are held to the reference's declarations by
``tests/test_torch_port_tune.py``. Everything is CPU work in one
process::

    python -m horovod_tpu_torch.tools.run_lints [--json] [--skip-sweep]

Exit status 0 only when every gate is clean.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def run_all(skip_sweep: bool = False) -> dict:
    """Run every gate; importable (the tests call this directly)."""
    from . import check_metric_names as metric_lint
    from . import hvdtpu_threadlint as threadlint

    report = {"tool": "run_lints", "gates": {}}
    scanned = metric_lint.scan()
    multi_owned = metric_lint.check_ownership(scanned)
    undoc = metric_lint.check_docs(scanned)
    report["gates"]["metric-names"] = {
        "ok": not multi_owned and not undoc,
        "multi_owned": [{"name": n, "modules": m} for n, m in multi_owned],
        "undocumented": undoc,
    }
    missing_rows = metric_lint.check_goodput_runbook()
    report["gates"]["goodput-runbook"] = {"ok": not missing_rows,
                                          "missing": missing_rows}
    thread_findings = threadlint.scan_paths(threadlint.DEFAULT_PATHS)
    report["gates"]["thread"] = {
        "ok": not thread_findings,
        "n_findings": len(thread_findings),
        "findings": [f.to_dict() for f in thread_findings],
    }
    if skip_sweep:
        for gate in ("spmd", "memplan", "certify"):
            report["gates"][gate] = {"ok": True, "skipped": True}
    else:
        _sweep_gates(report)
    report["ok"] = all(g["ok"] for g in report["gates"].values())
    return report


def _sweep_gates(report: dict) -> None:
    from ..analysis import Severity, harness, simulated_world
    from ..utils import env as _env
    from .hvdtpu_memplan import DEFAULT_BASELINES

    models, n_findings, n_errors = {}, 0, 0
    for model, variants in harness.sweep().items():
        models[model] = {label: [f.to_dict() for f in findings]
                         for label, findings in variants.items()}
        for findings in variants.values():
            n_findings += len(findings)
            n_errors += sum(f.severity >= Severity.ERROR for f in findings)
    report["gates"]["spmd"] = {"ok": n_errors == 0,
                               "n_findings": n_findings,
                               "n_errors": n_errors, "models": models}

    baselines_path = _env.memplan_baselines_path() or DEFAULT_BASELINES
    baselines = None
    if os.path.exists(baselines_path):
        with open(baselines_path) as f:
            baselines = json.load(f).get("peaks", {})
    mem_models, n_mem = {}, 0
    for model, variants in harness.memplan_sweep(
            baselines=baselines,
            budget_bytes=_env.hbm_budget_bytes()).items():
        mem_models[model] = {
            label: {"peak_bytes": row["plan"].peak_bytes,
                    "findings": [f.to_dict() for f in row["findings"]]}
            for label, row in variants.items()
        }
        n_mem += sum(f.severity >= Severity.ERROR
                     for r in variants.values() for f in r["findings"])
    report["gates"]["memplan"] = {
        "ok": n_mem == 0 and baselines is not None,
        "n_errors": n_mem,
        "baselines": baselines_path if baselines is not None else None,
        "models": mem_models,
    }
    if baselines is None:
        report["gates"]["memplan"]["error"] = (
            f"baseline file {baselines_path} missing — regenerate with "
            "hvdtpu_memplan --write-baselines")

    cached = harness.cert_model("mlp")
    step, state, batch = harness.build_step("mlp")
    with simulated_world(harness.WORLD):
        fresh = step.certify(state, batch)  # a record of its own
    stable = fresh.digest == cached.digest
    seeded_divergent = (harness.cert_model("mlp", sharded=True).digest
                        != cached.digest)
    report["gates"]["certify"] = {
        "ok": stable and seeded_divergent,
        "stable": stable,
        "seeded_divergent": seeded_divergent,
        "models": {model: {label: cert.digest
                           for label, cert in variants.items()}
                   for model, variants in harness.cert_sweep().items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_lints")
    ap.add_argument("--json", action="store_true", help="machine output")
    ap.add_argument("--skip-sweep", action="store_true",
                    help="metric-name, runbook and thread lints only")
    args = ap.parse_args(argv)
    report = run_all(skip_sweep=args.skip_sweep)
    if args.json:
        print(json.dumps(report))
        return 0 if report["ok"] else 1
    for name, gate in report["gates"].items():
        status = ("skipped" if gate.get("skipped")
                  else ("OK" if gate["ok"] else "FAIL"))
        print(f"{name} lint: {status}")
        if gate.get("error"):
            print(f"  {gate['error']}")
        for tok in gate.get("undocumented", []):
            print(f"  undocumented {tok}")
        for row in gate.get("missing", []):
            print(f"  missing runbook row for {row}")
        for m in gate.get("multi_owned", []):
            print(f"  multi-owned {m['name']}: {', '.join(m['modules'])}")
        for f in gate.get("findings", []):
            print(f"  {f['path']}:{f['line']}: {f['rule']}: "
                  f"{f['cls']}.{f['method']}: {f['message']}")
        if name == "certify" and not gate.get("skipped"):
            if not gate["stable"]:
                print("  cert digest NOT stable across records")
            if not gate["seeded_divergent"]:
                print("  seeded-divergent build reused the digest")
            continue
        if name in ("spmd", "memplan") and not gate.get("skipped"):
            for model, variants in gate["models"].items():
                for label, entry in variants.items():
                    findings = (entry["findings"] if isinstance(entry, dict)
                                else entry)
                    for f in findings:
                        print(f"  {model}[{label}] {f['severity']}:"
                              f"{f['rule']}: {f['message']}")
    print("run_lints:", "clean" if report["ok"] else "FAILED")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
