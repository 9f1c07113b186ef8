"""hvdtpu_memplan — static per-device memory planner over the port's
model zoo.

The port of the JAX package's ``tools/hvdtpu_memplan.py``. Builds the
exact train step ``parallel.dp.make_train_step`` assembles for a
model-variant in a simulated world of ``--world`` ranks, records it under
fake tensors (nothing executes) and sweeps the record's storage lifetimes
(:mod:`horovod_tpu_torch.analysis.memory`): the per-category breakdown
(params / opt state / activations / wire / workspace) and the ZeRO-2/3
sharding projections::

    python -m horovod_tpu_torch.tools.hvdtpu_memplan --model all --sharded
    python -m horovod_tpu_torch.tools.hvdtpu_memplan --model gpt2 --sharded \\
        --remat dots_saveable --quant int8 --accum 4 --budget-gb 16 --json
    python -m horovod_tpu_torch.tools.hvdtpu_memplan --model gpt2 --explain
    python -m horovod_tpu_torch.tools.hvdtpu_memplan --write-baselines

The baselines are the port's own (``memplan_baselines.json`` beside this
file, planned on the port at ``--size tiny --world 8``); they gate the
``peak-regression`` rule. Exit status: 1 when any ERROR-severity memory
finding (``oom-risk``, ``peak-regression``) remains, else 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_BASELINES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "memplan_baselines.json")


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="hvdtpu_memplan", description=__doc__.splitlines()[0]
    )
    ap.add_argument("--model", default="all", help="model name or 'all'")
    ap.add_argument("--sharded", action="store_true",
                    help="plan the ZeRO-1 sharded weight-update build")
    ap.add_argument("--overlap", action="store_true",
                    help="plan the comm/compute overlap build")
    ap.add_argument("--accum", type=int, default=1, metavar="K",
                    help="microbatch the step into K accumulation passes")
    ap.add_argument("--quant", choices=["int8", "fp8"], default=None,
                    help="plan the quantized-wire build")
    ap.add_argument("--fused-update", action="store_true",
                    help="plan the fused ZeRO-1 optimizer-update build "
                    "(implies --sharded)")
    ap.add_argument("--remat", default=None, metavar="POLICY",
                    help="plan under a remat policy (full|dots_saveable|...)")
    ap.add_argument("--compute-dtype", choices=["fp8"], default=None,
                    help="plan the fp8 training-matmul build")
    ap.add_argument("--act-quant", choices=["int8"], default=None,
                    help="plan the int8 activation-storage build (the "
                    "backward residuals the planner prices become int8 "
                    "payload + fp32 scales)")
    ap.add_argument("--size", choices=["tiny", "small", "full"],
                    default="tiny", help="model config scale")
    ap.add_argument("--world", type=int, default=8, metavar="N",
                    help="simulated world size (default 8)")
    ap.add_argument("--budget-gb", type=float, default=None, metavar="GB",
                    help="per-device HBM budget; predicted peaks above it "
                    "fire oom-risk (default: HVDTPU_HBM_BUDGET_GB)")
    ap.add_argument("--baselines", default=None, metavar="PATH",
                    help="peak-bytes baseline JSON to gate against "
                    "(default: the port's memplan_baselines.json when it "
                    "matches --size/--world; HVDTPU_MEMPLAN_BASELINES "
                    "overrides)")
    ap.add_argument("--no-baselines", action="store_true",
                    help="skip the peak-regression gate")
    ap.add_argument("--write-baselines", nargs="?", const=DEFAULT_BASELINES,
                    default=None, metavar="PATH",
                    help="sweep the whole zoo and (re)write the baseline "
                    "JSON instead of gating")
    ap.add_argument("--explain", action="store_true",
                    help="also plan the replicated-vs-ZeRO-1 and remat-"
                    "policy counterfactuals and print the deltas")
    ap.add_argument("--json", action="store_true", help="machine output")
    return ap.parse_args(argv)


def _gb(n: int) -> str:
    # One formatter repo-wide for plan bytes: the planner's own.
    from horovod_tpu_torch.analysis.memory import _fmt_bytes

    return _fmt_bytes(n)


def _variant(args) -> dict:
    var = {}
    if args.sharded or args.fused_update:
        var["sharded"] = True
    if args.overlap:
        var["overlap"] = True
    if args.accum > 1:
        var["accum_steps"] = args.accum
    if args.quant:
        var["quant"] = args.quant
    if args.fused_update:
        var["fused_update"] = True
    if args.remat:
        var["remat"] = args.remat
    if args.compute_dtype:
        var["compute_dtype"] = args.compute_dtype
    if args.act_quant:
        var["act_quant"] = args.act_quant
    return var


def _load_baselines(args) -> tuple:
    """(mapping or None, path). Only the canonical zoo shape (tiny,
    world recorded in the file) is gated by default — a full-size or
    re-meshed run would false-positive against tiny baselines."""
    from horovod_tpu_torch.utils import env as _env

    if args.no_baselines:
        return None, ""
    path = args.baselines or _env.memplan_baselines_path() or DEFAULT_BASELINES
    if not os.path.exists(path):
        return None, path
    with open(path) as f:
        doc = json.load(f)
    if args.baselines is None and (
        doc.get("size") != args.size or doc.get("world") != args.world
    ):
        return None, path  # shape mismatch: nothing to gate against
    return doc.get("peaks", {}), path


def main(argv=None) -> int:
    args = _parse_args(argv)
    from horovod_tpu_torch.analysis import Severity, harness
    from horovod_tpu_torch.analysis import memory as _mem
    from horovod_tpu_torch.utils import env as _env

    if harness.WORLD != args.world:
        harness.WORLD = args.world  # the simulated world of every build
        harness.clear_caches()

    budget = (
        int(args.budget_gb * (1 << 30))
        if args.budget_gb is not None
        else _env.hbm_budget_bytes()
    )

    if args.write_baselines:
        rows = harness.memplan_sweep(size=args.size)
        peaks = {
            f"{m}/{label}": row["plan"].peak_bytes
            for m, variants in rows.items()
            for label, row in variants.items()
        }
        doc = {
            "tool": "hvdtpu_memplan",
            "size": args.size,
            "world": args.world,
            "peaks": peaks,
        }
        with open(args.write_baselines, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(
            f"wrote {len(peaks)} baselines to {args.write_baselines} "
            f"(size={args.size}, world={args.world})"
        )
        return 0

    baselines, baselines_path = _load_baselines(args)
    names = (
        list(harness.SWEEP_MODELS) if args.model == "all" else [args.model]
    )
    var = _variant(args)
    label = harness.variant_label(var)

    from horovod_tpu_torch.analysis import rules as _rules

    report = {
        "tool": "hvdtpu_memplan",
        "world": args.world,
        "size": args.size,
        "variant": label,
        "budget_bytes": budget,
        "baselines": baselines_path if baselines else None,
        "models": [],
    }

    n_errors = 0
    for name in names:
        try:
            plan = harness.memplan_model(name, size=args.size, **var)
        except ValueError as e:
            # e.g. --accum K that doesn't divide the per-rank batch of
            # this model's config — a usage error, not a crash.
            print(
                f"hvdtpu_memplan: cannot build {name} [{label}]: {e}",
                file=sys.stderr,
            )
            return 2
        key = f"{name}/{label}"
        findings = _rules.rule_memory(
            plan,
            budget_bytes=budget,
            baseline_bytes=(baselines or {}).get(key),
            baseline_key=key,
        )
        n_errors += sum(1 for f in findings if f.severity >= Severity.ERROR)
        row = {
            "model": name,
            "plan": plan.to_dict(),
            "projection": _mem.project_sharding(plan),
            "findings": [f.to_dict() for f in findings],
        }
        if args.explain:
            rep = harness.memplan_model(name, size=args.size)
            z1 = harness.memplan_model(name, size=args.size, sharded=True)
            remats = {
                pol: harness.memplan_model(
                    name, size=args.size, remat=pol, **{
                        k: v for k, v in var.items() if k != "remat"
                    }
                ).peak_bytes
                for pol in ("full", "dots_saveable")
            }
            row["explain"] = {
                "replicated_peak_bytes": rep.peak_bytes,
                "zero1_peak_bytes": z1.peak_bytes,
                "zero1_saving_bytes": rep.peak_bytes - z1.peak_bytes,
                "remat_peak_bytes": {
                    "none": harness.memplan_model(
                        name, size=args.size, **{
                            k: v for k, v in var.items() if k != "remat"
                        }
                    ).peak_bytes,
                    **remats,
                },
            }
        report["models"].append(row)

    report["ok"] = n_errors == 0
    if args.json:
        print(json.dumps(report))
        return 0 if report["ok"] else 1

    for row in report["models"]:
        plan = row["plan"]
        print(f"{row['model']} [{label}] world={args.world}")
        for cat in ("params", "opt_state", "activations", "wire", "workspace"):
            b = plan["breakdown"].get(cat, 0)
            pct = 100.0 * b / plan["peak_bytes"] if plan["peak_bytes"] else 0
            print(f"  {cat:<12} {_gb(b):>12}  {pct:5.1f}%")
        print(f"  {'peak':<12} {_gb(plan['peak_bytes']):>12}  (donation saves "
              f"{_gb(plan['donation_saved_bytes'])})")
        proj = row["projection"]
        print(
            f"  projection@{proj['world']}: ZeRO-1 "
            f"{_gb(proj['zero1_peak_bytes'])} -> ZeRO-2 "
            f"{_gb(proj['zero2_peak_bytes'])} -> ZeRO-3 "
            f"{_gb(proj['zero3_peak_bytes'])}"
        )
        if "explain" in row:
            ex = row["explain"]
            print(
                f"  explain: replicated {_gb(ex['replicated_peak_bytes'])} "
                f"vs ZeRO-1 {_gb(ex['zero1_peak_bytes'])} "
                f"(saves {_gb(ex['zero1_saving_bytes'])}); remat peaks "
                + ", ".join(
                    f"{k}={_gb(v)}" for k, v in ex["remat_peak_bytes"].items()
                )
            )
        if budget:
            used = 100.0 * plan["peak_bytes"] / budget
            print(f"  budget: {used:.1f}% of {_gb(budget)}")
        for f in row["findings"]:
            print(f"  {f['severity']}:{f['rule']}: {f['message']}")
    print(
        "hvdtpu_memplan:",
        "clean" if report["ok"] else f"{n_errors} ERROR finding(s)",
    )
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
