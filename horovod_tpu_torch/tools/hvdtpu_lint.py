"""hvdtpu_lint — trace-time SPMD linter over the port's model zoo.

The port of the JAX package's ``tools/hvdtpu_lint.py``. Builds the exact
train step ``parallel.dp.make_train_step`` assembles for a model
(replicated or ZeRO-1 sharded, with or without the overlap pipeline) in a
simulated world of 8 ranks and runs the static rule passes of
:mod:`horovod_tpu_torch.analysis` over a fake-tensor record of it:
collective consistency, fusion parity against the bucket policy,
precision, memory. **Nothing executes and no process group exists**, so
every invariant that would otherwise surface as a hang on a world of
cards is checked in seconds on any CPU::

    python -m horovod_tpu_torch.tools.hvdtpu_lint --model gpt2 --sharded
    python -m horovod_tpu_torch.tools.hvdtpu_lint --model all --json
    python -m horovod_tpu_torch.tools.hvdtpu_lint --model bert --parity
    python -m horovod_tpu_torch.tools.hvdtpu_lint --model gpt2 \\
        --compare-accum 4

Exit status: 1 when any finding at or above ``--fail-on`` (default
ERROR) survives the allowlist, else 0.
"""

from __future__ import annotations

import argparse
import json
import sys


def _run_model(name: str, args) -> dict:
    from horovod_tpu_torch.analysis import harness

    variants = []
    findings = harness.lint_model(
        name,
        sharded=args.sharded or args.fused_update,
        overlap=args.overlap,
        accum_steps=args.accum,
        size=args.size,
        allowlist=args.allow,
        quant=args.quant or "",
        fused_update=args.fused_update,
        remat=args.remat or "",
        compute_dtype=args.compute_dtype or "",
        act_quant=args.act_quant or "",
    )
    variants.append(
        {
            "variant": (
                (
                    "sharded"
                    if args.sharded or args.fused_update
                    else "replicated"
                )
                + ("+overlap" if args.overlap else "")
                + (f"@k{args.accum}" if args.accum > 1 else "")
                + (f"+quant-{args.quant}" if args.quant else "")
                + ("+fused-update" if args.fused_update else "")
                + (f"+remat-{args.remat}" if args.remat else "")
                + (f"+{args.compute_dtype}" if args.compute_dtype else "")
                + (
                    f"+act-quant-{args.act_quant}"
                    if args.act_quant
                    else ""
                )
            ),
            "findings": [f.to_dict() for f in findings],
        }
    )
    from horovod_tpu_torch.analysis import apply_allowlist

    if args.parity:
        parity = apply_allowlist(
            harness.lint_parity(name, size=args.size), args.allow
        )
        variants.append(
            {
                "variant": "replicated-vs-sharded parity",
                "findings": [f.to_dict() for f in parity],
            }
        )
    if args.compare_accum > 1:
        from horovod_tpu_torch.analysis import (compare_collectives,
                                                simulated_world)

        steps = {}
        for k in (1, args.compare_accum):
            step, state, batch = harness.build_step(
                name, size=args.size, sharded=args.sharded, accum_steps=k)
            steps[k] = (step._program, (state, batch))
        with simulated_world(harness.WORLD):
            cmp = apply_allowlist(
                compare_collectives(
                    *steps[1],
                    *steps[args.compare_accum],
                    label_a="accum_steps=1",
                    label_b=f"accum_steps={args.compare_accum}",
                ),
                args.allow,
            )
        variants.append(
            {
                "variant": f"accum 1 vs {args.compare_accum} order",
                "findings": [f.to_dict() for f in cmp],
            }
        )
    return {"model": name, "results": variants}


def main(argv=None) -> int:
    from horovod_tpu_torch.analysis import harness

    ap = argparse.ArgumentParser(
        prog="hvdtpu_lint", description=__doc__.splitlines()[0]
    )
    ap.add_argument(
        "--model",
        default="all",
        choices=["all"] + sorted(harness.BUILDERS),
        help="model to lint (default: the whole zoo)",
    )
    ap.add_argument(
        "--sharded",
        action="store_true",
        help="lint the ZeRO-1 sharded weight-update build",
    )
    ap.add_argument(
        "--overlap",
        action="store_true",
        help="lint the comm/compute overlap build (staggered buckets)",
    )
    ap.add_argument(
        "--accum",
        type=int,
        default=1,
        metavar="K",
        help="microbatch the step into K gradient-accumulation passes",
    )
    ap.add_argument(
        "--quant",
        choices=["int8", "fp8"],
        default=None,
        help="lint the quantized-wire build (blockwise int8/fp8 "
        "collectives with the quant fusion-parity prediction)",
    )
    ap.add_argument(
        "--fused-update",
        action="store_true",
        help="lint the fused ZeRO-1 optimizer-update build (implies "
        "--sharded and the fused_adamw inner optimizer)",
    )
    ap.add_argument(
        "--remat",
        default=None,
        metavar="POLICY",
        help="lint the step under a remat policy (full|dots_saveable|...)",
    )
    ap.add_argument(
        "--compute-dtype",
        choices=["fp8"],
        default=None,
        help="lint the fp8 training-matmul build (the transformer "
        "family inits fp8 scale state; exercises the "
        "low-precision-unverified rule)",
    )
    ap.add_argument(
        "--act-quant",
        choices=["int8"],
        default=None,
        help="lint the int8 activation-storage build (exercises the "
        "act-quant-unconsumed rule on models without boundaries)",
    )
    ap.add_argument(
        "--parity",
        action="store_true",
        help="also run the static replicated-vs-sharded byte-parity check",
    )
    ap.add_argument(
        "--compare-accum",
        type=int,
        default=0,
        metavar="K",
        help="also compare collective order between accum_steps=1 and K "
        "(co-executability / static deadlock check)",
    )
    ap.add_argument(
        "--size",
        choices=["tiny", "small", "full"],
        default="tiny",
        help="model config scale (invariants are size-independent; "
        "'small' (= 'full') records the benchmark shapes)",
    )
    ap.add_argument(
        "--allow",
        action="append",
        default=[],
        metavar="RULE[:FRAG]",
        help="allowlist entry (repeatable): rule id, optionally "
        "':substring' matched against provenance/message",
    )
    ap.add_argument(
        "--fail-on",
        choices=["info", "warning", "error"],
        default="error",
        help="exit 1 when findings at/above this severity remain",
    )
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    from horovod_tpu_torch.analysis import Severity

    names = (
        list(harness.SWEEP_MODELS) if args.model == "all" else [args.model]
    )
    rows = [_run_model(n, args) for n in names]

    gate = {
        "info": Severity.INFO,
        "warning": Severity.WARNING,
        "error": Severity.ERROR,
    }[args.fail_on]
    n_findings = 0
    n_failing = 0
    for row in rows:
        for variant in row["results"]:
            n_findings += len(variant["findings"])
            n_failing += sum(
                1
                for f in variant["findings"]
                if Severity[f["severity"]] >= gate
            )

    if args.json:
        print(
            json.dumps(
                {
                    "tool": "hvdtpu_lint",
                    "fail_on": args.fail_on,
                    "n_findings": n_findings,
                    "n_failing": n_failing,
                    "models": rows,
                }
            )
        )
    else:
        for row in rows:
            for variant in row["results"]:
                tag = f"{row['model']} [{variant['variant']}]"
                if not variant["findings"]:
                    print(f"{tag}: clean")
                    continue
                print(f"{tag}: {len(variant['findings'])} finding(s)")
                for f in variant["findings"]:
                    loc = (
                        f" [{f['provenance']}]" if f["provenance"] else ""
                    )
                    print(
                        f"  {f['severity']}:{f['rule']}: "
                        f"{f['message']}{loc}"
                    )
        print(
            f"hvdtpu_lint: {n_findings} finding(s), "
            f"{n_failing} at/above {args.fail_on}"
        )
    return 1 if n_failing else 0


if __name__ == "__main__":
    sys.exit(main())
