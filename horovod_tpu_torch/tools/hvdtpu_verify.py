"""hvdtpu_verify — collective-schedule certification over the port's
model zoo.

The port of the JAX package's ``tools/hvdtpu_verify.py``. Builds each
model exactly as ``parallel.dp.make_train_step`` would, in a simulated
world of 8 ranks, and prints the
:class:`~horovod_tpu_torch.analysis.certify.ScheduleCert` digest of every
build from a fake-tensor record of it: the canonical fingerprint of the
collective schedule (op kind, axes, wire dtype/bytes, reduce semantics,
frame kinds) that the cross-rank preflight gate compares at job start.
**Nothing executes**, so a "which rank built a different program?"
investigation runs in seconds on any CPU::

    python -m horovod_tpu_torch.tools.hvdtpu_verify --model all
    python -m horovod_tpu_torch.tools.hvdtpu_verify --model gpt2 --stability
    python -m horovod_tpu_torch.tools.hvdtpu_verify --model gpt2 \\
        --diff replicated replicated+fp8
    python -m horovod_tpu_torch.tools.hvdtpu_verify --model all --json

Run it on two hosts with each host's build flags and compare digests; on a
mismatch, ``--diff`` against the suspect variant prints the first
divergent schedule index and both entries. Exit status: 1 on any record
failure, instability (``--stability``) or divergence (``--diff``), else 0.
"""

from __future__ import annotations

import argparse
import json
import sys


def run_verify(models, *, size: str = "tiny", stability: bool = False):
    """Certify every model under every sweep variant.

    Returns ``(rows, ok)``: one row per (model, variant) with the
    digest, collective count, world size and — under ``stability`` —
    whether an independent record of the same build reproduced the
    digest. Importable: ``run_lints``'s certify gate and the tests call
    this instead of shelling out.
    """
    from horovod_tpu_torch.analysis import harness, simulated_world

    rows = []
    ok = True
    for name in models:
        for var in harness.SWEEP_VARIANTS:
            label = harness.variant_label(var)
            row = {"model": name, "variant": label}
            try:
                cert = harness.cert_model(name, size=size, **var)
            except Exception as e:  # noqa: BLE001 - a failed build is a row
                row["error"] = f"{type(e).__name__}: {e}"
                ok = False
                rows.append(row)
                continue
            row.update(
                digest=cert.digest,
                n_collectives=cert.n_collectives,
                world=cert.world,
            )
            if stability:
                # A fresh record of the SAME build (bypasses the record
                # cache): the fingerprint must be a function of the
                # program, not of record-session accidents.
                step, state, batch = harness.build_step(name, size=size,
                                                        **var)
                with simulated_world(harness.WORLD):
                    fresh = step.certify(state, batch)
                row["stable"] = fresh.digest == cert.digest
                if not row["stable"]:
                    ok = False
            rows.append(row)
    return rows, ok


def run_diff(model: str, label_a: str, label_b: str, *, size: str = "tiny"):
    """Diff the certs of two variant labels of one model; returns the
    :func:`~horovod_tpu_torch.analysis.certify.diff_certs` report (None when
    the schedules are identical)."""
    from horovod_tpu_torch.analysis import diff_certs, harness

    by_label = {
        harness.variant_label(v): v for v in harness.SWEEP_VARIANTS
    }
    certs = {}
    for label in (label_a, label_b):
        if label not in by_label:
            raise SystemExit(
                f"unknown variant label {label!r}; choose from "
                f"{sorted(by_label)}"
            )
        certs[label] = harness.cert_model(model, size=size, **by_label[label])
    return diff_certs(certs[label_a], certs[label_b])


def main(argv=None) -> int:
    from horovod_tpu_torch.analysis import harness

    ap = argparse.ArgumentParser(
        prog="hvdtpu_verify", description=__doc__.splitlines()[0]
    )
    ap.add_argument(
        "--model",
        default="all",
        choices=["all"] + sorted(harness.BUILDERS),
        help="model to certify (default: the whole zoo)",
    )
    ap.add_argument(
        "--size",
        choices=["tiny", "small", "full"],
        default="tiny",
        help="model config scale (the schedule shape is what's "
        "certified; 'small' (= 'full') records the benchmark shapes)",
    )
    ap.add_argument(
        "--stability",
        action="store_true",
        help="re-trace each build independently and fail unless the "
        "digest reproduces (catches non-canonical fingerprints)",
    )
    ap.add_argument(
        "--diff",
        nargs=2,
        metavar=("LABEL_A", "LABEL_B"),
        default=None,
        help="diff the certs of two sweep-variant labels of --model "
        "(e.g. 'replicated' 'replicated+fp8'); prints the first "
        "divergent schedule index and both entries",
    )
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    names = (
        list(harness.SWEEP_MODELS) if args.model == "all" else [args.model]
    )

    if args.diff is not None:
        if args.model == "all":
            raise SystemExit("--diff needs a single --model")
        report = run_diff(
            args.model, args.diff[0], args.diff[1], size=args.size
        )
        if args.json:
            print(json.dumps({"tool": "hvdtpu_verify", "diff": report}))
        elif report is None:
            print(f"{args.model}: schedules identical")
        else:
            print(f"{args.model}: schedules DIVERGE — {report['reason']}")
            for k in ("first_divergent_index", "a_entry", "b_entry",
                      "extra_entry"):
                if k in report:
                    print(f"  {k}: {json.dumps(report[k])}")
        return 0 if report is None else 1

    rows, ok = run_verify(names, size=args.size, stability=args.stability)
    if args.json:
        print(
            json.dumps(
                {"tool": "hvdtpu_verify", "ok": ok, "results": rows}
            )
        )
    else:
        for row in rows:
            tag = f"{row['model']} [{row['variant']}]"
            if "error" in row:
                print(f"{tag}: ERROR {row['error']}")
                continue
            extra = ""
            if args.stability:
                extra = " stable" if row["stable"] else " UNSTABLE"
            print(
                f"{tag}: {row['digest'][:16]} "
                f"({row['n_collectives']} collectives, "
                f"world={row['world']}){extra}"
            )
        print(f"hvdtpu_verify: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
