"""The port's lint tools (``horovod_tpu_torch/tools``): the CLIs over the
analysis plane (``hvdtpu_lint``, ``hvdtpu_memplan``, ``hvdtpu_verify``),
the ``run_lints`` umbrella, the thread lint pointed at the port's threaded
planes, and the metric-name lint's new names.

The thread lint is the JAX package's ``tools/hvdtpu_threadlint.py``
copied: on the same seeded sources both give the same findings, and on
the port's control plane (its reviewed pragmas in place) it is clean.
"""

import json
import textwrap

import pytest

import tools.hvdtpu_threadlint as jtl
from horovod_tpu_torch.tools import check_metric_names as cm
from horovod_tpu_torch.tools import hvdtpu_lint, hvdtpu_memplan
from horovod_tpu_torch.tools import hvdtpu_threadlint as ttl
from horovod_tpu_torch.tools import hvdtpu_verify, run_lints

SEEDED = """
    import threading

    class Broken:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0
            self._state = "idle"

        def poke(self):
            self._count += 1

        def setup(self):
            self._state = "up"  # threadlint: allow[unlocked-attr-write] pre-thread

        def _drain_locked(self):
            self._state = "drained"

        def run(self):
            self._drain_locked()


    class JournalA:
        def __init__(self):
            self._lock = threading.Lock()

        def record(self, item):
            with self._lock:
                self.peer.mirror(item)


    class MirrorB:
        def __init__(self):
            self._lock = threading.Lock()

        def mirror(self, item):
            with self._lock:
                return item

        def rollup(self):
            with self._lock:
                self.journal.record(None)
"""


def _key(findings):
    return sorted((f.rule, f.cls, f.method, f.message) for f in findings)


def test_threadlint_matches_the_reference_on_seeded_sources(tmp_path):
    (tmp_path / "mod.py").write_text(textwrap.dedent(SEEDED))
    port = ttl.scan_paths([str(tmp_path)], repo=str(tmp_path))
    ref = jtl.scan_paths([str(tmp_path)], repo=str(tmp_path))
    assert _key(port) == _key(ref)
    assert {f.rule for f in port} == set(ttl.RULES)
    assert not any(f.method == "setup" for f in port)  # the pragma


def test_threadlint_is_clean_on_the_ports_control_plane():
    assert ttl.DEFAULT_PATHS == tuple(
        p.replace("horovod_tpu/", "horovod_tpu_torch/")
        for p in jtl.DEFAULT_PATHS)
    assert ttl.scan_paths(ttl.DEFAULT_PATHS) == []
    assert ttl.main(["--json"]) == 0


def test_metric_lint_knows_the_analysis_planes_names():
    scanned = cm.scan()
    # The owner: the one module that writes the name (or, where no write
    # chains onto the accessor, the one that holds it).
    owners = {
        name: {loc.rsplit(":", 1)[0] for loc in (
            scanned[name]["writers"] or scanned[name]["readers"])}
        for name in ("memplan.peak_bytes", "cert.mismatch")
    }
    assert owners == {
        "memplan.peak_bytes": {"horovod_tpu_torch/analysis/__init__.py"},
        "cert.mismatch": {"horovod_tpu_torch/analysis/certify.py"},
    }
    assert cm.check_ownership(scanned) == []
    assert cm.check_docs(scanned) == []


def test_lint_cli_json(capsys):
    rc = hvdtpu_lint.main(["--model", "gpt2", "--sharded", "--parity",
                           "--compare-accum", "2", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["n_failing"] == 0
    variants = [r["variant"] for r in out["models"][0]["results"]]
    assert variants == ["sharded", "replicated-vs-sharded parity",
                        "accum 1 vs 2 order"]


def test_lint_cli_gates_on_fail_on(capsys):
    # The replicated MLP's AdamW replaces its moments: WARNINGs, which
    # fail the gate at --fail-on warning and are allowlisted by id.
    assert hvdtpu_lint.main(["--model", "mlp"]) == 0
    assert hvdtpu_lint.main(["--model", "mlp", "--fail-on", "warning"]) == 1
    assert "WARNING:donation-missed-reuse" in capsys.readouterr().out
    assert hvdtpu_lint.main(["--model", "mlp", "--fail-on", "warning",
                             "--allow", "donation-missed-reuse"]) == 0


def test_memplan_cli_json(capsys):
    rc = hvdtpu_memplan.main(["--model", "gpt2", "--sharded", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["ok"] and out["world"] == 8
    row = out["models"][0]
    assert row["plan"]["params_bytes"] == 432128
    assert row["projection"]["zero1_peak_bytes"] == row["plan"]["peak_bytes"]
    assert out["baselines"] == hvdtpu_memplan.DEFAULT_BASELINES


def test_memplan_cli_budget_gate(capsys):
    rc = hvdtpu_memplan.main(["--model", "gpt2", "--sharded",
                              "--budget-gb", "0.0001"])
    assert rc == 1 and "ERROR:oom-risk" in capsys.readouterr().out


def test_verify_cli(capsys):
    rc = hvdtpu_verify.main(["--model", "gpt2", "--stability", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["ok"]
    rows = {r["variant"]: r for r in out["results"]}
    assert all(r["stable"] for r in rows.values())
    assert rows["sharded"]["n_collectives"] == 3
    rc = hvdtpu_verify.main(["--model", "gpt2", "--diff", "replicated",
                             "sharded", "--json"])
    diff = json.loads(capsys.readouterr().out)["diff"]
    assert rc == 1 and diff["first_divergent_index"] == 0


@pytest.mark.parametrize("skip_sweep", [True, False])
def test_run_lints_gate(skip_sweep):
    report = run_lints.run_all(skip_sweep=skip_sweep)
    assert report["ok"], {k: v for k, v in report["gates"].items()
                          if not v["ok"]}
    assert set(report["gates"]) == {"metric-names", "goodput-runbook",
                                    "thread", "spmd", "memplan", "certify"}
    if not skip_sweep:
        assert report["gates"]["certify"]["stable"]
        assert report["gates"]["certify"]["seeded_divergent"]
        assert report["gates"]["spmd"]["n_errors"] == 0
