"""Lint: every metric name emitted under the obs plane has exactly one
owning module and appears in ``docs/api.md``.

The port of the JAX package's ``tools/check_metric_names.py``, run over
``horovod_tpu_torch/``: the port emits the reference's names, so the
reference's metric index (``docs/api.md``) and triage rows
(``docs/runbook.md``) document it too.

The metric-name twin of ``tools/check_env_vars.py``: names are a public
surface — ``hvdtpu_top`` parses them, Prometheus scrapes them, the
autotuner scores off them — so a name that drifts (two modules emitting
the same series, or a series the docs never mention) silently corrupts
dashboards and tooling. Two rules:

* **ownership** (:func:`check_ownership`) — for each name, the modules
  that *write* it (an instrument accessor chained straight into
  ``.inc``/``.set``/``.add``/``.observe``, or a ``remove_gauge``) must
  be exactly one. Bare accessors (``metrics().histogram("x")`` held in
  a variable) are *readers-or-holders*: they don't claim ownership when
  a writer exists elsewhere, but a name with no writer anywhere must
  still live in a single module.
* **docs** (:func:`check_docs`) — every emitted name must appear in
  ``docs/api.md`` (the metric index). Dynamic per-entity names
  (f-strings) are normalized to ``prefix.<*>`` and matched by their
  literal prefix, so ``stall.age_s.<tensor>`` in the docs covers
  ``f"stall.age_s.{name}"`` in the source.

The scan is pure AST over ``horovod_tpu_torch/`` (no imports of the
linted code) for calls ``<expr>.counter/gauge/histogram/remove_gauge(<str>)``;
``self.``-receiver calls (the registry's own definitions) are excluded. It
covers the autotuner's ``autotune.*`` names (owner ``obs/tune.py``, the
per-knob ``autotune.candidate.<*>`` matched by its prefix) and the weight
stream's ``stream.*`` (owner ``obs/stream.py``).
Runnable standalone::

    python -m horovod_tpu_torch.tools.check_metric_names
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCAN_DIR = "horovod_tpu_torch"
ACCESSORS = ("counter", "gauge", "histogram")
MUTATORS = ("inc", "set", "add", "observe")


def _literal_name(node: ast.AST) -> str:
    """The metric-name argument as a normalized string: plain literals
    verbatim, f-strings with every formatted hole as ``<*>``; '' when
    the argument is not a (partial) literal at all."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        return "".join(
            str(v.value) if isinstance(v, ast.Constant) else "<*>"
            for v in node.values
        )
    return ""


def scan() -> Dict[str, Dict[str, List[str]]]:
    """name -> {"writers": ["path:line", ...], "readers": [...]}."""
    out: Dict[str, Dict[str, List[str]]] = {}
    for root, _, files in os.walk(os.path.join(REPO, SCAN_DIR)):
        if "__pycache__" in root:
            continue
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            rel = os.path.relpath(path, REPO)
            try:
                tree = ast.parse(open(path, encoding="utf-8").read())
            except (OSError, SyntaxError):
                continue
            for node in ast.walk(tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.args
                ):
                    continue
                attr = node.func.attr
                recv = node.func.value
                # The registry's own method bodies (self.counter(...))
                # define the accessors; they are not emission sites.
                if isinstance(recv, ast.Name) and recv.id == "self":
                    continue
                if attr == "remove_gauge":
                    name, kind = _literal_name(node.args[0]), "writers"
                elif attr in MUTATORS and (
                    isinstance(recv, ast.Call)
                    and isinstance(recv.func, ast.Attribute)
                    and recv.func.attr in ACCESSORS
                    and recv.args
                ):
                    # Chained write: metrics().gauge("x").set(...)
                    name, kind = _literal_name(recv.args[0]), "writers"
                elif attr in ACCESSORS:
                    # Bare accessor: a held instrument or a reader.
                    name, kind = _literal_name(node.args[0]), "readers"
                else:
                    continue
                if not name:
                    continue
                rec = out.setdefault(name, {"writers": [], "readers": []})
                rec[kind].append(f"{rel}:{node.lineno}")
    return out


def _modules(locs: List[str]) -> List[str]:
    return sorted({loc.rsplit(":", 1)[0] for loc in locs})


def check_ownership(
    scanned: Optional[Dict[str, Dict[str, List[str]]]] = None,
) -> List[Tuple[str, List[str]]]:
    """Names owned by more than one module, as (name, modules) pairs.
    ``scanned`` reuses a caller-held :func:`scan` result (the lint gate
    runs both checks off one AST sweep)."""
    bad = []
    for name, rec in sorted((scanned or scan()).items()):
        writers = _modules(rec["writers"])
        if len(writers) > 1:
            bad.append((name, writers))
        elif not writers:
            # No chained write anywhere: the holder modules are the
            # owners (held-instrument pattern) — still exactly one.
            holders = _modules(rec["readers"])
            if len(holders) > 1:
                bad.append((name, holders))
    return bad


def check_docs(
    scanned: Optional[Dict[str, Dict[str, List[str]]]] = None,
) -> List[str]:
    """Emitted names missing from ``docs/api.md``. A dynamic name
    matches by its literal prefix (``eager.<*>.ms`` → ``eager.``)."""
    text = open(
        os.path.join(REPO, "docs", "api.md"), encoding="utf-8"
    ).read()
    missing = []
    for name in sorted(scanned or scan()):
        needle = name.split("<*>")[0].rstrip(".") or name
        if needle not in text:
            missing.append(name)
    return missing


def check_goodput_runbook() -> List[str]:
    """Goodput categories whose triage row is missing from
    ``docs/runbook.md``.

    The goodput report ends every downtime cause with a runbook link
    (``tools/hvdtpu_goodput.py``), so a category without a triage row is
    a dead link in the remediation path. The category list and row
    titles are lifted from ``horovod_tpu_torch/obs/goodput.py`` by AST (no
    import of the linted code, same discipline as :func:`scan`)."""
    path = os.path.join(REPO, SCAN_DIR, "obs", "goodput.py")
    try:
        tree = ast.parse(open(path, encoding="utf-8").read())
    except (OSError, SyntaxError):
        return [f"<{SCAN_DIR}/obs/goodput.py unparseable>"]
    rows: Dict[str, str] = {}
    for node in ast.walk(tree):
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if not (isinstance(target, ast.Name)
                and target.id == "RUNBOOK_ROWS"
                and node.value is not None):
            continue
        try:
            rows = dict(ast.literal_eval(node.value))
        except (ValueError, SyntaxError):
            return ["<RUNBOOK_ROWS is not a literal dict>"]
    if not rows:
        return ["<RUNBOOK_ROWS not found in goodput.py>"]
    text = open(
        os.path.join(REPO, "docs", "runbook.md"), encoding="utf-8"
    ).read()
    return sorted(
        f"{cat} (needs runbook row {row!r})"
        for cat, row in rows.items()
        if row not in text
    )


def main() -> int:
    rc = 0
    scanned = scan()  # ONE AST sweep feeds both checks and the tally
    owned = check_ownership(scanned)
    if owned:
        rc = 1
        print(
            "metric names with multiple owning modules (route the emit "
            "through one obs helper):",
            file=sys.stderr,
        )
        for name, modules in owned:
            print(f"  {name}: {', '.join(modules)}", file=sys.stderr)
    undoc = check_docs(scanned)
    if undoc:
        rc = 1
        print(
            "emitted metric names missing from docs/api.md (add to the "
            "metric index):",
            file=sys.stderr,
        )
        for name in undoc:
            print(f"  {name}", file=sys.stderr)
    norow = check_goodput_runbook()
    if norow:
        rc = 1
        print(
            "goodput categories without a docs/runbook.md triage row:",
            file=sys.stderr,
        )
        for entry in norow:
            print(f"  {entry}", file=sys.stderr)
    if rc == 0:
        print(
            f"metric-name lint OK: {len(scanned)} names, single-owner, "
            "all documented, runbook-linked"
        )
    return rc


if __name__ == "__main__":
    sys.exit(main())
