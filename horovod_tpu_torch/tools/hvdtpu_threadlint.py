"""hvdtpu_threadlint — AST lock-discipline lint for the threaded control
plane.

The ServeFuture double-settle and the Timeline::MarkCycle races were the
same bug shape: a class that OWNS a lock mutating its shared state on a
path that never takes it. Both were found late (chaos soak, TSAN). This
lint finds the shape statically, at AST level, with zero imports of the
linted code — the Python twin of ``csrc``'s TSAN tier:

* ``unlocked-attr-write`` — a class that creates a ``threading.Lock``/
  ``RLock``/``Condition`` on ``self`` writes a ``self._``-prefixed
  attribute from a method that never enters any of the class's lock
  contexts (``with self._lock:`` / ``self._lock.acquire()``).
  ``__init__`` (single-threaded construction) and ``_locked``-suffixed
  methods (documented lock-held helpers, checked by the second rule)
  are exempt, as are writes of the lock attributes themselves.
* ``locked-call-outside-lock`` — a ``self.<name>_locked(...)`` call
  lexically outside every ``with self.<lock>`` block, from a method not
  itself ``_locked``-suffixed: the naming contract says the callee
  assumes the lock is held.
* ``lock-order-cycle`` — a cycle in the cross-class lock-acquisition-
  order graph, the static signature of an ABBA deadlock. Edges come
  from (a) lexical ``with`` nesting (holding ``A._x`` while entering
  ``A._y``) and (b) calls made while a lock is held, resolved by method
  name across every scanned class (holding ``A._lock`` and calling
  ``handle()`` links to every lock a scanned ``handle`` method
  acquires — callbacks registered under another class's lock included,
  since nested defs are scanned as first-class methods under their own
  names). A cycle among distinct locks means two threads can acquire
  them in opposite orders and deadlock; the finding names the full
  cycle path.

Locks reached through simple local aliases (``lk = self._lock``,
``with lk:``) and ``threading.Condition(self._lock)`` wrappers are
resolved to their underlying lock attribute, so both the order graph
and ``unlocked-attr-write`` see them (a ``with self._cv:`` nested in
``with self._lock:`` is the *same* lock, not an ordering edge).

Suppression is per line, in the source, where a reviewer can see the
justification::

    self._mode = mode  # threadlint: allow[unlocked-attr-write] set before threads start

The port's copy of the JAX package's ``tools/hvdtpu_threadlint.py``,
pointed at ``horovod_tpu_torch/``. Wired into the port's ``run_lints``
(the ``thread`` gate over ``serve/``, ``runner/``, ``obs/``,
``elastic/``, ``utils/``, ``tune/``, the reference's set) and
``tests/test_torch_port_lint_tools.py``::

    python -m horovod_tpu_torch.tools.hvdtpu_threadlint [--json] [paths...]

Exit status 1 when findings remain, else 0.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Set

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The threaded control plane: every package that spawns or services
# threads. Single-threaded trees (models, ops, parallel) are out of
# scope by design — a class without a lock makes no thread-safety claim.
DEFAULT_PATHS = (
    # serve/ includes the token-level decode engine (serve/engine.py —
    # worker threads over shared stream books) and the paged KV pool
    # (serve/kvcache.py — worker-confined by contract, so lock-free by
    # design: a class without a lock makes no thread-safety claim).
    "horovod_tpu_torch/serve",
    "horovod_tpu_torch/runner",
    "horovod_tpu_torch/obs",
    "horovod_tpu_torch/elastic",
    "horovod_tpu_torch/utils",
    # The autotuner runs a driver-side coordinator inside the elastic
    # poll loop and a pool-owned serve-tuner thread against locked
    # gauge state — squarely in scope.
    "horovod_tpu_torch/tune",
)

RULES = (
    "unlocked-attr-write",
    "locked-call-outside-lock",
    "lock-order-cycle",
)

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
# Callee names excluded from the order graph's name-based call edges:
# methods of builtin containers and the threading/queue primitives. A
# ``self._pending.append(...)`` under a lock is a list append, not a
# call into the scanned class that happens to own an ``append`` method —
# matching those would wire every list mutation into the graph.
_UNTRACKED_CALLEES = frozenset(
    name
    for t in (list, dict, set, frozenset, tuple, str, bytes)
    for name in dir(t)
) | {
    "acquire", "release", "wait", "wait_for", "notify", "notify_all",
    "locked", "set", "is_set", "clear", "get", "put", "get_nowait",
    "put_nowait", "task_done", "qsize", "empty", "full", "start",
    "is_alive", "cancel", "flush", "close", "write", "read", "popleft",
    "appendleft", "result", "done", "add_done_callback",
}
_PRAGMA = re.compile(r"#\s*threadlint:\s*allow\[([a-z-]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    cls: str
    method: str
    message: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule}: "
            f"{self.cls}.{self.method}: {self.message}"
        )


def _is_lock_factory(node: ast.expr) -> bool:
    """``threading.Lock()`` / ``Lock()`` / ``threading.Condition(...)``."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in _LOCK_FACTORIES
    if isinstance(fn, ast.Name):
        return fn.id in _LOCK_FACTORIES
    return False


def _self_attr(node: ast.expr) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attribute names assigned a lock factory anywhere in the class."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr:
                    locks.add(attr)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if _is_lock_factory(node.value):
                attr = _self_attr(node.target)
                if attr:
                    locks.add(attr)
    return locks


def _lock_wraps(cls: ast.ClassDef) -> Dict[str, str]:
    """``self._cv = threading.Condition(self._lock)`` makes ``_cv`` an
    alias of ``_lock`` (the Condition *holds* that lock) — map the
    wrapper attr to the wrapped one so lock identity resolves through
    it."""
    wraps: Dict[str, str] = {}
    for node in ast.walk(cls):
        targets = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if not (value is not None and _is_lock_factory(value) and value.args):
            continue
        inner = _self_attr(value.args[0])
        if inner is None:
            continue
        for tgt in targets:
            attr = _self_attr(tgt)
            if attr:
                wraps[attr] = inner
    return wraps


class _MethodScanner(ast.NodeVisitor):
    """Walk one method tracking whether the class's lock is lexically
    held (``with self.<lock>:`` nesting, ``self.<lock>.acquire()``
    balance), which locks nest inside which (the order graph's direct
    edges) and what is called while a lock is held (the graph's
    cross-class edges). Simple local aliases (``lk = self._lock``) and
    Condition wrappers resolve to the underlying lock attribute."""

    def __init__(self, locks: Set[str], wraps: Optional[Dict[str, str]] = None):
        self.locks = locks
        self.wraps = wraps or {}
        self.depth = 0
        self.ever_entered = False
        self.attr_writes: List = []  # (stmt, attr) writes while depth == 0
        self.locked_calls: List[ast.Call] = []  # *_locked() while depth == 0
        self.aliases: Dict[str, str] = {}  # local name -> lock attr
        self.held: List[str] = []  # resolved lock attrs currently held
        # (outer_attr, inner_attr, with-node) lexical nesting edges
        self.order_edges: List = []
        self.acquired: Set[str] = set()  # resolved attrs acquired anywhere
        # (held_attr, callee_name, call-node) calls under a held lock
        self.calls_under: List = []

    # -- lock tracking ---------------------------------------------------

    def _resolve(self, attr: str) -> str:
        """Condition-wrapper identity: ``_cv`` IS ``_lock``."""
        seen = set()
        while attr in self.wraps and attr not in seen:
            seen.add(attr)
            attr = self.wraps[attr]
        return attr

    def _lock_attr_of(self, ctx: ast.expr) -> Optional[str]:
        """The (unresolved) lock attr a with-item context acquires, or
        None when it is not one of the class's locks."""
        attr = _self_attr(ctx)
        if attr in self.locks:
            return attr
        # with lk: via a simple local alias of a lock attribute.
        if isinstance(ctx, ast.Name) and ctx.id in self.aliases:
            return self.aliases[ctx.id]
        # with self._lock.acquire_timeout(...) style wrappers count when
        # the receiver is a lock attr (or an alias of one).
        if isinstance(ctx, ast.Call):
            recv = ctx.func
            if isinstance(recv, ast.Attribute):
                rattr = _self_attr(recv.value)
                if rattr in self.locks:
                    return rattr
                if (
                    isinstance(recv.value, ast.Name)
                    and recv.value.id in self.aliases
                ):
                    return self.aliases[recv.value.id]
        return None

    def visit_With(self, node: ast.With) -> None:
        entered: List[str] = []
        for item in node.items:
            attr = self._lock_attr_of(item.context_expr)
            if attr is None:
                continue
            resolved = self._resolve(attr)
            self.acquired.add(resolved)
            # Ordering edges: every lock already held (including earlier
            # items of this same with-statement) precedes this one.
            for outer in self.held:
                if outer != resolved:
                    self.order_edges.append((outer, resolved, node))
            self.held.append(resolved)
            entered.append(resolved)
        if entered:
            self.ever_entered = True
        self.depth += len(entered)
        self.generic_visit(node)
        self.depth -= len(entered)
        del self.held[len(self.held) - len(entered):]

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        recv_lock = None
        if isinstance(fn, ast.Attribute):
            rattr = _self_attr(fn.value)
            if rattr in self.locks:
                recv_lock = rattr
            elif (
                isinstance(fn.value, ast.Name)
                and fn.value.id in self.aliases
            ):
                recv_lock = self.aliases[fn.value.id]
            if recv_lock is not None and fn.attr in ("acquire", "__enter__"):
                # .acquire() without a with-statement: treat the method
                # as lock-aware (balance tracking would need CFG
                # analysis; the rule targets the never-locks case).
                self.ever_entered = True
                self.acquired.add(self._resolve(recv_lock))
            if (
                isinstance(fn.value, ast.Name)
                and fn.value.id == "self"
                and fn.attr.endswith("_locked")
                and self.depth == 0
            ):
                self.locked_calls.append(node)
        if self.held and recv_lock is None:
            # A call made while a lock is held: a cross-class order-graph
            # edge candidate, resolved later by callee method name.
            name = None
            if isinstance(fn, ast.Attribute):
                name = fn.attr
            elif isinstance(fn, ast.Name):
                name = fn.id
            if name is not None and name not in _UNTRACKED_CALLEES:
                for h in self.held:
                    self.calls_under.append((h, name, node))
        self.generic_visit(node)

    # -- shared-state writes ---------------------------------------------

    def _record_write(self, target: ast.expr, stmt: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:  # a, b = ... unpacking targets
                self._record_write(elt, stmt)
            return
        if isinstance(target, ast.Starred):
            self._record_write(target.value, stmt)
            return
        attr = _self_attr(target)
        if attr is None or not attr.startswith("_"):
            return
        if attr in self.locks:
            return
        if self.depth == 0:
            self.attr_writes.append((stmt, attr))

    def visit_Assign(self, node: ast.Assign) -> None:
        # Simple alias tracking, in statement order: ``lk = self._lock``
        # binds lk to the lock for the rest of the method (rebinding
        # overwrites; aliasing an alias follows one hop).
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            tname = node.targets[0].id
            vattr = _self_attr(node.value)
            if vattr in self.locks:
                self.aliases[tname] = vattr
            elif (
                isinstance(node.value, ast.Name)
                and node.value.id in self.aliases
            ):
                self.aliases[tname] = self.aliases[node.value.id]
            elif tname in self.aliases:
                self.aliases.pop(tname)  # rebound to something else
        for tgt in node.targets:
            self._record_write(tgt, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_write(node.target, node)
        self.generic_visit(node)

    # Nested defs make lock-depth reasoning lexical nonsense (callbacks
    # run later, on other threads); scan them as separate methods.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass


def _pragma_allows(src_lines: Sequence[str], node: ast.AST, rule: str) -> bool:
    """``# threadlint: allow[rule]`` on any line the statement spans."""
    start = getattr(node, "lineno", 0)
    end = getattr(node, "end_lineno", start) or start
    for ln in range(start, end + 1):
        if 1 <= ln <= len(src_lines):
            for m in _PRAGMA.finditer(src_lines[ln - 1]):
                if m.group(1) == rule:
                    return True
    return False


# Methods that run before/after the threaded phase by construction.
_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__repr__", "__str__"}


@dataclasses.dataclass
class _MethodInfo:
    """One method's contribution to the lock-order graph. Lock ids are
    ``(class_name, resolved_attr)`` pairs."""

    label: str
    acquired: Set = dataclasses.field(default_factory=set)
    edges: List = dataclasses.field(default_factory=list)  # (a, b, line)
    calls_under: List = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _ClassInfo:
    name: str
    path: str
    methods: List[_MethodInfo] = dataclasses.field(default_factory=list)


def _scan_class(
    cls: ast.ClassDef, path: str, src_lines: Sequence[str]
) -> (List[Finding], Optional[_ClassInfo]):
    locks = _lock_attrs(cls)
    if not locks:
        return [], None  # no lock, no thread-safety claim to check
    wraps = _lock_wraps(cls)
    info = _ClassInfo(name=cls.name, path=path)
    findings: List[Finding] = []
    methods = [
        n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    # Nested callbacks (closures handed to threads) are scanned as their
    # own "methods": lexical lock state does not carry into them.
    nested: List = []
    for m in methods:
        for node in ast.walk(m):
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node is not m
            ):
                nested.append((f"{m.name}.{node.name}", node))
    for label, m in [(m.name, m) for m in methods] + nested:
        base = label.split(".")[-1]
        scanner = _MethodScanner(locks, wraps)
        for stmt in m.body:
            scanner.visit(stmt)
        minfo = _MethodInfo(label=label)
        minfo.acquired = {(cls.name, a) for a in scanner.acquired}
        for outer, inner, node in scanner.order_edges:
            if _pragma_allows(src_lines, node, "lock-order-cycle"):
                continue
            minfo.edges.append(
                ((cls.name, outer), (cls.name, inner), node.lineno)
            )
        for held, callee, node in scanner.calls_under:
            if _pragma_allows(src_lines, node, "lock-order-cycle"):
                continue
            minfo.calls_under.append(((cls.name, held), callee, node.lineno))
        info.methods.append(minfo)
        if base not in _EXEMPT_METHODS and not base.endswith("_locked"):
            if not scanner.ever_entered:
                for w, attr in scanner.attr_writes:
                    if _pragma_allows(src_lines, w, "unlocked-attr-write"):
                        continue
                    findings.append(
                        Finding(
                            rule="unlocked-attr-write",
                            path=path,
                            line=w.lineno,
                            cls=cls.name,
                            method=label,
                            message=(
                                f"writes self.{attr} but never "
                                f"enters {sorted(locks)} in this method"
                            ),
                        )
                    )
        if not base.endswith("_locked"):
            for call in scanner.locked_calls:
                if _pragma_allows(src_lines, call, "locked-call-outside-lock"):
                    continue
                findings.append(
                    Finding(
                        rule="locked-call-outside-lock",
                        path=path,
                        line=call.lineno,
                        cls=cls.name,
                        method=label,
                        message=(
                            f"calls self.{call.func.attr}() outside any "
                            f"'with self.{sorted(locks)[0]}' block (the "
                            "_locked suffix documents lock-held-only)"
                        ),
                    )
                )
    return findings, info


def _lock_order_findings(classes: Sequence[_ClassInfo]) -> List[Finding]:
    """Build the acquisition-order graph over every scanned class and
    report each cycle once.

    Nodes are ``(class, lock-attr)`` pairs (Condition wrappers already
    resolved). Direct edges come from lexical ``with`` nesting;
    cross-class edges from calls made under a held lock, resolved by
    callee *method name* against every scanned class — deliberately
    over-approximate (any same-named method matches), because a lint
    that misses an ABBA deadlock is worse than one needing an occasional
    ``# threadlint: allow[lock-order-cycle]``."""
    # Method base name -> set of lock ids that method acquires.
    method_locks: Dict[str, Set] = {}
    for ci in classes:
        for mi in ci.methods:
            base = mi.label.split(".")[-1]
            if mi.acquired:
                method_locks.setdefault(base, set()).update(mi.acquired)
    # edge -> (path, line, cls, method) of one representative site.
    edges: Dict = {}
    for ci in classes:
        for mi in ci.methods:
            for a, b, line in mi.edges:
                edges.setdefault((a, b), (ci.path, line, ci.name, mi.label))
            for held, callee, line in mi.calls_under:
                for target in sorted(method_locks.get(callee, ())):
                    if target != held:
                        edges.setdefault(
                            (held, target),
                            (ci.path, line, ci.name, mi.label),
                        )
    graph: Dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    findings: List[Finding] = []
    reported: Set = set()
    # One DFS per node: the first back-edge closing a cycle through the
    # start node reports it; the frozenset of members dedups rotations.
    def _cycle_from(start) -> Optional[List]:
        stack = [(start, [start])]
        seen = set()
        while stack:
            node, trail = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    return trail + [start]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, trail + [nxt]))
        return None

    for start in sorted(graph):
        cycle = _cycle_from(start)
        if cycle is None:
            continue
        key = frozenset(cycle)
        if key in reported:
            continue
        reported.add(key)
        first_edge = (cycle[0], cycle[1])
        path, line, cls_name, method = edges[first_edge]
        pretty = " -> ".join(f"{c}.{a}" for c, a in cycle)
        findings.append(
            Finding(
                rule="lock-order-cycle",
                path=path,
                line=line,
                cls=cls_name,
                method=method,
                message=(
                    f"lock acquisition order cycle: {pretty} — two "
                    "threads taking these locks in opposite orders "
                    "deadlock"
                ),
            )
        )
    return findings


def _scan_file_ex(
    path: str, repo: str = REPO
) -> (List[Finding], List[_ClassInfo]):
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:  # pragma: no cover - repo parses
        rel = os.path.relpath(path, repo)
        return [
            Finding(
                rule="unlocked-attr-write",
                path=rel,
                line=e.lineno or 0,
                cls="<module>",
                method="<parse>",
                message=f"syntax error: {e.msg}",
            )
        ], []
    src_lines = src.splitlines()
    rel = os.path.relpath(path, repo)
    findings: List[Finding] = []
    infos: List[_ClassInfo] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            cls_findings, info = _scan_class(node, rel, src_lines)
            findings.extend(cls_findings)
            if info is not None:
                infos.append(info)
    return findings, infos


def scan_file(path: str, repo: str = REPO) -> List[Finding]:
    findings, infos = _scan_file_ex(path, repo)
    return findings + _lock_order_findings(infos)


def scan_paths(paths: Sequence[str], repo: str = REPO) -> List[Finding]:
    files: List[str] = []
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(repo, p)
        if os.path.isdir(full):
            for root, _dirs, names in os.walk(full):
                files.extend(
                    os.path.join(root, n)
                    for n in sorted(names)
                    if n.endswith(".py")
                )
        elif full.endswith(".py"):
            files.append(full)
    findings: List[Finding] = []
    infos: List[_ClassInfo] = []
    for f in sorted(set(files)):
        file_findings, file_infos = _scan_file_ex(f, repo)
        findings.extend(file_findings)
        infos.extend(file_infos)
    # ONE graph over the whole sweep: ABBA cycles are exactly the bugs
    # that span classes (and files).
    findings.extend(_lock_order_findings(infos))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hvdtpu_threadlint", description=__doc__.splitlines()[0]
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=list(DEFAULT_PATHS),
        help="files/dirs to scan (default: the threaded control plane)",
    )
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)
    findings = scan_paths(args.paths or list(DEFAULT_PATHS))
    if args.json:
        print(
            json.dumps(
                {
                    "tool": "hvdtpu_threadlint",
                    "n_findings": len(findings),
                    "findings": [f.to_dict() for f in findings],
                }
            )
        )
    else:
        for f in findings:
            print(f)
        print(
            f"hvdtpu_threadlint: "
            f"{'clean' if not findings else f'{len(findings)} finding(s)'}"
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
