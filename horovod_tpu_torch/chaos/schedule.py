"""Deterministic fault-injection schedules.

The port of the JAX package's ``chaos/schedule.py``, the same grammar and
the same closed catalog of sites, so one ``HVDTPU_CHAOS`` string arms
either package. A schedule is a comma-separated list of rules, each arming
one fault at one named site::

    SITE:ACTION[=VALUE][@COND[;COND...]]

    kv.request:drop@after=1;n=6            # 6-call KV outage
    worker.step:crash@step=4;host=hostB    # hostB dies at its 4th commit
    worker.step:slow=0.25@rank=1           # rank-1 straggler
    ckpt.write:corrupt@step=5              # bit-rot the step-5 checkpoint
    serve.decode:crash@step=3;n=1          # a decode worker dies mid-round

Sites and their legal actions are a closed catalog (:data:`SITES`): a
typo'd site or action raises at parse time, never silently no-ops -- a
chaos run that injects nothing must not masquerade as a survived one.

Conditions (all optional, AND-ed):

``step=K``   fire exactly at occurrence ``K`` (the site's ``step``
             context when provided -- commit count, checkpoint step --
             else the rule's own per-process call counter);
``after=K``  fire at occurrence >= K;
``every=M``  fire when the occurrence is a multiple of M;
``n=N``      at most N fires (per process);
``p=F``      fire with probability F from the rule's seeded stream;
``rank=R``   only on rank R (site-provided context);
``host=H``   only on host H (``HVDTPU_HOST_ID``);
``spawn=G``  only in processes spawned in elastic round G
             (``HVDTPU_SPAWN_ROUND``).

Determinism: every rule owns a ``random.Random`` seeded from the plan
seed and the rule's index, site and action (crc32, stable across runs and
Python versions), so a schedule with ``p=`` conditions fires at the same
occurrences on every run with the same seed, and a site that picks a
victim from the rule's stream picks the reference's.
"""

from __future__ import annotations

import random
import threading
import zlib
from typing import Dict, List, Optional

# site -> legal actions. Actions carrying a value (seconds) are marked
# by the sites that interpret them; parse-time we only gate names.
SITES: Dict[str, tuple] = {
    # KVClient HTTP requests (runner/http_server.py).
    "kv.request": ("drop", "error", "delay"),
    # Elastic worker commits (elastic/state.py State.commit).
    "worker.step": ("crash", "hang", "slow", "delay"),
    # Checkpoint writer, between serialization and atomic rename
    # (checkpoint.save_checkpoint).
    "ckpt.write": ("corrupt", "truncate", "delay"),
    # Eager collective dispatch (ops/eager.py).
    "eager.dispatch": ("delay", "timeout"),
    # Serving-request ingress (serve/dispatcher.py Dispatcher.submit):
    # drop rejects the request at the door, delay stalls its enqueue.
    "serve.request": ("drop", "delay"),
    # Serving batch dispatch (the worker's infer call): timeout makes
    # the worker abandon the leased batch (the dispatcher's lease reaper
    # must re-queue it), error fails the batch (immediate re-queue),
    # crash hard-kills the serving worker mid-flight.
    "serve.dispatch": ("timeout", "error", "crash", "delay"),
    # Token-level decode engine round (serve/engine.py worker loop):
    # crash hard-kills the decode WORKER mid-sequence (thread-level for
    # the in-process engine — the engine must requeue its streams and
    # resume them from prompt + committed tokens on survivors; the
    # process-level analog is serve.dispatch:crash), delay stalls one
    # round (straggling decode step).
    "serve.decode": ("crash", "delay"),
    # Weight-stream publishes (stream/publisher.py, per bucket write):
    # drop loses one bucket blob (the manifest names a key that never
    # landed), corrupt bit-flips one published blob (CRC must catch
    # it), torn aborts the set mid-write but still moves the manifest
    # (the torn-head case) — in every case the subscriber must reject
    # the whole version; delay stalls one bucket write.
    "publish.delta": ("drop", "corrupt", "torn", "delay"),
    # Fail-silent faults (guard/inject.py, fired from the
    # guarded train-step wrapper). grad.nan poisons one batch element
    # pre-dispatch (NaN gradient storm — batches are replicated, so
    # schedules normally fire it on EVERY rank; a rank-local rule in a
    # lockstep process world desyncs the retry cadence). grad.bitflip
    # flips ONE seeded bit of this rank's replicated params post-commit
    # (silent data corruption — only the consistency audit sees it);
    # param.corrupt rewrites a seeded span (the coarser twin).
    "grad.nan": ("nan",),
    "grad.bitflip": ("bitflip",),
    "param.corrupt": ("corrupt",),
    # Control-plane faults (runner/elastic_driver.py run loop). The KV
    # server is torn down hard and re-listened on the same port — from
    # the journal replay when one is attached, empty otherwise (the
    # negative the journal exists to prevent).
    "kv.server": ("restart",),
    # The launcher's control loop itself dies (raises DriverCrashed with
    # worker cleanup suppressed -- an in-process stand-in for the real
    # process dying).
    # Context step = the current round, so @step=R is deterministic.
    "driver.crash": ("crash",),
    # Preemption notice: a real SIGTERM delivered to the worker at
    # commit K; the installed grace handler owns the drain from there.
    "worker.preempt": ("sigterm",),
}

_VALUE_ACTIONS = ("delay", "slow")  # VALUE is seconds and required
_COND_KEYS = ("step", "after", "every", "n", "p", "rank", "host", "spawn")


class ChaosSpecError(ValueError):
    """Malformed ``HVDTPU_CHAOS`` schedule / ``chaos.plan`` spec."""


class Action:
    """One matched fault: what the site must do (or what ``chaos.act``
    already did, for the generic kinds)."""

    __slots__ = ("site", "kind", "value", "rng")

    def __init__(self, site: str, kind: str, value: Optional[float],
                 rng: random.Random):
        self.site = site
        self.kind = kind
        self.value = value
        self.rng = rng  # the owning rule's seeded stream (corrupt picks)

    def __repr__(self):
        v = "" if self.value is None else f"={self.value}"
        return f"Action({self.site}:{self.kind}{v})"


class Rule:
    def __init__(self, site: str, kind: str, value: Optional[float],
                 conds: Dict[str, object], seed: int, index: int):
        self.site = site
        self.kind = kind
        self.value = value
        self.conds = conds
        tag = f"{index}:{site}:{kind}"
        self.rng = random.Random((seed << 20) ^ zlib.crc32(tag.encode()))
        self.calls = 0
        self.fired = 0
        # Sites are hit from several threads (main loop, heartbeat,
        # notification watcher all issue KV requests): the occurrence
        # counters and the seeded stream must advance atomically or
        # n=/p= rules lose their replay-exactly contract.
        self._lock = threading.Lock()

    def match(self, ctx: Dict[str, object]) -> Optional[Action]:
        c = self.conds
        # Identity filters: stable per process, don't consume occurrence
        # counts (a host=/rank= rule sees the same step numbering a
        # condition-free rule would).
        if "host" in c and c["host"] != ctx.get("host"):
            return None
        if "rank" in c and c["rank"] != ctx.get("rank"):
            return None
        if "spawn" in c and c["spawn"] != ctx.get("spawn"):
            return None
        with self._lock:
            self.calls += 1
            step = ctx.get("step")
            occurrence = int(step) if step is not None else self.calls
            if "step" in c and occurrence != c["step"]:
                return None
            if "after" in c and occurrence < c["after"]:
                return None
            if "every" in c and occurrence % c["every"] != 0:
                return None
            if "n" in c and self.fired >= c["n"]:
                return None
            if "p" in c and self.rng.random() >= c["p"]:
                return None
            self.fired += 1
        return Action(self.site, self.kind, self.value, self.rng)


class Plan:
    """A parsed, armed schedule; per-process mutable state (counters,
    seeded streams) lives in the rules."""

    def __init__(self, rules: List[Rule], seed: int, spec: str):
        self.seed = seed
        self.spec = spec
        self._by_site: Dict[str, List[Rule]] = {}
        for r in rules:
            self._by_site.setdefault(r.site, []).append(r)

    @property
    def rules(self) -> List[Rule]:
        return [r for rs in self._by_site.values() for r in rs]

    def match(self, site: str, ctx: Dict[str, object]) -> Optional[Action]:
        for rule in self._by_site.get(site, ()):
            act = rule.match(ctx)
            if act is not None:
                return act
        return None


def _parse_cond(token: str, rule: str) -> tuple:
    if "=" not in token:
        raise ChaosSpecError(
            f"condition {token!r} in rule {rule!r} must be key=value"
        )
    key, raw = token.split("=", 1)
    key = key.strip()
    if key not in _COND_KEYS:
        raise ChaosSpecError(
            f"unknown condition {key!r} in rule {rule!r} "
            f"(choose from {', '.join(_COND_KEYS)})"
        )
    if key == "host":
        return key, raw.strip()
    if key == "p":
        p = float(raw)
        if not 0.0 <= p <= 1.0:
            raise ChaosSpecError(f"p={raw} in rule {rule!r} not in [0, 1]")
        return key, p
    return key, int(raw)


def parse(spec: str, seed: int = 0) -> Plan:
    """Parse a schedule string into an armed :class:`Plan`."""
    rules: List[Rule] = []
    for index, raw in enumerate(t for t in spec.split(",") if t.strip()):
        raw = raw.strip()
        head, _, cond_part = raw.partition("@")
        if ":" not in head:
            raise ChaosSpecError(
                f"rule {raw!r} must look like site:action[=value][@conds]"
            )
        site, action = (t.strip() for t in head.split(":", 1))
        value: Optional[float] = None
        if "=" in action:
            action, v = action.split("=", 1)
            action = action.strip()
            value = float(v)
        if site not in SITES:
            raise ChaosSpecError(
                f"unknown chaos site {site!r} "
                f"(choose from {', '.join(sorted(SITES))})"
            )
        if action not in SITES[site]:
            raise ChaosSpecError(
                f"action {action!r} not valid for site {site!r} "
                f"(choose from {', '.join(SITES[site])})"
            )
        if action in _VALUE_ACTIONS and value is None:
            raise ChaosSpecError(
                f"action {action!r} in rule {raw!r} needs a value "
                f"(e.g. {action}=0.5 seconds)"
            )
        conds = dict(
            _parse_cond(t.strip(), raw)
            for t in cond_part.split(";")
            if t.strip()
        )
        rules.append(Rule(site, action, value, conds, seed, index))
    if not rules:
        raise ChaosSpecError("empty chaos schedule")
    return Plan(rules, seed, spec)
