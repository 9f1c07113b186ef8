"""Lockstep rollout protocol: candidate vectors through the HA KV plane.

The JAX package's ``tune/rollout.py``: the same KV keys and JSON, so a
coordinator of either package drives clients of the other over one KV.

The closed loop has two halves:

* the **driver-side** :class:`RolloutCoordinator` (hosted by
  ``runner.elastic_driver.ElasticJob`` when ``HVDTPU_AUTOTUNE=1``) owns
  the :class:`~horovod_tpu_torch.tune.search.AutotuneSearch`. It publishes the
  live candidate as ONE KV value (``autotune/config``) carrying the
  trial number, the knob vector, and the **switch boundary** — the step
  index at which every rank flips; collects per-host window scores
  (``autotune/score/<host>``); records the aggregated trial; proposes
  the next candidate. Every mutation rides the journaled rendezvous
  store AND the coordinator's search state rides the driver-state
  journal records, so a crash-adopted driver resumes the search **from
  the journaled trial history — adopted, never re-learned** — and the
  deterministic proposal sequence (pure function of seed + history)
  lands on the same final config a fault-free run would.

* the **worker-side** :class:`AutotuneClient` polls the config between
  steps, applies a pending vector exactly at its switch boundary (all
  ranks share the step counter — SPMD training is lockstep, so no rank
  ever runs a mixed vector), opens a warmup-discarded scoring window,
  and reports the window score. Cheap knobs flip in place (env +
  optional live setters); a candidate that changes a
  ``requires_retrace`` knob makes the coordinator request a round
  republish and the step wrapper rebuild its compiled program.

Both halves also run without a driver: :class:`LocalConfigSource` wires
the client straight to its own search for single-process tuning
(notebooks, scripts).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

from .knobs import KnobRegistry, training_space
from .scoring import WindowScorer
from .search import AutotuneSearch
from ..obs import tune as _tobs
from ..utils import env as _env

log = logging.getLogger("horovod_tpu_torch.tune")

SCOPE = "autotune"
CONFIG_KEY = "config"
SCORE_PREFIX = "score/"
# Steps of slack between "every rank has surely seen the config" and the
# switch boundary: ranks poll every step, so the boundary only needs to
# clear KV propagation + one poll.
DEFAULT_SWITCH_MARGIN = 3


def _choice_indices(registry: KnobRegistry,
                    vector: Dict[str, object]) -> Dict[str, int]:
    out = {}
    for k in registry.knobs:
        if k.kind in ("choice",):
            out[k.name] = k.choices.index(vector[k.name])
    return out


class RolloutCoordinator:
    """Driver-side search owner + candidate publisher."""

    def __init__(self, registry: Optional[KnobRegistry] = None, *,
                 search: Optional[AutotuneSearch] = None,
                 switch_margin: int = DEFAULT_SWITCH_MARGIN):
        self.registry = registry if registry is not None else training_space()
        self.search = (
            search if search is not None else AutotuneSearch(self.registry)
        )
        self.switch_margin = max(1, switch_margin)
        self._started = False
        self._trial = 0
        self._vector: Optional[Dict[str, object]] = None
        self._prev_vector: Optional[Dict[str, object]] = None
        self._published_done = False
        self._dirty = False
        # The exact doc last handed to the KV — journaled BEFORE the
        # put, so an adopter that finds the journal ahead of the store
        # (crash in the publish window) re-puts it verbatim.
        self._last_doc: Optional[dict] = None
        self._needs_republish = False

    @classmethod
    def from_env(cls) -> "RolloutCoordinator":
        return cls()

    # -- KV schema ---------------------------------------------------------

    def _publish(self, server, *, trial: int, vector: Dict[str, object],
                 switch_step: int, done: bool = False,
                 round_: Optional[int] = None,
                 journal: Optional[Callable[[], None]] = None) -> None:
        """Publish one candidate doc — JOURNAL FIRST, then the KV put.

        The ordering is the crash-consistency contract: the adopter's
        journaled view must never lag the store the workers see (a
        coordinator one trial behind its workers would filter their
        score reports forever). A crash between the journal write and
        the put leaves the journal AHEAD instead, which adoption heals
        by re-putting ``_last_doc`` verbatim (idempotent).

        ``round_`` is embedded for retrace candidates: workers apply
        those at the elastic-round boundary (globally lockstep by
        construction), not at a step-counter boundary that a respawned
        worker's restarted counter could skew.
        """
        doc = {
            "trial": trial,
            "vector": vector,
            "switch_step": int(switch_step),
            "done": bool(done),
            "round": round_,
            "best": self.search.best_vector() if self.search.n_trials else None,
            "ts": time.time(),
        }
        self._last_doc = doc
        self._dirty = True
        if journal is not None:
            journal()
        server.put(SCOPE, CONFIG_KEY, json.dumps(doc).encode())
        _tobs.set_candidate(trial, vector,
                            _choice_indices(self.registry, vector))

    def _read_scores(self, server, hosts: Sequence[str]) -> Dict[str, dict]:
        try:
            items = server.scope_items(SCOPE)
        except Exception:
            return {}
        scores: Dict[str, dict] = {}
        for key, raw in items.items():
            if not key.startswith(SCORE_PREFIX):
                continue
            host = key[len(SCORE_PREFIX):]
            if host not in hosts:
                continue  # scaled-away reporter; its window is void
            try:
                rec = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            if rec.get("trial") == self._trial:
                scores[host] = rec
        return scores

    # -- driver hook -------------------------------------------------------

    @property
    def pending_round(self) -> Optional[int]:
        """The elastic round the live candidate waits for (None when it
        is counter/immediate-switched). The driver must not resume a
        round below this — an adopter that crashed between publishing a
        retrace candidate and the round republish would otherwise leave
        every worker waiting on a round that never comes."""
        if self._last_doc is None:
            return None
        r = self._last_doc.get("round")
        return int(r) if r is not None else None

    def poll(self, server, hosts: Sequence[str], *,
             journal: Optional[Callable[[], None]] = None,
             round_: Optional[int] = None) -> bool:
        """One coordinator turn; called from the driver's poll loop.

        ``journal`` persists the coordinator (+driver) state and is
        invoked BEFORE every KV publish (see :meth:`_publish`);
        ``round_`` is the driver's current elastic round. Returns True
        when the just-published candidate flips a ``requires_retrace``
        knob — the driver republishes a membership round so the retrace
        rides the ordinary rescale path (workers rebuild at the rejoin
        boundary, which is globally lockstep by construction).
        """
        if self._needs_republish:
            # Adoption heal: the journal was ahead of (or equal to) the
            # store at the crash; re-put the journaled doc verbatim so
            # both views re-align. Idempotent when they already match.
            self._needs_republish = False
            if self._last_doc is not None:
                server.put(SCOPE, CONFIG_KEY,
                           json.dumps(self._last_doc).encode())
                log.info(
                    "autotune: republished adopted candidate (trial %s)",
                    self._last_doc.get("trial"),
                )
        if not self._started:
            self._vector = self.search.propose()  # trial 0 = incumbent
            self._trial = self.search.trial
            self._started = True
            self._publish(server, trial=self._trial, vector=self._vector,
                          switch_step=0, journal=journal)
            log.info("autotune: published trial 0 (incumbent) %s",
                     self._vector)
            return False
        if self._published_done:
            return False
        if self.search.done:
            # Converged while un-published (e.g. restored state).
            return self._finish(server, max_step=0, round_=round_,
                                journal=journal)
        if not hosts:
            return False
        scores = self._read_scores(server, hosts)
        if len(scores) < len(hosts):
            return False
        agg = sum(s["score"] for s in scores.values()) / len(scores)
        max_step = max(int(s.get("step", 0)) for s in scores.values())
        self.search.record(self._vector, agg)
        _tobs.record_trial(agg, self.search.best_score)
        self._dirty = True
        log.info("autotune: trial %d scored %.6g (best %.6g)",
                 self._trial, agg, self.search.best_score)
        if self.search.done:
            return self._finish(server, max_step=max_step, round_=round_,
                                journal=journal)
        self._prev_vector, self._vector = self._vector, self.search.propose()
        self._trial = self.search.trial
        retrace = self.registry.retrace_changed(self._prev_vector,
                                                self._vector)
        self._publish(
            server, trial=self._trial, vector=self._vector,
            switch_step=max_step + self.switch_margin,
            round_=(round_ + 1) if retrace and round_ is not None else None,
            journal=journal,
        )
        return retrace

    def _finish(self, server, max_step: int, round_: Optional[int] = None,
                journal: Optional[Callable[[], None]] = None) -> bool:
        best = self.search.best_vector()
        retrace = self.registry.retrace_changed(self._vector, best)
        self._prev_vector, self._vector = self._vector, best
        self._trial = self.search.n_trials  # one past the last recorded
        self._published_done = True
        self._publish(
            server, trial=self._trial, vector=best,
            switch_step=max_step + self.switch_margin, done=True,
            round_=(round_ + 1) if retrace and round_ is not None else None,
            journal=journal,
        )
        _tobs.set_converged(self.search.best_score)
        log.info("autotune converged after %d trial(s): %s (score %.6g)",
                 self.search.n_trials, best, self.search.best_score)
        return retrace

    def consume_dirty(self) -> bool:
        """True once after any state change — the driver journals then."""
        d, self._dirty = self._dirty, False
        return d

    # -- durability --------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "search": self.search.state_dict(),
            "started": self._started,
            "trial": self._trial,
            "vector": self._vector,
            "prev_vector": self._prev_vector,
            "published_done": self._published_done,
            "last_doc": self._last_doc,
        }

    def load_state_dict(self, state: dict) -> None:
        """Adopt the dead driver's search mid-flight: history, the trial
        being evaluated, and the exact last-published config. The
        journal is written BEFORE every publish, so the adopted view is
        either equal to the replayed store or one put AHEAD of it —
        the first post-adoption poll re-puts ``last_doc`` to close that
        window (never behind: a lagging coordinator would filter its
        workers' score reports forever)."""
        self.search.load_state_dict(state["search"])
        self._started = bool(state.get("started", False))
        self._trial = int(state.get("trial", 0))
        self._vector = state.get("vector")
        self._prev_vector = state.get("prev_vector")
        self._published_done = bool(state.get("published_done", False))
        self._last_doc = state.get("last_doc")
        self._needs_republish = self._started


class KVConfigSource:
    """Worker-side view of the coordinator's KV schema. ``kv`` needs
    ``get(scope, key) -> bytes|None`` and ``put(scope, key, bytes)`` —
    the elastic ``RendezvousClient`` surface. KV outages are absorbed:
    the worker keeps training on its current vector and re-polls."""

    def __init__(self, kv, host_id: str):
        self.kv = kv
        self.host_id = host_id

    def poll(self) -> Optional[dict]:
        try:
            raw = self.kv.get(SCOPE, CONFIG_KEY)
        except Exception:
            return None  # outage: ride it out on the current vector
        if raw is None:
            return None
        try:
            return json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            return None

    def report(self, trial: int, score: float, step: int) -> None:
        doc = {"trial": int(trial), "score": float(score),
               "step": int(step), "host": self.host_id}
        try:
            self.kv.put(SCOPE, SCORE_PREFIX + self.host_id,
                        json.dumps(doc).encode())
        except Exception:
            # Lost report: the coordinator simply waits; the NEXT window
            # on this vector re-reports (score records are idempotent
            # full-value writes keyed by host).
            log.debug("autotune: score report failed (KV outage?)")


class LocalConfigSource:
    """Driverless twin: the client talks to its own in-process search.
    Same protocol shape (trial/vector/switch_step/done), zero KV."""

    def __init__(self, search: AutotuneSearch, switch_margin: int = 1):
        self.search = search
        self.switch_margin = max(1, switch_margin)
        self._config = {
            "trial": 0,
            "vector": search.propose(),
            "switch_step": 0,
            "done": search.done,
        }

    def poll(self) -> Optional[dict]:
        return dict(self._config)

    def report(self, trial: int, score: float, step: int) -> None:
        if self.search.done or trial != self.search.trial:
            return
        self.search.record(self._config["vector"], score)
        _tobs.record_trial(score, self.search.best_score)
        done = self.search.done
        vector = (
            self.search.best_vector() if done else self.search.propose()
        )
        self._config = {
            "trial": self.search.trial if not done else self.search.n_trials,
            "vector": vector,
            "switch_step": step + self.switch_margin,
            "done": done,
        }
        if done:
            _tobs.set_converged(self.search.best_score)


class SwitchAction:
    """What :meth:`AutotuneClient.step_start` hands the caller when a
    vector lands: the vector itself, whether the compiled step must be
    rebuilt, and whether the search is finished."""

    __slots__ = ("vector", "retrace", "done")

    def __init__(self, vector: Dict[str, object], retrace: bool, done: bool):
        self.vector = vector
        self.retrace = retrace
        self.done = done


class AutotuneClient:
    """Worker-side half: poll → lockstep switch → score → report.

    Call :meth:`step_start` before each training step and
    :meth:`step_end` after it with the step's wall seconds. The client
    owns a step counter (all ranks advance it in lockstep — SPMD steps
    are collective-synchronized), applies pending vectors exactly at
    their published switch boundary, and reports one warmup-discarded
    window score per trial.
    """

    def __init__(self, registry: KnobRegistry, source, *,
                 scorer: Optional[WindowScorer] = None,
                 setters: Optional[Dict[str, Callable]] = None,
                 poll_steps: int = 1,
                 round_provider: Optional[Callable[[], int]] = None):
        self.registry = registry
        self.source = source
        self.scorer = scorer if scorer is not None else WindowScorer()
        self.setters = setters
        self.poll_steps = max(1, poll_steps)
        if round_provider is None:
            # Elastic workers gate retrace switches on the round they
            # have JOINED — the rejoin is the globally-lockstep boundary
            # (every rank raises HostsUpdatedInterrupt at the same
            # commit). Local/driverless clients have no rounds; their
            # single rank can't mix vectors with anyone.
            from ..elastic import worker as _worker

            if _worker.in_elastic_world():
                round_provider = _worker.current_round
        self.round_provider = round_provider
        self.step = 0  # completed steps
        self.applied: Optional[Dict[str, object]] = None
        self.applied_trial = -1
        self.done = False
        self._pending: Optional[dict] = None
        self._reported = False
        self._last_report: Optional[tuple] = None
        self._since_report = 0
        self.switch_log: List[tuple] = []  # (step, trial, vector) evidence

    @property
    def best(self) -> Optional[Dict[str, object]]:
        return self.applied if self.done else None

    def _poll(self) -> None:
        cfg = self.source.poll()
        if not cfg or not isinstance(cfg.get("vector"), dict):
            return
        if cfg.get("trial", -1) > self.applied_trial:
            self._pending = cfg

    def step_start(self) -> Optional[SwitchAction]:
        """Apply a due switch; returns the action (or None)."""
        if self.done:
            return None
        if self._pending is None and self.step % self.poll_steps == 0:
            self._poll()
        p = self._pending
        if p is None:
            return None
        if self.applied is None:
            # A client that has never applied ANY vector — job start,
            # or a worker respawned mid-search whose counter restarted
            # far behind the published boundary — adopts the live
            # candidate immediately: it runs nothing a boundary could
            # keep consistent, and waiting would deadlock the trial.
            due = True
        elif p.get("round") is not None and self.round_provider is not None:
            # Retrace candidate in an elastic world: the switch rides
            # the round republish — every rank rejoins (and therefore
            # rebuilds) at the SAME commit, so the round test cannot
            # skew across ranks even when step counters have (a
            # respawned worker's counter restarts at 0).
            due = self.round_provider() >= int(p["round"])
            if due:
                # The rejoin realigned every rank; restart the counters
                # there so later counter-based (cheap) boundaries are
                # compared on aligned clocks again.
                self.step = 0
        else:
            due = self.step >= int(p.get("switch_step", 0))
        if not due:
            return None
        vector = self.registry.canonical(p["vector"])
        retrace = self.registry.retrace_changed(self.applied, vector)
        late = self.step > int(p.get("switch_step", 0))
        self.registry.apply(vector, setters=self.setters)
        self.applied = vector
        self.applied_trial = int(p["trial"])
        self.done = bool(p.get("done", False))
        self._pending = None
        self._reported = False
        self.scorer.reset()
        self.switch_log.append((self.step, self.applied_trial, vector))
        _tobs.record_switch(retrace, late=late)
        _tobs.set_candidate(self.applied_trial, vector,
                            _choice_indices(self.registry, vector))
        return SwitchAction(vector, retrace, self.done)

    def step_end(self, seconds: float) -> None:
        """Account one completed step (``seconds`` of wall time)."""
        self.step += 1
        if self.done or self.applied is None or self._reported:
            # Between windows: poll opportunistically so a config
            # published mid-wait is seen before its boundary — and
            # RE-report the last window every window's worth of steps
            # while no new config lands. A report swallowed by a KV
            # outage (driver crash mid-search) would otherwise deadlock
            # the trial: the adopted coordinator waits for a score this
            # client believes it already delivered. Reports are
            # idempotent full-value writes, so repetition is free.
            if not self.done and self._pending is None:
                self._poll()
                if self._reported and self._last_report is not None:
                    self._since_report += 1
                    if self._since_report >= self.scorer.window_steps:
                        self._since_report = 0
                        self.source.report(*self._last_report)
            return
        score = self.scorer.add(seconds * 1e3)
        if score is not None:
            self._reported = True
            self._since_report = 0
            self._last_report = (self.applied_trial, score, self.step)
            self.source.report(self.applied_trial, score, self.step)
