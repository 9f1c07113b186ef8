"""Serving-plane twin: tune the dispatcher against its p95 latency (the
JAX package's ``tune/serve.py``).

``ServePool(autotune=True)`` runs this tuner on a pool-owned thread. It
searches the :func:`~horovod_tpu_torch.tune.knobs.serve_space` —
``HVDTPU_SERVE_BATCH_TIMEOUT_MS`` (the batch fill window: too short
wastes device batches on single requests, too long queues latency) and
the autoscaler watermarks — scoring each trial as ``-p95`` of the
``serve.request_ms`` histogram under whatever load the pool is serving
(the caller provides the load).

Every serve knob is **cheap**: trials flip the live
``Dispatcher.batch_timeout_ms`` / policy watermarks in place between
batches — nothing recompiles, nothing restarts. Convergence settles the
pool on the best measured config and stops perturbing it.

The tuner *is* telemetry-driven, so it turns the metrics plane on if it
was off (the histogram it scores from must exist).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from .knobs import KnobRegistry, serve_space
from .scoring import ServeLatencyScorer
from .search import AutotuneSearch
from ..obs import registry as _obs
from ..obs import tune as _tobs
from ..utils import env as _env

log = logging.getLogger("horovod_tpu_torch.tune.serve")


class ServeTuner:
    """Closed loop over a live :class:`~horovod_tpu_torch.serve.pool.ServePool`."""

    def __init__(self, pool, cfg, *,
                 registry: Optional[KnobRegistry] = None,
                 scorer: Optional[ServeLatencyScorer] = None,
                 poll_secs: float = 0.05):
        if not _obs.enabled():
            # The scoring plane is the obs histogram; a tuner without
            # telemetry would score zeros forever.
            _obs.enable()
        self.pool = pool
        if registry is None:
            # Trial 0's incumbent must be the POOL'S live config (an
            # explicit batch_timeout_ms= beats the env default), and
            # "never worse than hand-set as measured" must hold against
            # what is actually running.
            live = {
                _env.SERVE_BATCH_TIMEOUT_MS: float(
                    pool.dispatcher.batch_timeout_ms
                ),
            }
            if getattr(pool, "policy", None) is not None:
                live[_env.SERVE_QUEUE_HIGH] = float(pool.policy.high)
                live[_env.SERVE_QUEUE_LOW] = float(pool.policy.low)
            registry = serve_space(subset=cfg.knobs, defaults=live)
        self.registry = registry
        self.search = AutotuneSearch(
            self.registry, seed=cfg.seed, max_trials=cfg.max_trials,
            patience=cfg.patience,
        )
        window = cfg.window_steps or _env.autotune_window_steps()
        warmup = (
            cfg.warmup_steps if cfg.warmup_steps is not None
            else _env.autotune_warmup_steps()
        )
        self.scorer = scorer if scorer is not None else ServeLatencyScorer(
            window_responses=window * 8, warmup_responses=warmup * 8
        )
        self.poll_secs = poll_secs
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.applied: Optional[dict] = None
        self.done = False

    # -- knob application (in place, between batches) ----------------------

    def _setters(self):
        pool = self.pool

        def set_timeout(v):
            pool.dispatcher.batch_timeout_ms = float(v)

        def set_high(v):
            if pool.policy is not None and float(v) > pool.policy.low:
                pool.policy.high = float(v)

        def set_low(v):
            if pool.policy is not None and float(v) < pool.policy.high:
                pool.policy.low = float(v)

        return {
            _env.SERVE_BATCH_TIMEOUT_MS: set_timeout,
            _env.SERVE_QUEUE_HIGH: set_high,
            _env.SERVE_QUEUE_LOW: set_low,
        }

    def _apply(self, vector: dict) -> None:
        # env=False: these knobs live entirely in THIS pool's
        # dispatcher/policy attributes; writing os.environ would seed
        # every later pool's search with this pool's winner.
        self.registry.apply(vector, setters=self._setters(), env=False)
        self.applied = vector
        self.scorer.reset()
        _tobs.record_switch(retrace=False)
        _tobs.set_candidate(self.search.trial, vector, {})

    # -- loop --------------------------------------------------------------

    def tick(self) -> bool:
        """One tuner turn; returns True while more turns are needed.
        Separated from the thread for deterministic tests."""
        if self.done:
            return False
        if self.applied is None:
            self._apply(self.search.propose())
            return True
        score = self.scorer.poll()
        if score is None:
            return True
        self.search.record(self.applied, score)
        _tobs.record_trial(score, self.search.best_score)
        if self.search.done:
            best = self.search.best_vector()
            self._apply(best)
            self.done = True
            _tobs.set_converged(self.search.best_score)
            log.info(
                "serve autotune converged after %d trial(s): %s "
                "(p95 %.3f ms)", self.search.n_trials, best,
                -self.search.best_score,
            )
            return False
        self._apply(self.search.propose())
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_secs):
            if not self.tick():
                return

    def start(self) -> "ServeTuner":
        self._thread = threading.Thread(
            target=self._loop, name="serve-autotune", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
