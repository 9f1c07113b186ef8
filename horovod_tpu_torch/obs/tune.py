"""Autotuner instruments: one home for every ``autotune.*`` metric name
(the JAX package's names).

The search engine, the rollout coordinator/client, and the serve tuner
all record through these helpers so the names the exporters serialize
(and ``tools/hvdtpu_top.py``'s autotune panel discovers) cannot drift
per call site. The panel discovers rows by prefix — these gauges only
appear once the tuner passes warmup, which is exactly the
mid-run-appearing-gauge case the panel's dynamic discovery exists for.

=================================  =====================================
``autotune.trial``          gauge  trial index currently evaluating
``autotune.score``          gauge  last recorded trial score
``autotune.best_score``     gauge  incumbent score
``autotune.converged``      gauge  1 once the search settled
``autotune.candidate.<k>``  gauge  numeric knob k of the live candidate
                                   (bools as 0/1; choices as index)
``autotune.trials``         count  recorded trials
``autotune.switches``       count  applied knob switches (lockstep
                                   flips on the worker side)
``autotune.retraces``       count  switches that rebuilt the step
``autotune.late_switches``  count  switches applied after their
                                   published boundary (protocol slip)
=================================  =====================================
"""

from __future__ import annotations

from typing import Dict

from . import registry as _obs


def _numeric(value) -> float:
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    if isinstance(value, (int, float)):
        return float(value)
    return float("nan")  # categorical: the <k>.choice gauge carries it


def set_candidate(trial: int, vector: Dict[str, object],
                  choices: Dict[str, int]) -> None:
    """Publish the live candidate: numeric knobs directly, categorical
    knobs as their choice index (``choices`` maps name -> index)."""
    reg = _obs.metrics()
    reg.gauge("autotune.trial").set(float(trial))
    for name, value in vector.items():
        v = choices.get(name)
        reg.gauge(f"autotune.candidate.{name}").set(
            float(v) if v is not None else _numeric(value)
        )


def record_trial(score: float, best_score: float) -> None:
    reg = _obs.metrics()
    reg.counter("autotune.trials").inc()
    reg.gauge("autotune.score").set(float(score))
    reg.gauge("autotune.best_score").set(float(best_score))


def record_switch(retrace: bool, late: bool = False) -> None:
    reg = _obs.metrics()
    reg.counter("autotune.switches").inc()
    if retrace:
        reg.counter("autotune.retraces").inc()
    if late:
        reg.counter("autotune.late_switches").inc()


def set_converged(best_score: float) -> None:
    reg = _obs.metrics()
    reg.gauge("autotune.converged").set(1.0)
    reg.gauge("autotune.best_score").set(float(best_score))
    reg.event("autotune.converged", best_score=best_score)
