"""The search engine: GP-EI over the normalized knob vector (the JAX
package's ``tune/search.py``: the same candidates from the same seed and
scores, and the same ``state_dict``).

Port of ``ParameterManager``'s trial loop (csrc/parameter_manager.cc)
onto the typed knob registry:

* trial 0 evaluates the **current (default) vector** — exactly
  ``Initialize(fusion0, cycle0)`` making the hand-tuned config the
  incumbent, which also guarantees the final pick is never worse than
  the default *as measured* (the winner is argmax over evaluated
  trials, and the default is an evaluated trial);
* later trials fit the GP on all recorded ``(vector, score)`` pairs and
  propose the EI argmax over :data:`~horovod_tpu_torch.tune.gp.N_CANDIDATES`
  uniform draws (with the sd==0 guard), categorical dims riding the
  same unit cube through the registry's quantized choice mapping;
* convergence mirrors ``CloseSample``: ``patience`` consecutive
  no-improvement trials (C++: 10) or ``max_trials`` recorded samples
  (C++: 40) → done, settle on the best.

Everything is a pure function of ``(seed, history)``: candidate draws
for trial *t* come from :func:`~horovod_tpu_torch.tune.gp.candidates_for_trial`
``(seed, t)``, so a search resumed from journaled history proposes the
IDENTICAL remaining sequence — the property the driver crash-adoption
chaos scenario asserts end to end.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import gp as _gp
from .knobs import KnobRegistry
from ..utils import env as _env


class AutotuneSearch:
    """Sequential GP-EI search over a :class:`KnobRegistry` space."""

    def __init__(self, registry: KnobRegistry, *,
                 seed: Optional[int] = None,
                 max_trials: Optional[int] = None,
                 patience: Optional[int] = None):
        self.registry = registry
        self.seed = seed if seed is not None else _env.autotune_seed()
        self.max_trials = (
            max_trials if max_trials is not None
            else _env.autotune_max_trials()
        )
        self.patience = (
            patience if patience is not None else _env.autotune_patience()
        )
        # History: (unit vector, score) per recorded trial, in order.
        self._xs: List[List[float]] = []
        self._ys: List[float] = []
        self.best_score = float("-inf")
        self.best_unit: Optional[List[float]] = None
        self._no_improve = 0
        self.done = False

    # -- core loop ---------------------------------------------------------

    @property
    def n_trials(self) -> int:
        return len(self._ys)

    @property
    def trial(self) -> int:
        """Index of the trial :meth:`propose` will produce next."""
        return len(self._ys)

    def propose(self) -> Dict[str, object]:
        """The vector to evaluate as trial ``self.trial``."""
        if self.done:
            return self.best_vector()
        t = self.trial
        if t == 0:
            # The incumbent: tune FROM the hand-set config, not from a
            # random corner (ParameterManager::Initialize semantics).
            return self.registry.canonical(self.registry.default_vector())
        g = _gp.GaussianProcess()
        g.fit(self._xs, self._ys)
        cands = _gp.candidates_for_trial(self.seed, t, self.registry.dims)
        idx, _ = _gp.best_by_ei(g, self.best_score, cands)
        if idx is None:
            # Every candidate guard-skipped: fall back to the incumbent
            # (the C++ falls back to its default candidate the same way).
            return self.best_vector()
        return self.registry.canonical(self.registry.from_unit(cands[idx]))

    def record(self, vector: Dict[str, object], score: float) -> None:
        """Record trial ``self.trial``'s measured score and advance the
        convergence bookkeeping (CloseSample's improvement streak)."""
        if self.done:
            return
        unit = self.registry.to_unit(vector)
        self._xs.append(unit)
        self._ys.append(float(score))
        if score > self.best_score:
            self.best_score = float(score)
            self.best_unit = unit
            self._no_improve = 0
        else:
            self._no_improve += 1
        if self._no_improve >= self.patience or self.n_trials >= self.max_trials:
            self.done = True

    def best_vector(self) -> Dict[str, object]:
        if self.best_unit is None:
            return self.registry.canonical(self.registry.default_vector())
        return self.registry.canonical(self.registry.from_unit(self.best_unit))

    def history(self) -> List[Tuple[Dict[str, object], float]]:
        return [
            (self.registry.from_unit(x), y)
            for x, y in zip(self._xs, self._ys)
        ]

    # -- durability --------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able search state — what the control-plane journal
        persists so an adopted driver resumes the search instead of
        re-learning it."""
        return {
            "seed": self.seed,
            "max_trials": self.max_trials,
            "patience": self.patience,
            "knobs": self.registry.names,
            "xs": [list(x) for x in self._xs],
            "ys": list(self._ys),
            "best_score": (
                None if self.best_unit is None else self.best_score
            ),
            "best_unit": self.best_unit,
            "no_improve": self._no_improve,
            "done": self.done,
        }

    def load_state_dict(self, state: dict) -> None:
        """Adopt journaled search state. The knob-name list must match
        the live registry — a changed space makes the journaled unit
        vectors meaningless, so that mismatch raises instead of
        silently resuming a different search."""
        if list(state.get("knobs", [])) != self.registry.names:
            raise ValueError(
                f"journaled search space {state.get('knobs')} does not "
                f"match the live space {self.registry.names}"
            )
        self.seed = int(state["seed"])
        self.max_trials = int(state["max_trials"])
        self.patience = int(state["patience"])
        self._xs = [list(map(float, x)) for x in state["xs"]]
        self._ys = [float(y) for y in state["ys"]]
        best = state.get("best_score")
        self.best_unit = (
            None if state.get("best_unit") is None
            else list(map(float, state["best_unit"]))
        )
        self.best_score = (
            float("-inf") if best is None else float(best)
        )
        self._no_improve = int(state.get("no_improve", 0))
        self.done = bool(state.get("done", False))
