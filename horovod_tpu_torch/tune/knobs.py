"""Typed knob registry: the autotuner's search space, declared over the
``utils/env.py`` knob constants (the JAX package's ``tune/knobs.py``, the
same catalog, defaults and unit-cube mapping).

Every :class:`Knob` names an env-declared knob (``HVDTPU_<name>``), a
type (log-scaled range, linear range, bool, or categorical choice), and
a **cost class**: ``requires_retrace=True`` means applying a new value
invalidates the compiled step (the worker rebuilds through the ordinary
rescale/republish path), ``False`` means the value flips in place
between steps. The registry maps knob vectors to and from the
normalized ``[0,1]^d`` unit cube the GP searches (log-scale mapping for
range knobs, exactly the ``Normalize``/``Denormalize`` scheme of
``csrc/parameter_manager.cc``; categorical choices quantize the unit
interval, the search's "categorical arm").

A knob whose name is not declared in ``utils/env.py`` raises at
registry construction — the tuner must not be able to mutate an
undeclared (and therefore unlinted, undocumented) variable.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import env as _env


class Knob:
    """One tunable dimension.

    ``kind``:
      * ``"log_int"`` / ``"log_float"`` — range ``[lo, hi]`` searched in
        log space (the fusion-threshold/cycle-time mapping);
      * ``"int"`` / ``"float"`` — linear range;
      * ``"bool"`` — two-way choice;
      * ``"choice"`` — categorical over ``choices``.
    """

    __slots__ = ("name", "kind", "lo", "hi", "choices", "default",
                 "requires_retrace", "doc")

    def __init__(self, name: str, kind: str, *, lo: float = 0.0,
                 hi: float = 0.0, choices: Sequence = (),
                 default=None, requires_retrace: bool = False,
                 doc: str = ""):
        if kind not in ("log_int", "log_float", "int", "float", "bool",
                        "choice"):
            raise ValueError(f"unknown knob kind {kind!r}")
        if kind in ("log_int", "log_float"):
            if not (0 < lo < hi):
                raise ValueError(
                    f"log knob {name} needs 0 < lo < hi, got [{lo}, {hi}]"
                )
        elif kind in ("int", "float"):
            if not lo < hi:
                raise ValueError(
                    f"knob {name} needs lo < hi, got [{lo}, {hi}]"
                )
        if kind == "bool":
            choices = (False, True)
        if kind == "choice" and len(choices) < 2:
            raise ValueError(f"choice knob {name} needs >= 2 choices")
        self.name = name
        self.kind = kind
        self.lo = float(lo)
        self.hi = float(hi)
        self.choices = tuple(choices)
        self.default = default
        self.requires_retrace = requires_retrace
        self.doc = doc

    # -- unit-cube mapping (parameter_manager.cc Normalize/Denormalize) --

    def to_unit(self, value) -> float:
        if self.kind in ("bool", "choice"):
            try:
                idx = self.choices.index(value)
            except ValueError:
                raise ValueError(
                    f"{self.name}: {value!r} not in {self.choices}"
                ) from None
            k = len(self.choices)
            return idx / (k - 1) if k > 1 else 0.0
        v = float(value)
        if self.kind in ("log_int", "log_float"):
            u = math.log(max(v, self.lo) / self.lo) / math.log(self.hi / self.lo)
        else:
            u = (v - self.lo) / (self.hi - self.lo)
        return min(1.0, max(0.0, u))

    def from_unit(self, u: float):
        u = min(1.0, max(0.0, float(u)))
        if self.kind in ("bool", "choice"):
            k = len(self.choices)
            # Quantize the unit interval into k equal bins: the GP's
            # continuous proposal lands on exactly one category.
            idx = min(k - 1, int(u * k))
            return self.choices[idx]
        if self.kind in ("log_int", "log_float"):
            v = self.lo * math.exp(u * math.log(self.hi / self.lo))
        else:
            v = self.lo + u * (self.hi - self.lo)
        return int(round(v)) if self.kind in ("log_int", "int") else v

    def env_encode(self, value) -> str:
        if self.kind == "bool":
            return "1" if value else "0"
        return str(value)


class KnobRegistry:
    """An ordered knob set = the search space of one tuning session."""

    def __init__(self, knobs: Sequence[Knob]):
        if not knobs:
            raise ValueError("empty search space")
        declared = _env.declared_env_vars()
        for k in knobs:
            if "HVDTPU_" + k.name not in declared:
                raise ValueError(
                    f"knob {k.name} is not declared in utils/env.py "
                    "(declare it before tuning it — the env/docs lints "
                    "must know every mutable variable)"
                )
        names = [k.name for k in knobs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate knobs in space: {names}")
        self.knobs: Tuple[Knob, ...] = tuple(knobs)

    @property
    def dims(self) -> int:
        return len(self.knobs)

    @property
    def names(self) -> List[str]:
        return [k.name for k in self.knobs]

    def default_vector(self) -> Dict[str, object]:
        return {k.name: k.default for k in self.knobs}

    def to_unit(self, vector: Dict[str, object]) -> List[float]:
        return [k.to_unit(vector[k.name]) for k in self.knobs]

    def from_unit(self, unit: Sequence[float]) -> Dict[str, object]:
        if len(unit) != self.dims:
            raise ValueError(f"expected {self.dims} dims, got {len(unit)}")
        return {k.name: k.from_unit(u) for k, u in zip(self.knobs, unit)}

    def canonical(self, vector: Dict[str, object]) -> Dict[str, object]:
        """Round-trip through the unit cube: the value every rank (and
        the journal) stores for a candidate, so float formatting can
        never make two ranks disagree about 'the same' vector."""
        return self.from_unit(self.to_unit(vector))

    def retrace_changed(self, old: Optional[Dict], new: Dict) -> bool:
        """Does switching ``old -> new`` invalidate the compiled step?"""
        if old is None:
            return False
        return any(
            k.requires_retrace and old.get(k.name) != new.get(k.name)
            for k in self.knobs
        )

    def apply(self, vector: Dict[str, object],
              setters: Optional[Dict[str, Callable]] = None,
              env: bool = True) -> None:
        """Flip the process onto ``vector``: every knob lands in
        ``os.environ`` (``HVDTPU_<name>``) so any later env read — a
        step rebuild, a prefetch iterator, a child process — sees it;
        ``setters`` additionally pushes cheap knobs into live objects
        (e.g. a dispatcher's ``batch_timeout_ms``) in place.
        ``env=False`` skips the environ write for tuners whose knobs
        live entirely in one object's attributes (the serve tuner: two
        pools in one process must not seed each other's searches
        through a shared environ)."""
        for k in self.knobs:
            val = vector[k.name]
            if env:
                os.environ["HVDTPU_" + k.name] = k.env_encode(val)
            if setters and k.name in setters:
                setters[k.name](val)


# ---- standard spaces -----------------------------------------------------

MB = 1024 * 1024


def training_space(pinned: Sequence[str] = (),
                   subset: Optional[Sequence[str]] = None,
                   layout_default: str = "flat") -> KnobRegistry:
    """The training-plane search space.

    The **catalog** holds every declared training knob; the **default
    selection** is only the knobs a vanilla build provably consumes per
    step: the fusion threshold always (``threshold_bytes=None`` reads
    the env at build), stagger only when the overlap pipeline is armed
    (``HVDTPU_OVERLAP=1`` — without it the env default is inert).
    ``HVDTPU_AUTOTUNE_KNOBS`` / ``subset`` can select ANY catalog knob,
    including the two that are opt-in by design:

    * ``PREFETCH_DEPTH`` — read once when ``prefetch_to_device`` wraps
      an iterator, so a mid-run flip only reaches iterators created
      *after* the switch (per-trial iterator loops; not the common
      long-lived-iterator shape);
    * ``COLLECTIVE_LAYOUT`` — the topology-seeded categorical arm.
      Nothing in the step consumes it (the hierarchical wire is
      ``init(hierarchical=True)``'s mesh, not a knob): tuning it *records*
      the measured preference next to the :func:`~horovod_tpu_torch.tune.
      topology.choose_layout` prior rather than changing the schedule.

    ``pinned`` removes knobs the caller fixed explicitly (an explicit
    ``make_train_step(stagger=True)`` beats the tuner — tuning a knob
    the build ignores would score noise). ``layout_default`` seeds the
    layout arm (callers pass ``choose_layout``'s verdict for the mesh).
    """
    knobs = [
        Knob(_env.FUSION_THRESHOLD, "log_int", lo=1 * MB, hi=512 * MB,
             default=_env.fusion_threshold_bytes(), requires_retrace=True,
             doc="gradient-fusion bucket threshold (bytes)"),
        Knob(_env.OVERLAP_STAGGER, "bool",
             default=_env.overlap_stagger(), requires_retrace=True,
             doc="per-bucket staggered collective dispatch"),
        Knob(_env.PREFETCH_DEPTH, "int", lo=1, hi=4,
             default=_env.prefetch_depth(), requires_retrace=False,
             doc="host->device prefetch buffer depth (opt-in: reaches "
                 "only iterators created after a switch)"),
        Knob(_env.COLLECTIVE_LAYOUT, "choice",
             choices=("flat", "hierarchical"), default=layout_default,
             requires_retrace=True,
             doc="collective layout (topology-seeded categorical arm; "
                 "opt-in until the hierarchical wire consumes it)"),
        # Low-precision compute arms: opt-in by design. Flipping either
        # rebuilds the whole step (retrace class) and — for fp8 — the
        # PARAM TREE (fp8_* scale-state leaves join at init), so only a
        # worker that rebuilds model+state per trial may select them;
        # the in-place rescale path cannot honor a mid-run flip.
        Knob(_env.COMPUTE_DTYPE, "choice", choices=("", "fp8"),
             default=_env.compute_dtype_mode(), requires_retrace=True,
             doc="fp8 training matmuls (opt-in: per-trial model+state "
                 "rebuild required — the fp8 scale state changes the "
                 "param tree)"),
        Knob(_env.ACT_QUANT, "choice", choices=("", "int8"),
             default=_env.act_quant_mode(), requires_retrace=True,
             doc="int8 storage of remat'd activations (opt-in: scores "
                 "step time only — the HBM saving it buys shows up as "
                 "batch headroom, which the tuner does not search)"),
    ]
    if subset is None and not _env.autotune_knobs():
        default_names = {_env.FUSION_THRESHOLD}
        if _env.overlap_default():
            default_names.add(_env.OVERLAP_STAGGER)
        knobs = [k for k in knobs if k.name in default_names]
    return _filter_space(knobs, pinned, subset)


def serve_space(pinned: Sequence[str] = (),
                subset: Optional[Sequence[str]] = None,
                defaults: Optional[Dict[str, float]] = None) -> KnobRegistry:
    """The serving-plane search space (the ``ServePool`` twin): batch
    fill window against the p95 latency histogram, plus the autoscaler
    watermarks. All cheap — they flip in place on the live
    dispatcher/policy. ``defaults`` overrides knob defaults with the
    POOL'S live configured values (the incumbent trial 0 measures must
    be the config actually running, not the env's idea of it)."""
    defaults = defaults or {}

    def dflt(name, fallback):
        return defaults.get(name, fallback)

    knobs = [
        Knob(_env.SERVE_BATCH_TIMEOUT_MS, "log_float", lo=0.1, hi=50.0,
             default=max(0.1, dflt(_env.SERVE_BATCH_TIMEOUT_MS,
                                   _env.serve_batch_timeout_ms())),
             doc="continuous-batching fill window (ms)"),
        Knob(_env.SERVE_QUEUE_HIGH, "float", lo=1.0, hi=16.0,
             default=dflt(_env.SERVE_QUEUE_HIGH, _env.serve_queue_high()),
             doc="per-worker backlog -> scale up"),
        # low's range sits strictly under high's floor (1.0) so no
        # candidate can invert the policy's low < high invariant.
        Knob(_env.SERVE_QUEUE_LOW, "float", lo=0.1, hi=0.95,
             default=min(0.95, dflt(_env.SERVE_QUEUE_LOW,
                                    _env.serve_queue_low())),
             doc="per-worker backlog -> scale down"),
    ]
    return _filter_space(knobs, pinned, subset)


def _filter_space(knobs: List[Knob], pinned: Sequence[str],
                  subset: Optional[Sequence[str]]) -> KnobRegistry:
    if subset is None:
        subset = _env.autotune_knobs() or None
    if subset is not None:
        known = {k.name for k in knobs}
        unknown = [n for n in subset if n not in known]
        if unknown:
            raise ValueError(
                f"HVDTPU_AUTOTUNE_KNOBS names unknown knob(s) {unknown}; "
                f"this space has {sorted(known)}"
            )
        knobs = [k for k in knobs if k.name in subset]
    knobs = [k for k in knobs if k.name not in set(pinned)]
    if not knobs:
        raise ValueError(
            "autotune search space is empty (every knob pinned or "
            "filtered away)"
        )
    return KnobRegistry(knobs)
