"""Closed-loop autotuner: telemetry-driven knob search.

The port of the JAX package's ``tune/`` (Horovod's ``ParameterManager``,
arXiv:1802.05799 §5, rebuilt over the stack's own planes). The search,
the GP, the knob registry and the rollout protocol are plain Python, the
same code as the JAX package's, so a coordinator of either package drives
a client of the other over one KV; only the step wrapper touches torch:

* :mod:`~horovod_tpu_torch.tune.knobs` — typed registry over the
  ``utils/env.py`` knob declarations (range/choices, cost class,
  ``requires_retrace``);
* :mod:`~horovod_tpu_torch.tune.gp` / :mod:`~horovod_tpu_torch.tune.search` — the
  GP expected-improvement engine, semantically pinned against the
  native tuner with shared numeric fixtures, plus a categorical arm
  (:mod:`~horovod_tpu_torch.tune.topology` seeds the collective-layout choice
  from the mesh shape);
* :mod:`~horovod_tpu_torch.tune.scoring` — warmup-discarded windows over the
  existing step-time/MFU gauges (serving: the p95 latency histogram);
* :mod:`~horovod_tpu_torch.tune.rollout` — the lockstep rollout protocol:
  candidates ride the journaled HA KV plane, every rank switches on a
  published step boundary, retrace-requiring knobs ride the ordinary
  rescale/republish path, and a tuned config survives driver
  crash-adoption (resumed from journaled trial history, never
  re-learned).

Surfaces: ``HVDTPU_AUTOTUNE=1``, ``make_train_step(autotune=...)``,
``ServePool(autotune=...)``, the elastic driver's rollout, the launcher's
``--autotune``, the ``hvdtpu_top`` autotune panel, and ``chaos_soak.py
--scenario autotune``.

Differences from the JAX package: a step is timed with a
``torch.cuda.synchronize`` of its card while a window may be scoring (the
JAX package's ``block_until_ready``). As in the JAX package,
``HVDTPU_AUTOTUNE`` also arms the dynamic-enqueue runtime's own
ParameterManager (:mod:`horovod_tpu_torch.native.autotune`), which tunes
the runtime's fusion threshold and cycle time from rank 0's negotiated
bytes and syncs them to every rank each cycle; it shares this package's
GP (:mod:`.gp`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

from .gp import GaussianProcess, best_by_ei, expected_improvement  # noqa: F401
from .knobs import Knob, KnobRegistry, serve_space, training_space  # noqa: F401
from .rollout import (  # noqa: F401
    AutotuneClient,
    KVConfigSource,
    LocalConfigSource,
    RolloutCoordinator,
    SwitchAction,
)
from .scoring import ServeLatencyScorer, WindowScorer  # noqa: F401
from .search import AutotuneSearch  # noqa: F401
from .topology import choose_layout  # noqa: F401
from ..utils import env as _env


class AutotuneConfig:
    """Session parameters for one tuning run; every field defaults from
    the autotune env knobs (window/warmup/trials/patience/seed/subset).
    Pass in place of ``autotune=True`` to override programmatically."""

    def __init__(self, *, window_steps: Optional[int] = None,
                 warmup_steps: Optional[int] = None,
                 max_trials: Optional[int] = None,
                 patience: Optional[int] = None,
                 seed: Optional[int] = None,
                 knobs: Optional[Sequence[str]] = None):
        self.window_steps = window_steps
        self.warmup_steps = warmup_steps
        self.max_trials = max_trials
        self.patience = patience
        self.seed = seed
        self.knobs = tuple(knobs) if knobs is not None else None


def resolve(autotune) -> Optional[AutotuneConfig]:
    """Coerce a ``make_train_step(autotune=...)`` /
    ``ServePool(autotune=...)`` argument: None → env default, bool →
    on/off, config → itself."""
    if autotune is None:
        autotune = _env.autotune_default()
    if autotune is False:
        return None
    if autotune is True:
        return AutotuneConfig()
    if isinstance(autotune, AutotuneConfig):
        return autotune
    raise ValueError(
        f"autotune must be None/bool/AutotuneConfig, got {autotune!r}"
    )


class AutotunedStep:
    """A train step wrapped in the worker half of the closed loop.

    Times every call, feeds the window scorer, applies lockstep
    switches between steps, and rebuilds the compiled program when a
    ``requires_retrace`` knob changed (the rebuild re-reads the env the
    switch just wrote). Lint/memplan/trace surfaces delegate to the
    current inner step.
    """

    def __init__(self, build: Callable[[], tuple], registry: KnobRegistry,
                 client: AutotuneClient, device=None):
        self._build = build
        self.registry = registry
        self.autotune = client
        self.device = None if device is None else torch.device(device)
        self._inner, self.opt = build()
        self._n_retraces = 0

    def __getattr__(self, name):
        # lint/memplan/trace/guard_* ride through to the live inner step.
        return getattr(self._inner, name)

    def _preflight_rebuild(self, state, batch):
        """Re-certify after a retrace switch: every rank rebuilt from the
        env the lockstep switch just wrote, so their fingerprints must
        still agree. Published under a ``retrace<n>`` tag, so the rebuilt
        program's cert never races the pre-rebuild entry at the round's
        untagged key. The rebuilt step's own first-call latch is set here,
        so the gate runs once a rebuild, with the tag."""
        preflight = getattr(self._inner, "preflight", None)
        latch = getattr(self._inner, "_cert_latch", None)
        if preflight is None or latch is None:
            return
        latch["done"] = True
        preflight(state, batch, tag=f"retrace{self._n_retraces}")

    def __call__(self, state, batch):
        action = self.autotune.step_start()
        if action is not None and action.retrace:
            # The switch wrote the new knob values to the env; the
            # rebuild reads them. Cheap-only switches skip this.
            self._inner, self.opt = self._build()
            self._n_retraces += 1
            self._preflight_rebuild(state, batch)
        t0 = time.perf_counter()
        out = self._inner(state, batch)
        if (not self.autotune.done and self.device is not None
                and self.device.type == "cuda"):
            # Honest per-step timing while a window may be scoring:
            # without the sync, the asynchronous launches would time the
            # Python enqueue instead of the step. The eager CPU step has
            # run when it returns.
            torch.cuda.synchronize(self.device)
        self.autotune.step_end(time.perf_counter() - t0)
        return out


def attach_train_autotuner(build: Callable[[], tuple],
                           cfg: AutotuneConfig, *,
                           pinned: Sequence[str] = (),
                           mesh_shape: Optional[Dict[str, int]] = None,
                           cross_axes: Sequence[str] = (),
                           structure_locked: bool = False,
                           device=None,
                           ) -> Optional[AutotunedStep]:
    """Wrap a step builder in the tuning loop (the
    ``make_train_step(autotune=...)`` implementation).

    Under an elastic launcher the client follows the driver's
    :class:`RolloutCoordinator` through the KV plane (lockstep across
    ranks); standalone it runs its own :class:`LocalConfigSource`
    search. ``pinned`` names knobs the caller fixed explicitly — they
    leave the space (tuning a knob the build ignores scores noise); if
    nothing is left to tune, local mode returns None (the caller builds
    untuned, a warning says so) while elastic mode raises — the
    coordinator's shared space cannot be trimmed per-worker.
    ``structure_locked`` marks builds whose *optimizer state layout*
    depends on the bucket geometry (ZeRO-1 shards, fused updates,
    quantized EF residuals): the fusion threshold must not move mid-run
    there, so it is pinned like an explicit caller pin.
    """
    from ..elastic.worker import tune_config_source

    kv_source = tune_config_source()
    elastic = kv_source is not None
    mesh_shape = mesh_shape or {}
    all_pinned = list(pinned)
    layout = choose_layout(mesh_shape, cross_axes)
    if structure_locked:
        # ZeRO-1 shards / fused updates / quantized EF residuals bake
        # the bucket geometry into the optimizer STATE — the threshold
        # must not move mid-run.
        all_pinned.append(_env.FUSION_THRESHOLD)
    if elastic:
        # The coordinator owns the space; both sides must derive the
        # SAME registry from env alone — a caller pin here would make
        # the driver tune a knob this build provably ignores (every
        # retrace trial a full-world republish scoring pure noise), so
        # the conflict RAISES instead of degrading silently.
        registry = training_space(subset=cfg.knobs, layout_default=layout)
        conflict = sorted(set(all_pinned) & set(registry.names))
        if conflict:
            raise ValueError(
                f"autotune under an elastic driver: knob(s) {conflict} "
                "are pinned by this build (explicit threshold_bytes=/"
                "stagger=, or a sharded/fused_update/quantized-EF state "
                "layout) but sit in the coordinator's shared search "
                "space. Unpin them, or exclude them via "
                "HVDTPU_AUTOTUNE_KNOBS on every process. See "
                "docs/api.md 'Autotuning'."
            )
        source = kv_source
    else:
        try:
            registry = training_space(
                pinned=all_pinned, subset=cfg.knobs, layout_default=layout
            )
        except ValueError as e:
            # Every live knob pinned by the build (e.g. explicit
            # threshold_bytes= on a vanilla overlap-off step): nothing
            # to search. With HVDTPU_AUTOTUNE=1 armed globally this is
            # an expected shape, not an error — degrade to the plain
            # untuned step, loudly.
            import warnings

            warnings.warn(
                f"autotune requested but the search space is empty "
                f"({e}); building the step untuned", stacklevel=3,
            )
            return None
        search = AutotuneSearch(
            registry, seed=cfg.seed, max_trials=cfg.max_trials,
            patience=cfg.patience,
        )
        source = LocalConfigSource(search)
    scorer = WindowScorer(
        window_steps=cfg.window_steps, warmup_steps=cfg.warmup_steps
    )
    client = AutotuneClient(registry, source, scorer=scorer)
    return AutotunedStep(build, registry, client, device=device)


__all__ = [
    "AutotuneConfig",
    "AutotuneClient",
    "AutotuneSearch",
    "AutotunedStep",
    "GaussianProcess",
    "Knob",
    "KnobRegistry",
    "KVConfigSource",
    "LocalConfigSource",
    "RolloutCoordinator",
    "ServeLatencyScorer",
    "SwitchAction",
    "WindowScorer",
    "attach_train_autotuner",
    "best_by_ei",
    "choose_layout",
    "expected_improvement",
    "resolve",
    "serve_space",
    "training_space",
]
