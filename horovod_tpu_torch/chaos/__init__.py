"""Deterministic, seeded fault injection (the chaos plane).

The port of the JAX package's ``chaos`` package. Named fault **sites** sit
in the code paths that must survive them; a schedule (grammar in
:mod:`.schedule`) arms faults at them, reproducibly, so a test proves
recovery instead of assuming it. The sites wired in the port:

====================  ====================================================
``worker.step``       every elastic ``State.commit``
``worker.preempt``    every elastic ``State.commit`` (a real SIGTERM)
``ckpt.write``        checkpoint serialization, before the atomic rename
``kv.request``        every rendezvous KV request (drop / 5xx / delay)
``kv.server``         the elastic driver's poll loop (KV listener restart)
``driver.crash``      the elastic driver's poll loop (driver dies hard)
``serve.request``     serving-request ingress (``Dispatcher.submit``)
``serve.dispatch``    a serving worker's leased batch (``ServePool`` and
                      the KV transport's worker loop)
``serve.decode``      a decode worker's round (kills or stalls the worker
                      mid-sequence; its streams must resume elsewhere)
``grad.nan``          guarded train step: NaN-poison one batch element
``grad.bitflip``      guarded train step: flip one seeded parameter bit
``param.corrupt``     guarded train step: perturb a seeded parameter span
====================  ====================================================

The rest of the catalog (``eager.dispatch``, ``publish.delta``) parses and
waits for the code that reaches it.

Arming: set ``HVDTPU_CHAOS`` to a schedule string -- parsed once, at the
first site hit -- or call :func:`plan`. ``HVDTPU_CHAOS_SEED`` seeds every
probabilistic rule so a failing run replays exactly. With nothing armed,
every site is one module-level check (:func:`enabled`).

Sites call :func:`act`: the generic actions (``delay``/``slow`` sleep,
``crash`` exits hard, ``hang`` freezes the process) execute inline and
return None; site-specific ones (``drop``, ``corrupt``, ``truncate``,
``nan``, ``bitflip``) are returned for the site to interpret. Every fire
counts into :data:`fired` (by site).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Dict, Optional

from .schedule import SITES, Action, ChaosSpecError, Plan, parse
from ..utils import env as _env

__all__ = [
    "SITES", "Action", "ChaosSpecError", "Plan",
    "enabled", "plan", "clear", "act", "action", "fired",
]

log = logging.getLogger("horovod_tpu_torch.chaos")

_plan: Optional[Plan] = None
# False until HVDTPU_CHAOS has been read once; afterwards the disabled path
# is one global load and identity check.
_env_checked = False
# Fires by site since import (or _reset_for_tests).
fired: Dict[str, int] = {}
_fired_lock = threading.Lock()


def enabled() -> bool:
    """Is any schedule armed? The guard every site checks first."""
    if _plan is not None:
        return True
    if not _env_checked:
        _arm_from_env()
        return _plan is not None
    return False


def _arm_from_env() -> None:
    global _env_checked, _plan
    _env_checked = True
    spec = _env.get_str(_env.CHAOS, "") or ""
    if spec.strip():
        seed = _env.get_int(_env.CHAOS_SEED, 0)
        _plan = parse(spec, seed=seed)
        log.warning("chaos armed from env (seed=%d): %s", seed, spec)


def plan(spec: str, *, seed: Optional[int] = None) -> Plan:
    """Arm a schedule programmatically (overrides ``HVDTPU_CHAOS``)."""
    global _plan, _env_checked
    _env_checked = True
    _plan = parse(spec, seed=seed if seed is not None
                  else _env.get_int(_env.CHAOS_SEED, 0))
    return _plan


def clear() -> None:
    """Disarm. The env is not read again until :func:`_reset_for_tests`."""
    global _plan, _env_checked
    _plan = None
    _env_checked = True


def _reset_for_tests() -> None:
    """Forget everything, the env-was-read latch and the counts too."""
    global _plan, _env_checked
    _plan = None
    _env_checked = False
    with _fired_lock:
        fired.clear()


def _identity() -> Dict[str, object]:
    ident: Dict[str, object] = {}
    host = os.environ.get("HVDTPU_HOST_ID")
    if host:
        ident["host"] = host
    spawn = os.environ.get("HVDTPU_SPAWN_ROUND")
    if spawn is not None:
        try:
            ident["spawn"] = int(spawn)
        except ValueError:
            pass
    return ident


def action(site: str, **ctx) -> Optional[Action]:
    """Pure match: the Action a site should suffer now, else None.
    Advances the matching rules' occurrence counters."""
    if not enabled():
        return None
    if site not in SITES:
        raise ChaosSpecError(f"unknown chaos site {site!r}")
    full = _identity()
    full.update(ctx)
    act_ = _plan.match(site, full)
    if act_ is not None:
        with _fired_lock:
            fired[site] = fired.get(site, 0) + 1
        log.warning("chaos: firing %s at %s (ctx=%s)", act_, site, ctx)
    return act_


def act(site: str, **ctx) -> Optional[Action]:
    """Match and execute the generic actions inline; return the
    site-specific ones for the caller to interpret."""
    act_ = action(site, **ctx)
    if act_ is None:
        return None
    if act_.kind in ("delay", "slow"):
        time.sleep(float(act_.value))
        return None
    if act_.kind == "crash":
        print(f"horovod_tpu_torch.chaos: injected crash at {site}",
              file=sys.stderr, flush=True)
        os._exit(1)
    if act_.kind == "hang":
        _hang(site)
    return act_


def _hang(site: str) -> None:
    """A hard process hang: the heartbeat stops too (a frozen process
    beats nothing), so the elastic driver's lease expiry -- not the
    end-of-job drain deadline -- is what must catch it; the process sleeps
    until something kills it."""
    print(f"horovod_tpu_torch.chaos: injected hang at {site}",
          file=sys.stderr, flush=True)
    from ..elastic import worker as _worker

    _worker.heartbeat_pause()
    while True:
        time.sleep(60.0)
