"""Elastic run loop: state-preserving restarts.

The port of the JAX package's ``elastic/run.py`` (Horovod's ``run_fn``):
the decorator wraps a training function so that

* ``HorovodInternalError`` (a failed collective, a guard escalation, an
  audit walk-back) restores the state to its last commit and retries;
* ``HostsUpdatedInterrupt`` (the topology changed) keeps the current
  state, which is intact, and retries;
* before every (re)start the state is ``sync()``'d from rank 0, so new
  or restarted workers join consistent.

``reset_limit`` bounds the restarts, as the launcher's flag does.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable

from ..exceptions import HorovodInternalError, HostsUpdatedInterrupt
from .state import State
from .worker import publish_clean_exit

__all__ = ["run"]

log = logging.getLogger("horovod_tpu_torch.elastic")


def run(func: Callable) -> Callable:
    """Decorator: ``@hvt.elastic.run`` ``def train(state, ...)``."""

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        reset_limit = kwargs.pop("reset_limit", None)
        notify = getattr(state, "on_reset", None)
        resets = 0
        skip_sync = False
        while True:
            if not skip_sync:
                state.sync()
            try:
                result = func(state, *args, **kwargs)
                publish_clean_exit()
                return result
            except HorovodInternalError:
                log.warning("collective failure; restoring last commit")
                state.restore()
                skip_sync = False
            except HostsUpdatedInterrupt as e:
                log.info("hosts updated; re-initializing")
                skip_sync = e.skip_sync
            resets += 1
            if reset_limit is not None and resets >= reset_limit:
                raise RuntimeError(
                    f"elastic reset limit {reset_limit} reached"
                )
            if notify:
                notify()

    return wrapper
