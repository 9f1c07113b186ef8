"""Worker side of an elastic launch: the in-process part.

The port of the part of the JAX package's ``elastic/worker.py`` that a
training process calls without a launcher. Outside an elastic launch
(``HVDTPU_ELASTIC=1`` with the rendezvous address in
``HVDTPU_RENDEZVOUS_ADDR`` / ``_PORT``) each entry is a no-op, as in the
reference: :func:`publish_clean_exit` returns, and
:data:`notification_manager` starts no watcher. Inside one they raise
``NotImplementedError``: the rendezvous KV client, the heartbeat,
``join_world``, the preemption drain and the membership watcher come with
the elastic launcher (A13b).
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = [
    "WorkerNotificationManager",
    "in_elastic_world",
    "notification_manager",
    "publish_clean_exit",
]

# Env contract with the elastic launcher.
ENV_ELASTIC = "HVDTPU_ELASTIC"
ENV_HOST_ID = "HVDTPU_HOST_ID"

_WAITING = ("the elastic launcher's worker plane (rendezvous KV, heartbeat, "
            "round join, preemption drain) is not ported yet; it arrives "
            "with A13b")


def in_elastic_world() -> bool:
    """True when this process runs under an elastic launcher."""
    return (os.environ.get(ENV_ELASTIC) == "1"
            and bool(os.environ.get("HVDTPU_RENDEZVOUS_ADDR"))
            and bool(os.environ.get("HVDTPU_RENDEZVOUS_PORT")))


def publish_clean_exit(host_id: Optional[str] = None) -> None:
    """Flag a clean exit to the elastic launcher (``exit/<host_id>``), so
    a launcher that adopted this worker tells a finished worker from a
    crashed one. A no-op outside an elastic launch."""
    del host_id
    if not in_elastic_world():
        return
    raise NotImplementedError(f"publish_clean_exit: {_WAITING}")


class WorkerNotificationManager:
    """Delivers the launcher's membership changes to elastic states
    (``state.on_hosts_updated(timestamp, res)``). Outside an elastic launch
    :meth:`init` starts nothing and returns False."""

    def init(self) -> bool:
        if not in_elastic_world():
            return False
        raise NotImplementedError(f"notification_manager.init: {_WAITING}")


notification_manager = WorkerNotificationManager()
