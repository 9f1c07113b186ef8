"""Elastic training: the in-process half (state, run loop) and the
serving pool's scaling policy.

``State``/``ObjectState``/``TrainState`` and :func:`run` restore the last
commit after a ``HorovodInternalError`` and sync from rank 0 before every
(re)start. The elastic launcher -- rendezvous KV, heartbeat, round join,
preemption drain -- is A13b; until then :mod:`.worker`'s entry points are
no-ops outside an elastic launch.
"""

from .run import run  # noqa: F401
from .scale import QueueDepthPolicy  # noqa: F401
from .state import ObjectState, State, TrainState  # noqa: F401
from .worker import in_elastic_world, notification_manager  # noqa: F401
