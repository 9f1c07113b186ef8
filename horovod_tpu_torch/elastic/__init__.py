"""Elastic training: state, run loop, the worker's half of the elastic
launcher, and the serving pool's scaling policy.

``State``/``ObjectState``/``TrainState`` and :func:`run` restore the last
commit after a ``HorovodInternalError`` and sync from rank 0 before every
(re)start. Under the elastic launcher (:mod:`horovod_tpu_torch.runner.
elastic_driver`) :mod:`.worker` joins the driver's rounds, beats the
heartbeat lease, watches for membership changes and drains on a
preemption notice; outside one its entry points are no-ops.
"""

from .run import run  # noqa: F401
from .scale import PolicyDiscovery, QueueDepthPolicy  # noqa: F401
from .state import ObjectState, State, TrainState  # noqa: F401
from .worker import in_elastic_world, notification_manager  # noqa: F401
