"""Ray cluster integration over the port's launcher (parity:
``horovod/ray/``, SURVEY.md §2.2; the port of ``horovod_tpu/ray``).

Actor-based placement and execution of port jobs on a Ray cluster:
``RayExecutor`` (reference ``horovod/ray/runner.py:250``),
``ElasticRayExecutor`` + ``RayHostDiscovery`` (``horovod/ray/elastic.py``).

Ray itself is an optional dependency, imported only where actors are
placed: every scheduling/rendezvous decision (rank assignment, env
construction, host discovery parsing) is pure Python and unit-testable
without a cluster.
"""

from .runner import (  # noqa: F401
    BaseRayWorker,
    Coordinator,
    NodeColocator,
    RayExecutor,
    RaySettings,
    ray_available,
)
from .elastic import ElasticRayExecutor, RayHostDiscovery  # noqa: F401
