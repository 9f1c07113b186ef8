"""The launcher: rendezvous KV, static and elastic launches.

The port of the JAX package's ``runner`` package (A13b). ``python -m
horovod_tpu_torch.runner.launch`` (console script ``hvdtpu-run-torch``)
launches one process per slot; :mod:`.elastic_driver` runs elastic jobs.
"""

from .hosts import HostInfo, SlotInfo, get_host_assignments, parse_hosts  # noqa: F401
from .api import run  # noqa: F401
