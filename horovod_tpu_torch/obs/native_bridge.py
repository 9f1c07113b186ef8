"""Read the dynamic-enqueue runtime's counters into the obs plane.

The port of the JAX package's ``obs/native_bridge.py``. The runtime
(:mod:`horovod_tpu_torch.native`) keeps process-cumulative counters of
its background loop; this module is passive: it never starts the runtime,
and before a runtime ran in this process there is nothing to report and
:func:`read_native` returns ``{}``, so a job that never used the eager
path pays nothing for the bridge.
"""

from __future__ import annotations

import sys
from typing import Dict, Union


def read_native() -> Dict[str, Union[int, float]]:
    """Snapshot of the runtime's counters (plus its wire bytes) under the
    JAX package's names, or ``{}`` when no runtime ran in this process."""
    native = sys.modules.get("horovod_tpu_torch.native")
    counters = native.metrics_counters() if native is not None else {}
    if not counters.get("cycles"):
        return {}
    out: Dict[str, Union[int, float]] = {
        f"native.{short}": counters[short] for short in native.METRICS_ABI}
    sent, recv = native.wire_bytes()
    out["native.tcp_bytes_sent"] = sent
    out["native.tcp_bytes_received"] = recv
    hits = out["native.cache_hits"]
    misses = out["native.cache_misses"]
    if hits + misses:
        out["native.cache_hit_rate"] = round(hits / (hits + misses), 6)
    return out
