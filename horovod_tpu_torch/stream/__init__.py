"""Live weight streaming: trainer → decode fleet, torn-set-proof.

The port of the JAX package's ``stream/`` (its frames byte for byte).

The online train-and-serve loop: the training plane
publishes versioned per-bucket weight deltas through the journaled
rendezvous KV at every ``HVDTPU_PUBLISH_EVERY`` committed steps, and
the serving plane applies them between decode rounds — continuously,
instead of per whole checkpoint.  The protocol guarantees the fleet
never serves a torn, unverified, or stale-epoch weight set; see
:mod:`~horovod_tpu_torch.stream.protocol` (framing),
:mod:`~horovod_tpu_torch.stream.publisher` (guard-gated, delta-encoded,
epoch-stamped publishes) and :mod:`~horovod_tpu_torch.stream.subscriber`
(stage → CRC-verify → atomic flip, with checkpoint fallback and guard
walk-back).
"""

from .protocol import TornSetError  # noqa: F401
from .publisher import (  # noqa: F401
    WeightPublisher,
    as_tree,
    activate,
    active,
    deactivate,
    enabled,
    on_commit,
)
from .subscriber import StreamSubscriber  # noqa: F401

__all__ = [
    "TornSetError",
    "WeightPublisher",
    "StreamSubscriber",
    "as_tree",
    "activate",
    "active",
    "deactivate",
    "enabled",
    "on_commit",
]
