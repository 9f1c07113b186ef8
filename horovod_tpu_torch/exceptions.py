"""Exception types of the PyTorch package.

The same classes as ``horovod_tpu.exceptions`` (kept as a copy: this
package imports nothing of the JAX package), limited to what the ported
slices raise.
"""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class NotInitializedError(HorovodTpuError):
    """An API that requires ``horovod_tpu_torch.init()`` was called before
    init."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call horovod_tpu_torch.init() "
            "first."
        )


class HorovodInternalError(HorovodTpuError):
    """A collective failed, or the gradient guard or the consistency audit
    gave up on the live state. :func:`horovod_tpu_torch.elastic.run`
    catches it, restores the last committed state and restarts the
    training loop."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """The set of hosts changed. Carries ``skip_sync`` so a rank that knows
    its state is identical can skip the re-broadcast."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class CheckpointCorruptError(HorovodTpuError):
    """An explicitly-requested checkpoint step failed integrity checks.

    Raised only when the caller pinned ``step=``: the latest-step restore
    path never raises this — it quarantines the corrupt directory and
    walks back to the newest intact step instead.
    """

    def __init__(self, path: str, problems):
        self.path = path
        self.problems = list(problems)
        detail = "; ".join(self.problems[:3])
        super().__init__(f"checkpoint {path} failed integrity check: {detail}")
