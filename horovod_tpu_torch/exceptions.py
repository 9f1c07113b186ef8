"""Exception types of the PyTorch package.

The same classes as ``horovod_tpu.exceptions`` (kept as a copy: this
package imports nothing of the JAX package), limited to what the serving
slice raises.
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
