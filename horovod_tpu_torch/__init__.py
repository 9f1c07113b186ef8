"""horovod_tpu_torch -- the PyTorch/CUDA port of horovod_tpu.

A second package beside the JAX one, which stays the reference it is held
against. This package imports ``torch``, ``numpy`` and the standard
library only -- never JAX, and nothing of ``horovod_tpu``.

This slice serves GPT-2 through :class:`~horovod_tpu_torch.serve.
ServePool` on an NVIDIA H100, with the flash-attention forward as a
hand-written CUDA kernel (``csrc/flash_fwd.cu``, built with nvcc at first
use). Entry points run on the card unless the caller passes
``device="cpu"``; without CUDA the default raises.
"""

from . import convert  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointWatcher,
    hot_swap_restore,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    verify_step_dir,
)
from .context import (  # noqa: F401
    device,
    init,
    is_initialized,
    local_rank,
    rank,
    resolve_device,
    shutdown,
    size,
)
from .exceptions import (  # noqa: F401
    CheckpointCorruptError,
    HorovodTpuError,
    NotInitializedError,
)
from .models import GPT2Config, GPT2LMModel, TransformerConfig  # noqa: F401
from .ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_reference,
    flash_attention_with_lse,
)
