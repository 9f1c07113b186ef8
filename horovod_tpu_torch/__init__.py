"""horovod_tpu_torch -- the PyTorch/CUDA port of horovod_tpu.

A second package beside the JAX one, which stays the reference it is held
against. This package imports ``torch``, ``numpy`` and the standard
library only -- never JAX, and nothing of ``horovod_tpu``.

Its model zoo is the JAX package's: GPT-2, BERT, ViT, an MLP, ResNet (with
cross-replica BatchNorm) and a Switch MoE, with per-block or whole-loss
rematerialization and a chunked cross-entropy for large vocabularies; its
input path shards, resumes and prefetches batches (:mod:`.data`).

Its collectives run on ``torch.distributed`` over named mesh axes
(``init(mesh=..., hierarchical=...)``, ``axis=``), with Adasum, uneven
allgather and alltoall, and the object and state broadcasts of a Horovod
script's start (:mod:`.functions`).

It serves GPT-2 through :class:`~horovod_tpu_torch.serve.ServePool` and
trains it data-parallel through :func:`~horovod_tpu_torch.parallel.dp.
make_train_step` (replicated, or ZeRO-1 sharded with the fused AdamW
update; the gradient wire uncompressed, cast, or blockwise-quantized to
int8/fp8 with error feedback; each bucket reduced from the gradient hooks
on a side stream with ``overlap=True``; the projections in bf16 or, with
``compute_dtype="fp8"``, in fp8 under delayed scaling; the activations the
backward keeps as int8 with ``act_quant="int8"``) on NVIDIA H100s,
with checkpoints that restore at another world size or fusion threshold;
``ServePool(weight_dtype="int8")`` serves int8 weights with per-column
scales, and :class:`~horovod_tpu_torch.serve.DecodeEngine` decodes token by
token over a paged, optionally int8, KV cache. Its kernels are hand-written CUDA C++ under ``csrc/`` (the
flash-attention forward and backward, the fused AdamW update, the blockwise
quantize and dequantize, the fp8 matmul, the int8-weight matmul), built with
nvcc at first use. Entry points run on the card unless
the caller passes ``device="cpu"``; without CUDA the default raises.

Its fault planes: ``make_train_step(guard=True)`` skips a step whose
gradients are poisoned or spike (:mod:`.guard`, with the consistency
audit), :mod:`.chaos` injects seeded faults at named sites, and
:mod:`.elastic` restores the last commit after a recoverable error.
Parameters also take DTensor placements over a device mesh
(:mod:`.parallel.gspmd`).
"""

from . import chaos, convert, elastic, guard  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointWatcher,
    hot_swap_restore,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    verify_step_dir,
)
from .context import (  # noqa: F401
    cross_rank,
    cross_size,
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    mesh,
    rank,
    resolve_device,
    shutdown,
    size,
    world_axes,
)
from .exceptions import (  # noqa: F401
    CheckpointCorruptError,
    HorovodInternalError,
    HorovodTpuError,
    HostsUpdatedInterrupt,
    NotInitializedError,
)
from .data import (  # noqa: F401
    ShardedBatches,
    ShardedIndexSampler,
    prefetch_to_device,
)
from .models import (  # noqa: F401
    MLP,
    BertConfig,
    BertModel,
    GPT2Config,
    GPT2LMModel,
    MoEConfig,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
    SwitchTransformerLM,
    TransformerConfig,
    ViT,
    ViTConfig,
)
from .functions import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
    broadcast_variables,
)
from .ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
    allgather,
    allreduce,
    alltoall,
    barrier,
    broadcast,
    grouped_allgather,
    grouped_allreduce,
    grouped_reducescatter,
    join,
    masked_allreduce,
    ppermute,
    reducescatter,
)
from .ops.compression import Compression  # noqa: F401
from .ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_reference,
    flash_attention_with_lse,
)
from .ops.fp8 import (  # noqa: F401
    Fp8Linear,
    fp8_state_gauges,
    fp8_state_optimizer,
    has_fp8_state,
)
from .ops.quantization import (  # noqa: F401
    QuantizedWeight,
    dequantize_weight,
    int8_weight_matmul,
    qmatmul,
    quantize_params,
    quantize_weight,
)
from .ops.losses import (  # noqa: F401
    cross_entropy_logits_reference,
    fused_cross_entropy,
)
from .ops.remat import checkpoint_fn, remat_module, resolve_policy  # noqa: F401
from .obs.overlap import record_overlap_pair, ring_allreduce_ms  # noqa: F401
from .ops.fusion import (  # noqa: F401
    fused_allgather,
    fused_allreduce,
    fused_reducescatter,
    quantized_fused_allreduce,
    quantized_fused_reducescatter,
)
from .optimizer import (  # noqa: F401
    DistributedOptimizer,
    ShardedDistributedOptimizer,
    adamw,
    fused_adamw,
    grad,
    reshard_opt_state,
    sgd,
    unshard_opt_state,
    value_and_grad,
)
from .parallel.dp import TrainState, init_state, make_train_step  # noqa: F401
from .parallel.mesh import build_mesh  # noqa: F401
