"""The PyTorch frontend: the reference's ``horovod.torch`` surface on the
port's dynamic-enqueue runtime (:mod:`horovod_tpu_torch.native`).

The port of the JAX package's ``horovod_tpu/torch/``:

* handle-based async collectives -- :mod:`.mpi_ops`
  (``horovod/torch/mpi_ops.py``), CUDA tensors on the runtime's NCCL
  group, CPU tensors on its gloo group;
* the hook-driven ``DistributedOptimizer`` with
  ``backward_passes_per_step`` and Adasum -- :mod:`.optimizer`;
* ``Compression`` -- :mod:`.compression`;
* ``SyncBatchNorm`` -- :mod:`.sync_batch_norm`;
* ``broadcast_parameters`` / ``broadcast_optimizer_state`` /
  ``broadcast_object`` / ``allgather_object`` -- :mod:`.functions`;
* elastic ``TorchState`` / ``ElasticSampler`` -- :mod:`.elastic`.

Usage, in the reference's shape::

    import horovod_tpu_torch.torch as hvd

    hvd.init()                      # the card; hvd.init(device="cpu")
    model = ...
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4 * hvd.size())
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
"""

from .mpi_ops import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    Sum,
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    barrier,
    start_timeline,
    stop_timeline,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    cross_rank,
    cross_size,
    grouped_allreduce,
    grouped_allreduce_,
    grouped_allreduce_async,
    grouped_allreduce_async_,
    init,
    is_initialized,
    join,
    local_rank,
    local_size,
    poll,
    rank,
    reducescatter,
    reducescatter_async,
    shutdown,
    size,
    synchronize,
)
from .compression import Compression  # noqa: F401
from .optimizer import DistributedOptimizer  # noqa: F401
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
from .functions import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from . import elastic  # noqa: F401
