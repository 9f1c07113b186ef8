"""Hierarchical all-reduce: a reduce-scatter inside the host, an
all-reduce of the shard across hosts, an all-gather inside the host -- the
port of the JAX package's ``parallel/hierarchical.py``.

The levels are the ``(cross, local)`` axes that ``init(hierarchical=True)``
builds (:mod:`.mesh`): ``local`` the processes of a host (NVLink on the
card), ``cross`` one process a host (the network). The cross-host hop
moves ``1 / local_size`` of the bytes, as in the reference Horovod's
``NCCLHierarchicalAllreduce``.
"""

from __future__ import annotations

import torch

from ..ops import collectives as _coll
from ..ops.collectives import Average, ReduceOp, Sum

__all__ = ["hierarchical_allreduce"]


def hierarchical_allreduce(x: torch.Tensor, *, local_axis: str = "local",
                           cross_axis: str = "cross",
                           op: ReduceOp = Average) -> torch.Tensor:
    """``allreduce(x, axis=(cross, local))`` as reduce-scatter (local) ->
    all-reduce (cross) -> all-gather (local). Any shape: flattened and
    padded to a multiple of the local size. Sum or Average (integers
    divide by floor). Returns a new tensor."""
    if op not in (Sum, Average):
        raise ValueError("hierarchical_allreduce supports Sum/Average")
    nl = _coll.world_size(local_axis)
    world = nl * _coll.world_size(cross_axis)
    flat = x.reshape(-1)
    size = flat.shape[0]
    padded = -(-size // nl) * nl
    if padded != size:
        flat = torch.cat([flat, flat.new_zeros(padded - size)])
    shard = _coll.reducescatter_chunks(flat.contiguous(), axis=local_axis)
    _coll.allreduce_(shard, Sum, axis=cross_axis)
    full = _coll.allgather_chunks(flat.new_empty(padded), shard,
                                  axis=local_axis)
    out = full[:size].reshape(x.shape)
    if op == Average:
        out = _coll.divide_by_world(out, world)
    return out
