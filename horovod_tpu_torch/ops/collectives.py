"""Collective operations on ``torch.distributed``.

The port of the JAX package's ``ops/collectives.py`` for one process per
card: where the JAX package lowers each collective to a ``jax.lax``
primitive inside its SPMD program, the port calls ``torch.distributed`` on
the default process group (NCCL on the card, gloo on the CPU; see
:func:`horovod_tpu_torch.context.init`). Without a process group the world
is one process and every collective is the identity (a copy); with one,
every call goes through ``torch.distributed``, a world of one included.

Reduction semantics follow the reference (``operations.cc:943-975``):
Average is a Sum followed by a division by the world size -- as the JAX
package computes it, and the form gloo supports -- and
``prescale_factor``/``postscale_factor`` multiply before and after the
reduction. Every function returns new tensors and leaves its inputs alone.

The public ``alltoall(splits)``, ``join`` and ``masked_allreduce`` are not
ported yet; :func:`alltoall_chunks` (equal chunks) carries the quantized
wire.
"""

from __future__ import annotations

import enum

import torch
import torch.distributed as dist

from ..exceptions import HorovodTpuError

__all__ = [
    "Average",
    "ReduceOp",
    "Sum",
    "allgather",
    "allreduce",
    "barrier",
    "broadcast",
    "reducescatter",
    "scale",
    "world_size",
    "world_rank",
]


class ReduceOp(enum.IntEnum):
    """Reduction ops; numeric values match the reference's C enum
    (``horovod/common/operations.cc:951-957``)."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_TORCH_OPS = {
    ReduceOp.AVERAGE: "SUM",
    ReduceOp.SUM: "SUM",
    ReduceOp.MIN: "MIN",
    ReduceOp.MAX: "MAX",
    ReduceOp.PRODUCT: "PRODUCT",
}


def world_size() -> int:
    """Processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def scale(x: torch.Tensor, factor) -> torch.Tensor:
    """``x * factor`` in ``x``'s dtype (integers scale in fp32); a factor
    of exactly 1 returns ``x`` itself."""
    if isinstance(factor, (int, float)) and factor == 1.0:
        return x
    if not x.is_floating_point():
        return (x.float() * factor).to(x.dtype)
    return x * torch.as_tensor(factor, dtype=x.dtype, device=x.device)


def divide_by_world(x: torch.Tensor, world: int) -> torch.Tensor:
    """The Average's division: floor division for integers."""
    if world == 1:
        return x
    if not x.is_floating_point():
        return torch.div(x, world, rounding_mode="floor")
    return x / world


def _torch_op(op: ReduceOp):
    if op not in _TORCH_OPS:
        raise NotImplementedError(
            f"op={ReduceOp(op).name} is not ported (Adasum waits for its "
            "own slice)"
        )
    return getattr(dist.ReduceOp, _TORCH_OPS[op])


def allreduce_(x: torch.Tensor, op: ReduceOp = Sum) -> torch.Tensor:
    """In-place reduction of ``x`` across the world (no scaling, no
    Average division): one ``all_reduce`` call."""
    if dist.is_initialized():
        dist.all_reduce(x, op=_torch_op(op))
    return x


def allreduce(
    tensor: torch.Tensor,
    *,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
) -> torch.Tensor:
    """Allreduce a tensor across the world (parity: ``hvd.allreduce``)."""
    torch_op = _torch_op(op)
    x = scale(tensor, prescale_factor)
    x = x.clone() if x is tensor else x
    if dist.is_initialized():
        dist.all_reduce(x, op=torch_op)
    if op == Average:
        x = divide_by_world(x, world_size())
    return scale(x, postscale_factor)


def allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 (every rank passes the
    same shape): ``[world * n, ...]``; a scalar counts as shape ``[1]``."""
    if tensor.dim() == 0:
        tensor = tensor[None]
    out = torch.empty(
        (world_size() * tensor.shape[0],) + tuple(tensor.shape[1:]),
        dtype=tensor.dtype, device=tensor.device,
    )
    return allgather_chunks(out, tensor.contiguous())


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """``root_rank``'s tensor on every rank."""
    if not 0 <= root_rank < world_size():
        raise HorovodTpuError(
            f"broadcast root_rank {root_rank} out of range for world size "
            f"{world_size()}"
        )
    x = tensor.clone()
    if dist.is_initialized():
        dist.broadcast(x, src=root_rank)
    return x


def reducescatter(tensor: torch.Tensor, *, op: ReduceOp = Sum) -> torch.Tensor:
    """Sum (or average) across the world and keep this rank's contiguous
    1/N slice of dim 0 (which the world size must divide)."""
    if op not in (Average, Sum):
        raise ValueError("reducescatter supports Average/Sum")
    world = world_size()
    if tensor.shape[0] % world:
        raise ValueError(
            f"dim 0 ({tensor.shape[0]}) is not a multiple of the world "
            f"size {world}"
        )
    out = reducescatter_chunks(tensor.contiguous())
    if op == Average:
        out = divide_by_world(out, world)
    return out


def barrier() -> None:
    """Wait for every rank."""
    if dist.is_initialized():
        dist.barrier()


def allgather_chunks(out: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """Fill ``out`` (``world`` equal chunks along dim 0) with every rank's
    ``shard``: one ``all_gather`` call into views of ``out`` (the list form
    every torch version takes without a deprecation warning). An fp8
    payload travels as a ``uint8`` view."""
    if not dist.is_initialized():
        return out.copy_(shard)
    dist.all_gather(list(_as_transport(out).chunk(world_size())),
                    _as_transport(shard))
    return out


def _as_transport(t: torch.Tensor) -> torch.Tensor:
    """fp8 travels as its bytes: gloo has no fp8 type."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8)
    return t


def alltoall_chunks(out: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """Send chunk ``r`` of ``buf`` (``world`` equal chunks along dim 0) to
    rank ``r`` and fill chunk ``r`` of ``out`` with rank ``r``'s chunk for
    this rank: one ``all_to_all_single`` call. An fp8 payload travels as a
    ``uint8`` view."""
    if not dist.is_initialized():
        return out.copy_(buf)
    dist.all_to_all_single(_as_transport(out), _as_transport(buf))
    return out


def reducescatter_chunks(buf: torch.Tensor) -> torch.Tensor:
    """Sum ``buf`` (``world`` equal chunks along dim 0) across the world
    and return this rank's chunk of the sum: one ``reduce_scatter`` call
    over views of ``buf``."""
    if not dist.is_initialized():
        return buf.clone()
    chunks = list(buf.chunk(world_size()))
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM)
    return out
