"""Collective operations on ``torch.distributed``.

The port of the JAX package's ``ops/collectives.py`` (and of the uneven
exchanges its process path, ``ops/eager.py``, serves) for one process per
card: where the JAX package lowers each collective to a ``jax.lax``
primitive inside its SPMD program, the port calls ``torch.distributed``
(NCCL on the card, gloo on the CPU; see
:func:`horovod_tpu_torch.context.init`). ``axis=`` names the mesh axes the
collective runs over -- this process's group along them
(:func:`~horovod_tpu_torch.context.axis_group`); ``None`` is the world
axes. Without a process group, or on a group of one process other than
the world, every collective is the identity (a copy); the world's group
goes through ``torch.distributed`` even at one process.

Reduction semantics follow the reference (``operations.cc:943-975``):
Average is a Sum followed by a division by the group's size -- as the JAX
package computes it, and the form gloo supports -- and
``prescale_factor``/``postscale_factor`` multiply before and after the
reduction; Adasum reduces through :mod:`.adasum`. Every function returns
new tensors and leaves its inputs alone.

The uneven exchanges negotiate first, as the reference's controller does:
:func:`allgather` exchanges every rank's first dimension (with its
trailing shape and dtype, so a mismatch raises ``HorovodTpuError`` on
every rank instead of aborting the process group), and
:func:`alltoall` exchanges the split table. :func:`join` goes to the
dynamic-enqueue runtime (:mod:`horovod_tpu_torch.native`) when it is up
and returns -1 otherwise, where :func:`masked_allreduce` is the idiom for
ranks whose data ran out.

A failed ``torch.distributed`` call -- a dead peer, a timeout -- raises
:class:`~horovod_tpu_torch.exceptions.HorovodInternalError` (from the
backend's error), on which :func:`horovod_tpu_torch.elastic.run` restores
the last commit and rejoins. Every bucket of :mod:`.fusion` and
:mod:`.layout` goes through these functions, so a failure of one raised
in a gradient hook surfaces the same way.
"""

from __future__ import annotations

import enum
import zlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..exceptions import HorovodInternalError, HorovodTpuError

__all__ = [
    "Adasum",
    "Average",
    "Max",
    "Min",
    "Product",
    "ReduceOp",
    "Sum",
    "allgather",
    "allreduce",
    "alltoall",
    "barrier",
    "broadcast",
    "grouped_allgather",
    "grouped_allreduce",
    "grouped_reducescatter",
    "join",
    "masked_allreduce",
    "ppermute",
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

# Dtype codes of the size negotiation (any fixed numbering will do).
_DTYPES = (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.uint8,
    torch.int8, torch.int16, torch.int32, torch.int64, torch.bool,
    torch.float8_e4m3fn, torch.float8_e5m2, torch.complex64,
    torch.complex128,
)
_MAX_DIMS = 8  # trailing dims a mismatch message can show


def group(axis=None):
    """This process's :class:`~..parallel.mesh.AxisGroup` along ``axis``."""
    from ..context import axis_group

    return axis_group(axis)


def world_size(axis=None) -> int:
    """Processes a collective over ``axis`` reduces across (1 where it is
    the identity)."""
    return group(axis).size


def world_rank(axis=None) -> int:
    """This process's rank in its group along ``axis`` (0 where the
    collective is the identity)."""
    return group(axis).index


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
        raise HorovodTpuError(f"unknown reduce op {op}")
    return getattr(dist.ReduceOp, _TORCH_OPS[op])


# The analysis plane's recorder (analysis/record.py) while it records a
# step: every call below goes to it instead of torch.distributed, and
# nothing is communicated.
_recorder = None


def _as_transport(t: torch.Tensor) -> torch.Tensor:
    """fp8 and bool travel as their bytes: gloo has neither type. A record
    sees the tensor as the step holds it."""
    if _recorder is None and t.dtype in (
            torch.float8_e4m3fn, torch.float8_e5m2, torch.bool):
        return t.view(torch.uint8)
    return t


def _comm(fn, *args, **kwargs):
    """Run one ``torch.distributed`` call; its failure -- a peer that died,
    a timeout, a torn connection -- is the collective's failure, raised as
    :class:`~..exceptions.HorovodInternalError` (what the JAX package's
    native runtime raises) for :func:`~..elastic.run` to restore and
    rejoin on. While a step is recorded, the call is logged and not made."""
    if _recorder is not None:
        return _recorder(fn, args, kwargs)
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:  # DistBackendError and gloo's errors
        name = getattr(fn, "__name__", "collective")
        raise HorovodInternalError(f"{name} failed: {e}") from e


def allreduce_(x: torch.Tensor, op: ReduceOp = Sum, *, axis=None) -> torch.Tensor:
    """In-place reduction of ``x`` across ``axis`` (no scaling, no
    Average division): one ``all_reduce`` call."""
    g = group(axis)
    if g.live:
        _comm(dist.all_reduce, x, op=_torch_op(op), group=g.group)
    return x


def allreduce(
    tensor: torch.Tensor,
    *,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    axis=None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """Allreduce a tensor across ``axis`` (parity: ``hvd.allreduce``).
    Adasum reduces through :func:`.adasum.adasum_allreduce`; Average
    divides by the group's size."""
    del name
    x = scale(tensor, prescale_factor)
    if op == Adasum:
        from .adasum import adasum_allreduce

        return scale(adasum_allreduce(x, axis=axis), postscale_factor)
    torch_op = _torch_op(op)
    x = x.clone() if x is tensor else x
    g = group(axis)
    if g.live:
        _comm(dist.all_reduce, x, op=torch_op, group=g.group)
    if op == Average:
        x = divide_by_world(x, g.size)
    return scale(x, postscale_factor)


def grouped_allreduce(
    tensors: Sequence[torch.Tensor],
    *,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    axis=None,
    fuse: bool = True,
) -> List[torch.Tensor]:
    """Allreduce a group of tensors as one logical operation (parity:
    ``hvd.grouped_allreduce``): with ``fuse`` and Average or Sum, one
    ``all_reduce`` per fusion bucket (:func:`.fusion.fused_allreduce`);
    otherwise one :func:`allreduce` per tensor."""
    tensors = list(tensors)
    if fuse and op in (Average, Sum):
        from .fusion import fused_allreduce

        return fused_allreduce(
            tensors, op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, axis=axis,
        )
    return [
        allreduce(t, op=op, prescale_factor=prescale_factor,
                  postscale_factor=postscale_factor, axis=axis)
        for t in tensors
    ]


def _describe(t: torch.Tensor, lead: int) -> List[int]:
    """A rank's row of a negotiation: ``lead``, its dtype code, the number
    and a crc of its trailing dims, and up to ``_MAX_DIMS`` of them."""
    trailing = [int(s) for s in t.shape[1:]]
    crc = zlib.crc32(repr((trailing, str(t.dtype))).encode())
    shown = (trailing + [0] * _MAX_DIMS)[:_MAX_DIMS]
    return [lead, _DTYPES.index(t.dtype), len(trailing), crc] + shown


def _check_alike(rows: List[List[int]], what: str) -> None:
    """Raise on every rank when the ranks' trailing shapes or dtypes
    differ (each rank holds the same table, so all of them raise)."""
    if any(r[1:4] != rows[0][1:4] for r in rows):
        desc = [f"rank {i}: {_DTYPES[r[1]]} trailing {tuple(r[4:4 + r[2]])}"
                for i, r in enumerate(rows)]
        raise HorovodTpuError(
            f"{what}: the ranks' trailing shapes or dtypes differ ("
            + "; ".join(desc) + ")")


def _exchange_rows(row: List[int], g, device) -> List[List[int]]:
    """Every rank's ``row`` of int64s (one ``all_gather``), as lists."""
    mine = torch.tensor(row, dtype=torch.int64, device=device)
    out = torch.empty((g.size, len(row)), dtype=torch.int64, device=device)
    _comm(dist.all_gather, list(out.unbind(0)), mine, group=g.group)
    return out.tolist()


def allgather(tensor: torch.Tensor, *, axis=None,
              name: Optional[str] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0; a scalar counts as
    shape ``[1]``. First dimensions may differ: the sizes are exchanged
    first (one ``all_gather`` of a small int64 row, which also carries the
    trailing shape and dtype), then every rank's rows are gathered padded
    to the largest and sliced out, as the JAX package's process path does
    (``ops/eager.py`` ``allgather``). Trailing shapes or dtypes that differ
    raise ``HorovodTpuError`` on every rank."""
    del name
    x = tensor[None] if tensor.dim() == 0 else tensor
    x = x.contiguous()
    g = group(axis)
    if not g.live:
        return x.clone()
    rows = _exchange_rows(_describe(x, x.shape[0]), g, x.device)
    _check_alike(rows, "allgather")
    sizes = [r[0] for r in rows]
    top = max(sizes)
    if all(s == top for s in sizes):
        out = torch.empty((g.size * top,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return allgather_chunks(out, x, axis=axis)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + x.shape[1:])])
    full = torch.empty((g.size * top,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    allgather_chunks(full, x, axis=axis)
    parts = full.split(top)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


def grouped_allgather(tensors: Sequence[torch.Tensor], *,
                      axis=None) -> List[torch.Tensor]:
    """:func:`allgather` of each tensor."""
    return [allgather(t, axis=axis) for t in tensors]


def broadcast(tensor: torch.Tensor, root_rank: int = 0, *, axis=None,
              name: Optional[str] = None) -> torch.Tensor:
    """``root_rank``'s tensor on every rank of the group; ``root_rank`` is
    a rank within the group, as on the JAX package's device path."""
    del name
    g = group(axis)
    if not 0 <= root_rank < g.size:
        raise HorovodTpuError(
            f"broadcast root_rank {root_rank} out of range for world size "
            f"{g.size}"
        )
    x = tensor.clone()
    if g.live:
        _comm(dist.broadcast, _as_transport(x),
              src=g.global_rank(root_rank), group=g.group)
    return x


def reducescatter(tensor: torch.Tensor, *, op: ReduceOp = Sum,
                  axis=None) -> torch.Tensor:
    """Sum (or average) across the group and keep this rank's contiguous
    1/N slice of dim 0 (which the group's size must divide)."""
    if op not in (Average, Sum):
        raise ValueError("reducescatter supports Average/Sum")
    world = world_size(axis)
    if tensor.shape[0] % world:
        raise ValueError(
            f"dim 0 ({tensor.shape[0]}) is not a multiple of the world "
            f"size {world}"
        )
    out = reducescatter_chunks(tensor.contiguous(), axis=axis)
    if op == Average:
        out = divide_by_world(out, world)
    return out


def grouped_reducescatter(tensors: Sequence[torch.Tensor], *,
                          op: ReduceOp = Sum, axis=None) -> List[torch.Tensor]:
    """:func:`reducescatter` of each tensor."""
    return [reducescatter(t, op=op, axis=axis) for t in tensors]


def alltoall(tensor: torch.Tensor, splits=None, *, axis=None,
             name: Optional[str] = None):
    """Send ``splits[r]`` rows of ``tensor`` (in order) to rank ``r`` and
    receive every rank's rows for this one, concatenated in rank order
    (parity: ``hvd.alltoall``). Without ``splits`` dim 0 is split equally.

    With ``splits`` the split table is exchanged first (one ``all_gather``
    of a row a rank, carrying its dim 0, trailing shape and dtype), then
    one ``all_to_all_single`` moves the rows; returns ``(output,
    received_splits)`` (int32), as the JAX package's process path does. A
    ``splits`` of another length than the group's size, or whose sum is
    not dim 0, raises ``HorovodTpuError`` on every rank."""
    del name
    g = group(axis)
    world = g.size
    x = tensor.contiguous()
    if splits is None:
        if x.shape[0] % world:
            raise HorovodTpuError(
                "alltoall requires dim0 divisible by world size")
        if not g.live:
            return x.clone()
        return alltoall_chunks(torch.empty_like(x), x, axis=axis)
    splits = [int(s) for s in (splits.tolist() if torch.is_tensor(splits)
                               else list(splits))]
    # A malformed table still sends a row of the group's width, marked -1,
    # so every rank sees it and raises, and none waits for the exchange.
    ok = len(splits) == world and sum(splits) == x.shape[0] and min(
        splits, default=0) >= 0
    sent = splits if ok else [-1] * world
    if g.live:
        rows = _exchange_rows(_describe(x, x.shape[0]) + sent, g, x.device)
    else:
        rows = [_describe(x, x.shape[0]) + sent]
    head = 4 + _MAX_DIMS
    me = g.index
    bad = [i for i, r in enumerate(rows) if r[head] < 0]
    if bad:
        raise HorovodTpuError(
            f"alltoall splits must be a length-{world} vector of sizes "
            f"summing to dim 0, on every rank; rank(s) {bad} gave another"
            + (f" (this rank: {splits} for dim 0 {x.shape[0]})"
               if me in bad else ""))
    _check_alike(rows, "alltoall")
    recv = [r[head + me] for r in rows]
    recv_t = torch.tensor(recv, dtype=torch.int32, device=x.device)
    if not g.live:
        return x.clone(), recv_t
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    _comm(dist.all_to_all_single, _as_transport(out), _as_transport(x),
          output_split_sizes=recv, input_split_sizes=splits, group=g.group)
    return out, recv_t


def ppermute(tensor: torch.Tensor, perm: Sequence[Tuple[int, int]], *,
             axis=None) -> torch.Tensor:
    """Point-to-point permutation over the group: for each ``(src, dst)``
    pair (group ranks) ``dst`` receives ``src``'s tensor; a rank that
    receives nothing gets zeros, as ``lax.ppermute`` gives. One
    ``batch_isend_irecv`` of the pairs this rank is in."""
    g = group(axis)
    world = g.size
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= r < world for r in srcs + dsts):
        raise HorovodTpuError(
            f"ppermute pairs must name distinct sources and destinations "
            f"among {world} ranks: {perm}")
    me = g.index
    x = tensor.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, _as_transport(x),
                                  g.global_rank(dst), g.group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, _as_transport(out),
                                  g.global_rank(src), g.group))
    p2p_ready(g, x.device)
    for work in _comm(dist.batch_isend_irecv, ops) if ops else ():
        _comm(work.wait)
    return out


# The process groups (by id) that have run a collective before their first
# point-to-point exchange; emptied when the process groups are destroyed.
_P2P_READY: set = set()


def forget_groups() -> None:
    _P2P_READY.clear()


def p2p_ready(g, device) -> None:
    """Before a group's first point-to-point exchange, one collective on
    every rank of it (NCCL needs one before a ``batch_isend_irecv`` that
    only some ranks join). Every rank of ``g`` calls this."""
    if not g.live:
        return
    key = id(g.group if g.group is not None else dist.group.WORLD)
    if key not in _P2P_READY:
        _comm(dist.all_reduce, torch.zeros(1, device=device), group=g.group)
        _P2P_READY.add(key)


def barrier(*, axis=None) -> None:
    """Wait for every rank of the group."""
    g = group(axis)
    if g.live:
        _comm(dist.barrier, group=g.group)


def join() -> int:
    """``hvd.join()``. With the dynamic-enqueue runtime up
    (:func:`horovod_tpu_torch.native.init`, since A16a) this is its Join:
    the rank's data ran out, it takes part in the other ranks' outstanding
    collectives with the op's identity until every rank joined, and the
    last rank that joined is returned. Without the runtime it returns -1,
    no rank joined, as the JAX package does without its native runtime:
    the train step's collectives run on every rank, and for uneven data
    :func:`masked_allreduce` weights each rank's contribution
    (``valid=False`` where the data ran out)."""
    import sys

    native = sys.modules.get("horovod_tpu_torch.native")
    if native is not None and native.is_initialized():
        return native.join()
    return -1


def masked_allreduce(tree, valid, *, axis=None):
    """Average a nest of tensors over only the ranks whose ``valid`` flag
    is set: ``sum(t * w) / max(sum(w), 1)`` in ``t``'s dtype, ``w`` the
    rank's 0/1 flag; zero when no rank is valid (parity:
    ``hvd.masked_allreduce``)."""
    from .batching import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    device = leaves[0].device if leaves else torch.device("cpu")
    w = torch.as_tensor(valid, device=device).to(torch.float32)
    denom = torch.clamp_min(allreduce_(w.clone(), Sum, axis=axis), 1.0)
    out = []
    for t in leaves:
        s = allreduce_(t * w.to(t.dtype), Sum, axis=axis)
        s = s.to(torch.promote_types(s.dtype, torch.float32))
        out.append((s / denom).to(t.dtype))
    return tree_unflatten(treedef, out)


def allgather_chunks(out: torch.Tensor, shard: torch.Tensor, *,
                     axis=None) -> torch.Tensor:
    """Fill ``out`` (the group's size in equal chunks along dim 0) with
    every rank's ``shard``: one ``all_gather`` call into views of ``out``
    (the list form every torch version takes without a deprecation
    warning). fp8 and bool travel as ``uint8`` views."""
    g = group(axis)
    if not g.live:
        return out.copy_(shard)
    _comm(dist.all_gather, list(_as_transport(out).chunk(g.size)),
          _as_transport(shard), group=g.group)
    return out


def alltoall_chunks(out: torch.Tensor, buf: torch.Tensor, *,
                    axis=None) -> torch.Tensor:
    """Send chunk ``r`` of ``buf`` (the group's size in equal chunks along
    dim 0) to rank ``r`` and fill chunk ``r`` of ``out`` with rank ``r``'s
    chunk for this rank: one ``all_to_all_single`` call. fp8 and bool
    travel as ``uint8`` views."""
    g = group(axis)
    if not g.live:
        return out.copy_(buf)
    _comm(dist.all_to_all_single, _as_transport(out), _as_transport(buf),
          group=g.group)
    return out


def reducescatter_chunks(buf: torch.Tensor, *, axis=None) -> torch.Tensor:
    """Sum ``buf`` (the group's size in equal chunks along dim 0) across
    the group and return this rank's chunk of the sum: one
    ``reduce_scatter`` call over views of ``buf``."""
    g = group(axis)
    if not g.live:
        return buf.clone()
    chunks = list(buf.chunk(g.size))
    out = torch.empty_like(chunks[0])
    _comm(dist.reduce_scatter, out, chunks, op=dist.ReduceOp.SUM,
          group=g.group)
    return out
