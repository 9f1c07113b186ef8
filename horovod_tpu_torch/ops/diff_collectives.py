"""Differentiable collectives over the mesh's axis groups: what the
parallelism library (:mod:`..parallel.sp`, ``tp``, ``pp``, ``ep``,
``transformer``) differentiates through.

The JAX package differentiates ``lax.ppermute``, ``lax.all_to_all`` and
``lax.psum`` by their transpose rules inside ``shard_map``. The port's
:mod:`.collectives` functions are not autograd-aware, so each one here is a
``torch.autograd.Function`` over them, with ``axis=`` naming the mesh axes
(:func:`horovod_tpu_torch.context.axis_group`):

* :func:`ppermute` -- the backward sends the cotangent back along the
  inverse permutation (a rank that received nothing passes no gradient).
* :func:`all_to_all` -- the tiled all-to-all of ``lax.all_to_all(...,
  tiled=True)``; the backward is the all-to-all with the two axes swapped.
* The Megatron pair. :func:`reduce_from` sums over the axis in the forward
  and passes the cotangent through unchanged: the row-parallel reduction,
  and the reduction of a loss that every rank then holds (each rank keeps
  its own share of the gradient, so a Sum of the gradients over the
  data-parallel axes gives the dense gradient). :func:`copy_to` is the
  identity in the forward and sums the cotangent over the axis: it goes on
  the replicated input of every column-parallel product, whose partial
  gradients differ between the ranks of the axis.

The JAX package's ``psum`` under ``shard_map(check_vma=False)`` transposes
to another ``psum``, which scales the gradient of a summed loss by the
axis size, and nothing there all-reduces the gradient of a column-parallel
product's replicated input (ROADMAP C9). The port follows the dense math:
``reduce_from`` where the reference writes ``psum``, ``copy_to`` where it
writes nothing.

Every rank of the axis must run the same backward collectives in the same
order: each Function materializes a missing cotangent as zeros (autograd's
default), so a backward always runs its collective.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import collectives as _coll

__all__ = ["all_to_all", "copy_to", "pmean", "ppermute", "reduce_from"]


def _inverse(perm: Sequence[Tuple[int, int]]):
    return [(int(d), int(s)) for s, d in perm]


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, axis):
        ctx.perm, ctx.axis = perm, axis
        return _coll.ppermute(x, perm, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return _coll.ppermute(g, _inverse(ctx.perm), axis=ctx.axis), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], *,
             axis) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` pair of group ranks along
    ``axis``, ``dst`` receives ``src``'s ``x``; a rank that receives
    nothing gets zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _coll.ppermute(x, perm, axis=axis)
    return _Ppermute.apply(x, perm, axis)


def _all_to_all(x, split_axis: int, concat_axis: int, axis):
    g = _coll.group(axis)
    n = g.size
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: dim {split_axis} ({x.shape[split_axis]}) is not a "
            f"multiple of the axis size {n}")
    if not g.live:
        return x.clone()
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = _coll.alltoall_chunks(torch.empty_like(send), send, axis=axis)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, axis):
        ctx.args = (split_axis, concat_axis, axis)
        return _all_to_all(x, split_axis, concat_axis, axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, axis = ctx.args
        return (_all_to_all(g.contiguous(), concat_axis, split_axis, axis),
                None, None, None)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int, *,
               axis) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` split along ``split_axis`` into one chunk a rank of the group,
    chunk ``r`` sent to rank ``r``, and the chunks received concatenated
    along ``concat_axis`` in rank order. One ``all_to_all_single``."""
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _all_to_all(x, split_axis, concat_axis, axis)
    return _AllToAll.apply(x, split_axis, concat_axis, axis)


def _sum(x, axis):
    g = _coll.group(axis)
    out = x.contiguous().clone()
    if g.live:
        _coll.allreduce_(out, _coll.Sum, axis=axis)
    return out


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis), None


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over ``axis`` in the forward, the identity in the backward (the
    row-parallel reduction; a loss every rank then holds)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _sum(x, axis)
    return _ReduceFrom.apply(x, axis)


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """The identity in the forward, a sum over ``axis`` in the backward
    (the replicated input of a column-parallel product)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, axis)


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """:func:`reduce_from` divided by the axis size: the mean every rank
    holds, each rank keeping its own share of the gradient."""
    return reduce_from(x, axis) / _coll.world_size(axis)
