"""Tensor parallelism: Megatron column- and row-parallel products -- the
port of the JAX package's ``parallel/tp.py``.

A column-parallel product holds the weight's output dimension sharded over
the axis and needs no exchange in the forward; a row-parallel product holds
its input dimension sharded and sums the partial products over the axis
(:func:`..ops.diff_collectives.reduce_from`), the one all-reduce of a
Megatron pair. In the backward the column-parallel input's partial
gradients differ between the ranks of the axis: with ``axis=`` given,
:func:`column_parallel` sums them (:func:`..ops.diff_collectives.copy_to`),
which the JAX package's version does not (ROADMAP C9).
"""

from __future__ import annotations

import torch

from ..ops.diff_collectives import copy_to, reduce_from

__all__ = ["column_parallel", "row_parallel", "tp_mlp"]


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                    b_shard=None, *, axis=None) -> torch.Tensor:
    """``x @ w_shard (+ b_shard)``: ``w`` sharded on its output dim, ``x``
    replicated over the axis, the output this rank's shard of the hidden
    dimension. Without ``axis`` there is no collective (the JAX package's
    behaviour); with it, ``x``'s gradient is summed over the axis."""
    if axis is not None:
        x = copy_to(x, axis)
    y = x @ w_shard
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor, *, axis,
                 bias=None) -> torch.Tensor:
    """``sum over the axis of x_shard @ w_shard (+ bias)``: ``w`` sharded
    on its input dim, ``x_shard`` the column-parallel output."""
    y = reduce_from(x_shard @ w_shard, axis)
    if bias is not None:
        y = y + bias
    return y


def tp_mlp(x, w_up, b_up, w_down, b_down, *, axis, act=None):
    """Column -> activation (ReLU by default) -> row parallel MLP, one
    all-reduce on the way out; ``axis`` goes to both halves."""
    h = column_parallel(x, w_up, b_up, axis=axis)
    h = torch.where(h > 0, h, torch.zeros_like(h)) if act is None else act(h)
    return row_parallel(h, w_down, axis=axis, bias=b_down)
