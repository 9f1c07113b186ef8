"""Expert parallelism -- the port of the JAX package's ``parallel/ep.py``:
:func:`top1_dispatch`, the Switch-style top-1 dispatch and combine tensors
(the MoE layer ``models/moe.py`` routes with them too), and the
expert-parallel layers :func:`switch_moe` and :func:`switch_moe_stacked`,
which send each token to its expert's rank and back with two all-to-alls
(:func:`..ops.diff_collectives.all_to_all`) around one-hot dispatch and
combine products.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..ops import collectives as _coll
from ..ops.diff_collectives import all_to_all, pmean

__all__ = ["switch_moe", "switch_moe_stacked", "top1_dispatch"]


def top1_dispatch(gate_logits: torch.Tensor, capacity: int):
    """Top-1 dispatch/combine tensors.

    Args: ``gate_logits`` ``[T, E]``; ``capacity``, tokens per expert.
    Returns: ``dispatch`` ``[T, E, C]`` one-hot (fp32), ``combine``
    ``[T, E, C]`` (weighted by the token's gate probability) and the Switch
    load-balancing ``aux_loss`` (fp32 scalar). A token past its expert's
    capacity is dropped (all zeros). An argmax tie goes to the first
    expert, as ``jnp.argmax`` breaks it."""
    t, e = gate_logits.shape
    probs = torch.softmax(gate_logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)  # [T], the first of a tie
    prob = torch.amax(probs, dim=-1)  # [T]
    onehot = F.one_hot(expert, e).float()  # [T, E]
    # Position of each token within its expert's queue.
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot  # [T, E]
    pos_of_token = pos.sum(-1).to(torch.int64)  # [T]
    keep = pos_of_token < capacity
    kept = onehot * keep[:, None]
    # jax.nn.one_hot gives a zero row for a position past the capacity.
    pos_onehot = (pos_of_token[:, None] == torch.arange(
        capacity, device=gate_logits.device)).float()
    dispatch = kept[:, :, None] * pos_onehot[:, None, :]  # [T, E, C]
    combine = dispatch * prob[:, None, None]
    frac_tokens = onehot.mean(0)
    frac_probs = probs.mean(0)
    aux_loss = e * torch.sum(frac_tokens * frac_probs)
    return dispatch, combine, aux_loss


def switch_moe(x: torch.Tensor, gate_kernel: torch.Tensor,
               expert_fn: Callable, expert_params, *, axis,
               capacity_factor: float = 1.25):
    """Top-1 MoE over ``axis`` with one expert a rank: the ``e_local = 1``
    case of :func:`switch_moe_stacked` (same routing, capacity, exchange
    and aux loss). ``expert_fn(params, tokens [n*C, D]) -> tokens``.
    Returns ``([T, D] output, aux_loss)``."""

    def stacked_fn(params, toks):
        return expert_fn(params, toks[0])[None]

    return switch_moe_stacked(x, gate_kernel, stacked_fn, expert_params,
                              axis=axis, capacity_factor=capacity_factor)


def switch_moe_stacked(x: torch.Tensor, gate_kernel: torch.Tensor,
                       expert_fn: Callable, local_expert_params, *, axis,
                       capacity_factor: float = 1.25):
    """Top-1 MoE with ``e_local`` experts a rank (GShard layout): ``E_total
    = n * e_local`` experts, group rank ``r`` owning experts ``r*e_local ..
    (r+1)*e_local - 1``.

    ``x`` ``[T, D]`` this rank's tokens; ``gate_kernel`` ``[D, E_total]``
    (replicated); ``expert_fn(params, tokens [e_local, n*C, D]) -> tokens``
    applied to this rank's stacked experts ``local_expert_params``. The
    capacity a source rank gives each expert is ``ceil(T / E_total *
    capacity_factor)``. Returns ``([T, D] output, aux_loss)``, the Switch
    load-balancing loss averaged over the axis
    (:func:`..ops.diff_collectives.pmean`)."""
    n = _coll.world_size(axis)
    t, d = x.shape
    e_total = gate_kernel.shape[-1]
    if e_total % n:
        raise ValueError(f"{e_total} experts not divisible by ep size {n}")
    e_local = e_total // n
    capacity = int(math.ceil(t / e_total * capacity_factor))
    gate_logits = x.float() @ gate_kernel.float()
    dispatch, combine, aux = top1_dispatch(gate_logits, capacity)
    # Bin per expert (rank-major expert order), exchange rank chunks.
    send = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    recv = all_to_all(send, 0, 0, axis=axis)
    # recv[r*e_local + j] = source rank r's bin for my local expert j.
    expert_in = (recv.reshape(n, e_local, capacity, d).transpose(0, 1)
                 .reshape(e_local, n * capacity, d))
    expert_out = expert_fn(local_expert_params, expert_in)
    back = (expert_out.reshape(e_local, n, capacity, d).transpose(0, 1)
            .reshape(e_total, capacity, d))
    back = all_to_all(back, 0, 0, axis=axis)
    out = torch.einsum("tec,ecd->td", combine.to(x.dtype), back)
    return out, pmean(aux, axis)
