"""Expert routing -- the part of the JAX package's ``parallel/ep.py`` that
is local compute: :func:`top1_dispatch`, the Switch-style top-1 dispatch
and combine tensors the MoE layer (``models/moe.py``) routes with. The
``all_to_all`` expert-parallel layer (``switch_moe``) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["top1_dispatch"]


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
