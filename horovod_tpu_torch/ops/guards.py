"""Gradient-health screen: one pass over the gradients before the update
commits.

The port of the JAX package's ``ops/guards.py``, the local half of the
gradient guard (:mod:`horovod_tpu_torch.guard`). The reference reduces
``all(isfinite(leaf))`` and ``sum(square(leaf))`` per leaf and lets XLA
fuse the two into one pass. Eagerly that would be two passes, so the port
keeps only the fp32 sum of squares -- one ``torch._foreach_norm`` over the
floating leaves, squared and summed -- and reads the finite flag off it: a
NaN or +-Inf element makes the sum NaN or +Inf. An overflow of finite
values (a sum past fp32's range) also reads as not finite here, where the
reference's per-element flag stays True; the reference's caller screens
the same step out through ``isfinite(norm)``, so the guard's verdict is
the reference's in every case.

Plain torch on purpose, as the reference's screen is plain jnp; the
cross-replica agreement lives in :mod:`..guard.gradient`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Sequence, Tuple

import torch

from .batching import tree_flatten
from .fusion import FlatBuckets

__all__ = ["finite_and_sumsq", "per_bucket_stats"]


def _float_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, FlatBuckets):
        tree = tree.buffers
    leaves = [tree] if isinstance(tree, torch.Tensor) else tree_flatten(tree)[0]
    return [x for x in leaves
            if isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.numel()]


def finite_and_sumsq(tree) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(finite, sumsq)`` over every floating leaf of ``tree`` (a gradient
    nest, a list of tensors or a :class:`~.fusion.FlatBuckets`): a 0-d
    bool tensor, True iff the fp32 sum of squares is finite, and that sum
    (0-d fp32). Integer leaves are skipped. Nothing syncs with the host."""
    leaves = _float_leaves(tree)
    device = leaves[0].device if leaves else torch.device("cpu")
    by_device = defaultdict(list)
    for x in leaves:
        by_device[x.device].append(x)
    sumsq = torch.zeros((), dtype=torch.float32, device=device)
    for group in by_device.values():
        norms = torch._foreach_norm(group, 2, dtype=torch.float32)
        sumsq = sumsq + torch.stack(norms).square().sum().to(device)
    return torch.isfinite(sumsq), sumsq


def per_bucket_stats(
    buffers: Sequence[torch.Tensor],
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``(finite, sumsq)`` of each packed flat buffer, the bucket-resolution
    view for diagnostics; the step screens with :func:`finite_and_sumsq`."""
    return [finite_and_sumsq(buf) for buf in buffers]
