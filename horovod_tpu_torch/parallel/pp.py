"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh axis --
the port of the JAX package's ``parallel/pp.py``.

Each rank along the axis owns one stage. Microbatches stream through the
stages one hop a tick (:func:`..ops.diff_collectives.ppermute`): ``M + n -
1`` ticks for ``M`` microbatches over ``n`` stages, and autograd through
the schedule runs the backward pipeline. Every rank runs the same
operations every tick -- a stage's choice between a fresh microbatch and
the previous stage's output, and the last stage's masked contribution, are
``torch.where`` selections -- so every rank reaches the same backward
exchanges in the same order.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import collectives as _coll
from ..ops.diff_collectives import ppermute, reduce_from

__all__ = ["pipeline"]


def pipeline(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
             *, axis) -> torch.Tensor:
    """Run ``microbatches`` ``[M, ...]`` (replicated; stage 0 consumes
    them) through ``stage_fn(stage_params, x) -> y``, this rank's stage
    (every stage maps equal shapes). Returns ``[M, ...]``, the last stage's
    outputs, on every rank: each is made replicated by
    :func:`..ops.diff_collectives.reduce_from` of the last stage's masked
    contribution, so each rank keeps its own share of the gradient."""
    g = _coll.group(axis)
    n, r = g.size, g.index
    m = microbatches.shape[0]
    dev = microbatches.device
    first = torch.tensor(r == 0, device=dev)
    last = torch.tensor(r == n - 1, device=dev)
    state = torch.zeros_like(microbatches[0])
    fwd_perm = [(i, (i + 1) % n) for i in range(n)]
    outputs = [None] * m
    for t in range(m + n - 1):
        # Stage 0 takes microbatch t while there is one; the other stages
        # (and stage 0 after the last) take what arrived last tick.
        inject = microbatches[min(t, m - 1)]
        x_in = torch.where(first & (t < m), inject, state)
        y = stage_fn(stage_params, x_in)
        out_idx = t - (n - 1)
        if out_idx >= 0:
            outputs[out_idx] = reduce_from(
                torch.where(last, y, torch.zeros_like(y)), axis)
        if t != m + n - 2:
            state = ppermute(y, fwd_perm, axis=axis)
    return torch.stack(outputs)
