"""Fail-silent chaos sites: ``grad.nan``, ``grad.bitflip`` and
``param.corrupt``.

The port of the JAX package's ``guard/inject.py``. These sites corrupt
data while everything keeps running -- the faults the guard must catch --
and fire from the guarded step's wrapper (:mod:`.runtime`):

``grad.nan``
    one element of the step's first floating batch leaf becomes NaN
    before the step runs, so the backward produces a NaN storm the
    guard must screen out (a batch of token ids alone has no floating
    leaf: a per-example loss weight carries the fault there);
``grad.bitflip``
    one bit at a seeded position of this rank's parameters flips after
    the update commits: the rank diverges silently, and only the
    consistency audit sees it;
``param.corrupt``
    a seeded span of one parameter leaf is rewritten (``2x + 1``) after
    the update.

Every pick comes from the matched rule's seeded stream, in the
reference's order over the reference's walk (sorted names), so a plan
picks the same leaf, element and bit in either package. The functions
return new tensors and leave their inputs alone; the runtime writes a
corrupted parameter back into the live one.
"""

from __future__ import annotations

import torch

from .. import chaos as _chaos
from ..ops.batching import tree_flatten, tree_unflatten

__all__ = ["maybe_corrupt_params", "maybe_poison_batch"]


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def maybe_poison_batch(batch, step: int, rank):
    """``grad.nan`` site: on a match, one element of the first floating
    batch leaf (position from the rule's seeded stream) becomes NaN."""
    act = _chaos.act("grad.nan", step=step, rank=rank)
    if act is None:
        return batch
    leaves, treedef = tree_flatten(batch)
    for i, leaf in enumerate(leaves):
        if not _is_float(leaf):
            continue
        out = leaf.detach().clone()
        out.view(-1)[act.rng.randrange(out.numel())] = float("nan")
        leaves[i] = out
        break
    return tree_unflatten(treedef, leaves)


def _flip_one_bit(params, rng):
    """Flip one bit at a seeded position of the flattened floating
    parameter payload: any bit of the element's bytes (mantissa, exponent
    or sign)."""
    leaves, treedef = tree_flatten(params)
    float_idx = [i for i, x in enumerate(leaves) if _is_float(x)]
    sizes = [leaves[i].numel() for i in float_idx]
    total = sum(sizes)
    if not total:
        return params
    pos = rng.randrange(total)
    for i, n in zip(float_idx, sizes):
        if pos < n:
            out = leaves[i].detach().clone()
            size = out.element_size()
            byte = pos * size + rng.randrange(size)
            raw = out.view(-1).view(torch.uint8)
            raw[byte] ^= 1 << rng.randrange(8)
            leaves[i] = out
            break
        pos -= n
    return tree_unflatten(treedef, leaves)


def _corrupt_span(params, rng):
    """Rewrite a seeded span (up to 8 elements) of one floating parameter
    leaf to visibly wrong values (``2x + 1``)."""
    leaves, treedef = tree_flatten(params)
    float_idx = [i for i, x in enumerate(leaves) if _is_float(x)]
    if not float_idx:
        return params
    i = float_idx[rng.randrange(len(float_idx))]
    out = leaves[i].detach().clone()
    flat = out.view(-1)
    lo = rng.randrange(flat.numel())
    hi = min(flat.numel(), lo + rng.randrange(1, 9))
    flat[lo:hi] = flat[lo:hi] * 2.0 + 1.0
    leaves[i] = out
    return tree_unflatten(treedef, leaves)


def maybe_corrupt_params(params, step: int, rank):
    """``grad.bitflip`` / ``param.corrupt`` sites over this rank's
    parameters (after the update); returns the perturbed nest, or
    ``params`` itself when nothing fired."""
    act = _chaos.act("grad.bitflip", step=step, rank=rank)
    if act is not None:
        return _flip_one_bit(params, act.rng)
    act = _chaos.act("param.corrupt", step=step, rank=rank)
    if act is not None:
        return _corrupt_span(params, act.rng)
    return params
