"""Object and state broadcast and gather helpers.

The port of the JAX package's ``functions.py`` (the reference's
``horovod/torch/functions.py:186-229``): part 2 of a Horovod script,
broadcasting the initial state from one rank before the first step.

* :func:`broadcast_object` / :func:`allgather_object` -- a picklable
  object as its pickled bytes: the size first, then a ``uint8`` tensor.
* :func:`broadcast_variables` (alias :func:`broadcast_parameters`) -- a
  nest of tensors packed into fusion buckets (:func:`~.ops.batching.pack`),
  one broadcast a bucket; returns new tensors, as the JAX function does.
* :func:`broadcast_optimizer_state` -- tensor leaves ride
  :func:`broadcast_variables`, every other leaf (Python numbers, strings,
  ``None``, numpy arrays) rides :func:`broadcast_object` with its type kept.

The bytes travel where the group's backend moves them: on
``context.device()`` under NCCL, on the CPU under gloo. ``axis=`` names
the mesh axes (default the world's) and ``root_rank`` is a rank within
that group. Every rank of the group calls these together.
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from .ops.batching import pack, tree_flatten, unpack
from .ops.collectives import allgather, broadcast, group

__all__ = [
    "allgather_object",
    "broadcast_object",
    "broadcast_optimizer_state",
    "broadcast_parameters",
    "broadcast_variables",
]


def _byte_device(g) -> torch.device:
    """Where a byte tensor must live for the group's backend."""
    if g.live and dist.get_backend(g.group) == "nccl":
        from .context import context, is_initialized

        if is_initialized() and context().device.type == "cuda":
            return context().device
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_bytes(obj: Any, device) -> torch.Tensor:
    buf = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(device)


def _from_bytes(t: torch.Tensor) -> Any:
    # Only the bytes this program's own ranks pickled are unpickled here.
    return pickle.loads(t.cpu().numpy().tobytes())


def broadcast_object(obj: Any, root_rank: int = 0, name: Optional[str] = None,
                     *, axis=None) -> Any:
    """``root_rank``'s picklable object on every rank: its size as an int64
    broadcast, then its pickled bytes (parity: ``hvd.broadcast_object``).
    Every rank gets an unpickled copy, the root too."""
    del name
    g = group(axis)
    dev = _byte_device(g)
    data = _to_bytes(obj, dev)
    n = int(broadcast(torch.tensor([data.numel()], dtype=torch.int64,
                                   device=dev), root_rank, axis=axis)[0])
    if data.numel() != n:  # not the root: a buffer of the root's size
        data = torch.zeros((n,), dtype=torch.uint8, device=dev)
    return _from_bytes(broadcast(data, root_rank, axis=axis))


def allgather_object(obj: Any, name: Optional[str] = None, *,
                     axis=None) -> List[Any]:
    """Every rank's picklable object, in rank order (parity:
    ``hvd.allgather_object``): the sizes first, then the bytes gathered
    (ranks' objects may differ in size)."""
    del name
    dev = _byte_device(group(axis))
    data = _to_bytes(obj, dev)
    sizes = allgather(torch.tensor([data.numel()], dtype=torch.int64,
                                   device=dev), axis=axis).tolist()
    gathered = allgather(data, axis=axis)
    return [_from_bytes(part) for part in gathered.split(sizes)]


def broadcast_variables(tree, root_rank: int = 0, *, axis=None):
    """``root_rank``'s nest of tensors on every rank, as new tensors in the
    nest's structure: the leaves packed into fusion buckets, one broadcast
    each (parity: ``hvd.broadcast_variables``)."""
    leaves, _ = tree_flatten(tree)
    if not leaves:
        return tree
    with torch.no_grad():
        buffers, spec = pack(tree)
        out = [broadcast(b, root_rank, axis=axis) for b in buffers]
        return unpack(out, spec)


# Torch-style alias.
broadcast_parameters = broadcast_variables


def broadcast_optimizer_state(opt_state, root_rank: int = 0, *, axis=None):
    """``root_rank``'s optimizer state on every rank (parity: torch
    ``broadcast_optimizer_state``): tensor leaves through
    :func:`broadcast_variables`, every other leaf through one
    :func:`broadcast_object`, so Python numbers, strings and ``None`` keep
    their types exactly. The state's containers (dicts, lists, tuples,
    NamedTuples, dataclasses, fused buffers) are rebuilt as they were."""
    leaves, rebuild = _flatten_state(opt_state)
    is_tensor = [isinstance(x, torch.Tensor) for x in leaves]
    tensors = broadcast_variables(
        [x for x, ok in zip(leaves, is_tensor) if ok], root_rank, axis=axis)
    others = broadcast_object(
        [x for x, ok in zip(leaves, is_tensor) if not ok], root_rank,
        axis=axis)
    ti, oi = iter(tensors), iter(others)
    return rebuild([next(ti) if ok else next(oi) for ok in is_tensor])


def _flatten_state(state):
    """``(leaves, rebuild)`` of an optimizer state, through the
    checkpoint's walk (which knows every container the port's states use:
    ``rebuild(leaves)`` gives the state back with new leaves)."""
    from .checkpoint import _children, _rebuild

    leaves: List[Any] = []

    def walk(node):
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            return None
        return (node, [walk(v) for _, v in kids])

    shape = walk(state)

    def rebuild(values):
        it = iter(values)

        def rec(s):
            if s is None:
                return next(it)
            node, kids = s
            return _rebuild(node, [rec(k) for k in kids])

        return rec(shape)

    return leaves, rebuild
