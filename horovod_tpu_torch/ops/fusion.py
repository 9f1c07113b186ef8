"""Tensor fusion: many gradients, few collective calls.

The port of the JAX package's ``ops/fusion.py`` for the unquantized wire.
The bucketing policy is the reference's and the JAX package's: leaves are
walked in reverse tree order (bucket 0 holds the deepest layers, whose
gradients the backward pass makes first), grouped by dtype and packed
greedily up to ``threshold_bytes`` per bucket (``HVDTPU_FUSION_THRESHOLD``,
default 128 MB). Where the JAX package emits one variadic ``psum`` per
bucket, the port packs each bucket into one flat buffer
(:func:`~.batching.pack`) and makes one ``torch.distributed`` call on it:

* :func:`fused_allreduce` -- one ``all_reduce`` per bucket;
* :func:`fused_reducescatter` -- buckets padded to a multiple of the world
  size, one ``reduce_scatter`` per bucket; each rank keeps its contiguous
  1/N shard (the ZeRO-1 front half);
* :func:`fused_allgather` -- one ``all_gather`` per bucket, then the pad is
  dropped and the tree rebuilt (the back half);
* :func:`shard_slice` -- this rank's 1/N slice of full buffers, taken
  locally;
* :func:`bucket_byte_layout` -- the bucket layout from shapes and dtypes
  alone.

``compression`` casts the wire (:mod:`.compression`): bf16, or fp16 with a
replica-uniform max-abs prescale (one scalar MAX all-reduce per call).
Average is a Sum followed by a division by the world size, as the JAX
package computes it. Without a process group the world is one process and
every collective is the identity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..utils import env as _env
from .batching import (
    PackSpec,
    _as_tensor,
    _bucketize,
    leaf_nbytes,
    pack,
    tree_flatten,
    tree_unflatten,
    unpack,
)
from .collectives import (
    Average,
    Max,
    ReduceOp,
    Sum,
    allgather_chunks,
    allreduce_,
    divide_by_world,
    reducescatter_chunks,
    scale,
    world_rank,
    world_size,
)
from .compression import FP16_SAFE_MAX, Compression, require_unquantized

__all__ = [
    "FlatBuckets",
    "PackSpec",
    "bucket_byte_layout",
    "fused_allgather",
    "fused_allreduce",
    "fused_reducescatter",
    "pack",
    "shard_slice",
    "unpack",
]


class FlatBuckets:
    """Marks "these tensors are fused flat buffers" (one per bucket): the
    sharded optimizer's 1/N state and update shards travel in it."""

    def __init__(self, buffers: Sequence[torch.Tensor]):
        self.buffers = list(buffers)

    def __repr__(self):
        return f"FlatBuckets(n={len(self.buffers)})"


def _flatten(tree, threshold_bytes):
    if threshold_bytes is None:
        threshold_bytes = _env.fusion_threshold_bytes()
    if isinstance(tree, (list, tuple)) and all(
        not isinstance(t, (list, tuple, dict)) for t in tree
    ):
        return list(tree), None, threshold_bytes
    leaves, treedef = tree_flatten(tree)
    return leaves, treedef, threshold_bytes


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def bucket_byte_layout(
    tree, threshold_bytes: Optional[int] = None, *, pad_multiple: int = 1
) -> List[Tuple[str, int]]:
    """Predicted fused-bucket layout from shapes and dtypes alone:
    ``[(dtype_name, padded_bytes), ...]`` per bucket, in the order
    :func:`pack` makes them. Leaves may be tensors or any object with
    ``shape`` and a torch ``dtype``."""
    leaves, _, threshold_bytes = _flatten(tree, threshold_bytes)
    out: List[Tuple[str, int]] = []
    for bucket in _bucketize(leaves, threshold_bytes):
        size = sum(leaf_nbytes(leaf) // leaf.dtype.itemsize
                   for _, leaf in bucket)
        size += (-size) % max(1, pad_multiple)
        dt = bucket[0][1].dtype
        out.append((_dtype_name(dt), size * dt.itemsize))
    return out


def _uniform_cast_scale(tensors, world_factor: float):
    """Replica-uniform max-abs prescale for the fp16 wire: one scalar over
    every floating tensor, MAX-reduced across the world so every rank
    scales alike. ``world_factor`` guards the sum of a reduction (pass the
    world size); 1 for the move-only all-gather."""
    floats = [t for t in tensors if t.is_floating_point() and t.numel()]
    if not floats:
        return None
    gmax = torch.stack([t.float().abs().max() for t in floats]).max()
    gmax = allreduce_(gmax, Max)
    return torch.clamp_min(world_factor * gmax / FP16_SAFE_MAX, 1.0)


def _compress(compression, x, wire_scale):
    if wire_scale is not None and compression.needs_prescale:
        return compression.compress(x, scale=wire_scale)
    return compression.compress(x)


def _finish(red, op: ReduceOp, world: int, postscale_factor):
    if op == Average:
        red = divide_by_world(red, world)
    return scale(red, postscale_factor)


def _check_op(op, name):
    if op not in (Average, Sum):
        raise ValueError(f"{name} supports Average/Sum")


def fused_allreduce(
    tree,
    *,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    threshold_bytes: Optional[int] = None,
    compression=Compression.none,
):
    """Allreduce a nest (or flat list) of tensors with bucketed fusion:
    one ``all_reduce`` per bucket. Returns new tensors in the input's
    structure; the inputs are left alone."""
    _check_op(op, "fused_allreduce")
    require_unquantized(compression)
    leaves, treedef, threshold_bytes = _flatten(tree, threshold_bytes)
    leaves = [_as_tensor(l) for l in leaves]
    world = world_size()
    wire_scale = None
    if compression.needs_prescale:
        wire_scale = _uniform_cast_scale(leaves, float(world))
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for bucket in _bucketize(leaves, threshold_bytes):
        wires, ctxs = [], []
        for _, leaf in bucket:
            wire, ctx = _compress(
                compression, scale(leaf, prescale_factor), wire_scale
            )
            wires.append(wire.reshape(-1))
            ctxs.append(ctx)
        buf = allreduce_(torch.cat(wires), Sum)  # cat copies: inputs kept
        offset = 0
        for (i, leaf), ctx in zip(bucket, ctxs):
            n = leaf.numel()
            red = compression.decompress(
                buf[offset:offset + n].reshape(leaf.shape), ctx
            )
            offset += n
            out[i] = _finish(red, op, world, postscale_factor)
    return out if treedef is None else tree_unflatten(treedef, out)


def fused_reducescatter(
    tree,
    *,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    threshold_bytes: Optional[int] = None,
    compression=Compression.none,
) -> Tuple[FlatBuckets, PackSpec]:
    """Reduce-scatter a nest of tensors with bucketed fusion: buckets are
    packed, padded to a multiple of the world size N, and reduced with one
    ``reduce_scatter`` each, so rank ``k`` keeps elements ``[k*S/N,
    (k+1)*S/N)`` of every bucket. Returns ``(shards, spec)``; ``spec``
    restores the tree after :func:`fused_allgather`."""
    _check_op(op, "fused_reducescatter")
    require_unquantized(compression)
    world = world_size()
    buffers, spec = pack(tree, threshold_bytes, pad_multiple=world)
    wire_scale = None
    if compression.needs_prescale:
        wire_scale = _uniform_cast_scale(buffers, float(world))
    shards = []
    for buf in buffers:
        wire, ctx = _compress(
            compression, scale(buf, prescale_factor), wire_scale
        )
        red = compression.decompress(
            reducescatter_chunks(wire.contiguous()), ctx
        )
        shards.append(_finish(red, op, world, postscale_factor))
    return FlatBuckets(shards), spec


def fused_allgather(shards, spec: PackSpec, *, compression=Compression.none):
    """All-gather per-bucket shards back into the tree ``spec`` describes:
    one ``all_gather`` per bucket into the full padded buffer, the pad
    dropped by :func:`~.batching.unpack` (the leaves are views of the
    gathered buffers)."""
    require_unquantized(compression)
    buffers = shards.buffers if isinstance(shards, FlatBuckets) else list(shards)
    wire_scale = None
    if compression.needs_prescale:
        # Move-only leg: the same scale everywhere, no world factor.
        wire_scale = _uniform_cast_scale(buffers, 1.0)
    full = []
    for buf, n in zip(buffers, spec.padded_sizes()):
        wire, ctx = _compress(compression, buf, wire_scale)
        gathered = torch.empty((n,), dtype=wire.dtype, device=wire.device)
        allgather_chunks(gathered, wire.contiguous())
        full.append(compression.decompress(gathered, ctx))
    return unpack(full, spec)


def shard_slice(buffers) -> FlatBuckets:
    """This rank's contiguous 1/N slice of full fused buffers (views) --
    the layout :func:`fused_reducescatter` produces, taken locally."""
    world, rank = world_size(), world_rank()
    bufs = buffers.buffers if isinstance(buffers, FlatBuckets) else list(buffers)
    out = []
    for buf in bufs:
        n = buf.shape[0] // world
        out.append(buf[rank * n:(rank + 1) * n])
    return FlatBuckets(out)
