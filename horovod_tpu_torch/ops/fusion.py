"""Tensor fusion: many gradients, few collective calls.

The port of the JAX package's ``ops/fusion.py``. The bucketing policy is
the reference's and the JAX package's: leaves are walked in reverse tree
order (bucket 0 holds the deepest layers, whose gradients the backward
pass makes first), grouped by dtype and packed greedily up to
``threshold_bytes`` per bucket (``HVDTPU_FUSION_THRESHOLD``, default 128
MB). Where the JAX package emits one variadic ``psum`` per
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
package computes it. ``axis=`` names the mesh axes every collective of a
call runs over (default the world's; :func:`~horovod_tpu_torch.context.
axis_group`). Without a process group the world is one process and every
collective is the identity.

The quantized wire (``Compression.int8``/``fp8``): buckets pad to
``world * block`` so every chunk is whole scale blocks, and

* :func:`quantized_fused_allreduce` -- per bucket, error feedback (the
  residual of :class:`EFResiduals` added in), a blockwise quantize, one
  ``all_to_all_single`` of the payload and one of the scales, a local fp32
  dequantize-and-sum of this rank's chunk, a requantize, and one
  ``all_gather`` of each back: one ring allreduce's bytes at ``itemsize +
  4/block`` bytes an element;
* :func:`quantized_fused_reducescatter` -- its front half (the ZeRO-1
  reduce-scatter), and :func:`fused_allgather` with a quantized
  ``compression`` its back half;
* :func:`quantized_bucket_layout` -- the quantized layout and wire bytes
  from shapes alone.

``fused_allreduce``, ``fused_reducescatter`` and ``fused_allgather`` take
these paths for a quantized ``compression`` (without residuals). Only the
quantize and dequantize reach the kernels (:mod:`.quantization`); the
dequantize-and-sum and the Average's division are plain torch, as they are
plain jax in the JAX package.
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
    alltoall_chunks,
    divide_by_world,
    reducescatter_chunks,
    scale,
    world_rank,
    world_size,
)
from .compression import FP16_SAFE_MAX, Compression, is_quantized
from .quantization import (
    SCALE_DTYPE,
    dequantize_blockwise,
    quantize_blockwise,
    quantized_wire_bytes,
)

__all__ = [
    "EFResiduals",
    "FlatBuckets",
    "PackSpec",
    "bucket_byte_layout",
    "fused_allgather",
    "fused_allreduce",
    "fused_reducescatter",
    "pack",
    "quantized_bucket_layout",
    "quantized_fused_allreduce",
    "quantized_fused_reducescatter",
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


class EFResiduals(FlatBuckets):
    """Per-bucket error-feedback residuals of the quantized collectives:
    one fp32 buffer per fused bucket (padded to ``world * block``) holding
    THIS rank's accumulated quantization error -- rank-local state.
    ``threshold``/``block`` record the bucket-layout recipe the buffers
    were built for."""

    def __init__(self, buffers: Sequence[torch.Tensor], threshold: int = 0,
                 block: int = 0):
        super().__init__(buffers)
        self.threshold = int(threshold)
        self.block = int(block)

    def __repr__(self):
        return f"EFResiduals(n={len(self.buffers)}, block={self.block})"


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


def quantized_bucket_layout(
    tree,
    threshold_bytes: Optional[int] = None,
    *,
    world: int,
    compression,
) -> List[dict]:
    """The quantized wire from shapes and dtypes alone: per fused bucket,
    the padded element count (a multiple of ``world * block``, so every
    all-to-all chunk is whole blocks) and the payload, scale and total wire
    bytes one quantized collective moves."""
    block = compression.block_size()
    qspec = compression.spec
    pad_mult = world * block
    leaves, _, threshold_bytes = _flatten(tree, threshold_bytes)
    out = []
    for bucket in _bucketize(leaves, threshold_bytes):
        size = sum(leaf_nbytes(leaf) // leaf.dtype.itemsize
                   for _, leaf in bucket)
        size += (-size) % pad_mult
        out.append({
            "wire_dtype": qspec.wire_dtype_name,
            "elements": size,
            "payload_bytes": size * qspec.itemsize,
            "scale_bytes": (size // block) * SCALE_DTYPE.itemsize,
            "wire_bytes": quantized_wire_bytes(size, block, qspec),
        })
    return out


def _uniform_cast_scale(tensors, world_factor: float, axis=None):
    """Replica-uniform max-abs prescale for the fp16 wire: one scalar over
    every floating tensor, MAX-reduced across the world so every rank
    scales alike. ``world_factor`` guards the sum of a reduction (pass the
    world size); 1 for the move-only all-gather."""
    floats = [t for t in tensors if t.is_floating_point() and t.numel()]
    if not floats:
        return None
    gmax = torch.stack([t.float().abs().max() for t in floats]).max()
    gmax = allreduce_(gmax, Max, axis=axis)
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


def _dequant_sum(q2, s2, world: int, block: int) -> torch.Tensor:
    """Sum the all-to-all result rows in fp32: ``q2 [world, chunk]`` wire
    values, ``s2 [world, chunk / block]`` scales -> this rank's reduced
    ``[chunk]`` (the local half of the quantized reduce-scatter)."""
    chunk = q2.shape[1]
    deq = q2.float().reshape(world, chunk // block, block)
    deq = deq * s2.float()[:, :, None]
    return deq.sum(dim=0).reshape(chunk)


def _quantized_reduce_shards(buffers, res_bufs, *, world: int, op: ReduceOp,
                             prescale_factor: float, compression, axis=None):
    """The front half shared by the quantized allreduce and reduce-scatter:
    per packed (``world * block``-padded) bucket, error feedback, a
    blockwise quantize of this rank's contribution, the all-to-all of the
    wire chunks, and the local dequantize-and-sum. Returns ``(reduced fp32
    shards, new residuals or None)``.

    Error feedback (``res_bufs`` given): the residual added in before the
    quantize is this rank's accumulated quantization error, and the new
    residual is exactly the error of what was just sent, ``x -
    dequant(quant(x))``: no gradient mass is dropped, only delayed."""
    qspec = compression.spec
    block = compression.block_size()
    shards, new_res = [], []
    for i, buf in enumerate(buffers):
        if not buf.is_floating_point():
            raise ValueError(
                "quantized collectives support floating-point trees only; "
                f"got a {buf.dtype} bucket"
            )
        x = scale(buf.float(), prescale_factor)
        if res_bufs is not None:
            x = x + res_bufs[i].float()
        q, s = quantize_blockwise(x, block, qspec)
        if res_bufs is not None:
            new_res.append(x - dequantize_blockwise(q, s, block))
        chunk = q.shape[0] // world
        q2 = alltoall_chunks(torch.empty_like(q), q, axis=axis).reshape(
            world, chunk)
        s2 = alltoall_chunks(torch.empty_like(s), s, axis=axis).reshape(
            world, -1)
        red = _dequant_sum(q2, s2, world, block)
        if op == Average:
            red = divide_by_world(red, world)
        shards.append(red)
    return shards, (new_res if res_bufs is not None else None)


def _residual_buffers(residuals, n_buckets: int):
    if residuals is None:
        return None
    bufs = (residuals.buffers if isinstance(residuals, FlatBuckets)
            else list(residuals))
    if len(bufs) != n_buckets:
        raise ValueError(
            f"residuals carry {len(bufs)} buckets for a {n_buckets}-bucket "
            "layout; pass the residual state the optimizer built for these "
            "params"
        )
    return bufs


def _wrap_residuals(new_res, residuals, compression, threshold_bytes):
    if new_res is None:
        return None
    thr = getattr(residuals, "threshold", 0) or (threshold_bytes or 0)
    return EFResiduals(new_res, threshold=thr, block=compression.block_size())


def _gather_quantized(q, s, axis=None):
    """All-gather one rank's payload and scales: the full wire buffers."""
    world = world_size(axis)
    fq = torch.empty((world * q.shape[0],), dtype=q.dtype, device=q.device)
    fs = torch.empty((world * s.shape[0],), dtype=s.dtype, device=s.device)
    allgather_chunks(fq, q, axis=axis)
    allgather_chunks(fs, s, axis=axis)
    return fq, fs


def quantized_fused_allreduce(
    tree,
    residuals=None,
    *,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    threshold_bytes: Optional[int] = None,
    compression=Compression.int8,
    axis=None,
):
    """Allreduce a nest of tensors on the blockwise-quantized wire with
    optional error feedback; returns ``(reduced tree, new residuals)``.

    The quantized all-to-all, local fp32 dequantize-and-sum, requantize of
    the reduced chunk and all-gather (see the module docstring): one ring
    allreduce at ``itemsize + 4/block`` bytes an element. ``residuals`` (an
    :class:`EFResiduals`, one fp32 buffer per bucket) arms error feedback
    on this rank's send-side quantization. The second (broadcast)
    quantization error is the same on every rank and unbiased across
    steps; it gets no residual."""
    _check_op(op, "quantized_fused_allreduce")
    world = world_size(axis)
    block = compression.block_size()
    buffers, spec = pack(tree, threshold_bytes, pad_multiple=world * block)
    res_bufs = _residual_buffers(residuals, len(buffers))
    shards, new_res = _quantized_reduce_shards(
        buffers, res_bufs, world=world, op=op,
        prescale_factor=prescale_factor, compression=compression, axis=axis,
    )
    out_bufs = []
    for buf, red in zip(buffers, shards):
        fq, fs = _gather_quantized(
            *quantize_blockwise(red, block, compression.spec), axis=axis
        )
        out = dequantize_blockwise(fq, fs, block)
        out_bufs.append(scale(out, postscale_factor).to(buf.dtype))
    return (
        unpack(out_bufs, spec),
        _wrap_residuals(new_res, residuals, compression, threshold_bytes),
    )


def quantized_fused_reducescatter(
    tree,
    residuals=None,
    *,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    threshold_bytes: Optional[int] = None,
    compression=Compression.int8,
    axis=None,
):
    """Reduce-scatter a nest of tensors on the quantized wire: the front
    half of :func:`quantized_fused_allreduce`. Each rank ends with the
    fp32-accurate reduced 1/N shard of every bucket (padded to ``world *
    block``), in the input dtype. Returns ``(FlatBuckets shards, PackSpec,
    new residuals)``; ``fused_allgather(compression=...)`` with the same
    compression is the matching back half."""
    _check_op(op, "quantized_fused_reducescatter")
    world = world_size(axis)
    block = compression.block_size()
    buffers, spec = pack(tree, threshold_bytes, pad_multiple=world * block)
    res_bufs = _residual_buffers(residuals, len(buffers))
    shards, new_res = _quantized_reduce_shards(
        buffers, res_bufs, world=world, op=op,
        prescale_factor=prescale_factor, compression=compression, axis=axis,
    )
    out = [scale(red, postscale_factor).to(buf.dtype)
           for buf, red in zip(buffers, shards)]
    return (
        FlatBuckets(out),
        spec,
        _wrap_residuals(new_res, residuals, compression, threshold_bytes),
    )


def _quantized_gather_unpack(buffers, spec: PackSpec, compression,
                             axis=None):
    """All-gather per-bucket shards on the quantized wire: each rank
    quantizes its shard blockwise, payload and scales ride the all-gather,
    and every rank dequantizes the full bucket. A shard whose length is not
    a whole number of blocks is padded per rank and the interleaved pads
    are dropped after the gather, so this leg also follows an unquantized
    reduce-scatter."""
    block = compression.block_size()
    full = []
    for buf in buffers:
        shard = buf.shape[0]
        pad = (-shard) % block
        x = buf.float()
        if pad:
            x = torch.cat([x, x.new_zeros((pad,))])
        fq, fs = _gather_quantized(
            *quantize_blockwise(x, block, compression.spec), axis=axis
        )
        out = dequantize_blockwise(fq, fs, block)
        if pad:
            world = fq.shape[0] // (shard + pad)
            out = out.reshape(world, shard + pad)[:, :shard].reshape(-1)
        full.append(out.to(buf.dtype))
    return unpack(full, spec)


def fused_allreduce(
    tree,
    *,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    threshold_bytes: Optional[int] = None,
    compression=Compression.none,
    axis=None,
):
    """Allreduce a nest (or flat list) of tensors with bucketed fusion:
    one ``all_reduce`` per bucket. Returns new tensors in the input's
    structure; the inputs are left alone. A quantized ``compression``
    takes :func:`quantized_fused_allreduce` (without error feedback)."""
    _check_op(op, "fused_allreduce")
    if is_quantized(compression):
        out, _ = quantized_fused_allreduce(
            tree, None, op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor,
            threshold_bytes=threshold_bytes, compression=compression,
            axis=axis,
        )
        return out
    leaves, treedef, threshold_bytes = _flatten(tree, threshold_bytes)
    leaves = [_as_tensor(l) for l in leaves]
    world = world_size(axis)
    wire_scale = None
    if compression.needs_prescale:
        wire_scale = _uniform_cast_scale(leaves, float(world), axis)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for bucket in _bucketize(leaves, threshold_bytes):
        wires, ctxs = [], []
        for _, leaf in bucket:
            wire, ctx = _compress(
                compression, scale(leaf, prescale_factor), wire_scale
            )
            wires.append(wire.reshape(-1))
            ctxs.append(ctx)
        # cat copies: inputs kept
        buf = allreduce_(torch.cat(wires), Sum, axis=axis)
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
    axis=None,
) -> Tuple[FlatBuckets, PackSpec]:
    """Reduce-scatter a nest of tensors with bucketed fusion: buckets are
    packed, padded to a multiple of the world size N, and reduced with one
    ``reduce_scatter`` each, so rank ``k`` keeps elements ``[k*S/N,
    (k+1)*S/N)`` of every bucket. Returns ``(shards, spec)``; ``spec``
    restores the tree after :func:`fused_allgather`. A quantized
    ``compression`` takes :func:`quantized_fused_reducescatter` (without
    error feedback), whose buckets pad to ``world * block``."""
    _check_op(op, "fused_reducescatter")
    if is_quantized(compression):
        shards, spec, _ = quantized_fused_reducescatter(
            tree, None, op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor,
            threshold_bytes=threshold_bytes, compression=compression,
            axis=axis,
        )
        return shards, spec
    world = world_size(axis)
    buffers, spec = pack(tree, threshold_bytes, pad_multiple=world)
    wire_scale = None
    if compression.needs_prescale:
        wire_scale = _uniform_cast_scale(buffers, float(world), axis)
    shards = []
    for buf in buffers:
        wire, ctx = _compress(
            compression, scale(buf, prescale_factor), wire_scale
        )
        red = compression.decompress(
            reducescatter_chunks(wire.contiguous(), axis=axis), ctx
        )
        shards.append(_finish(red, op, world, postscale_factor))
    return FlatBuckets(shards), spec


def fused_allgather(shards, spec: PackSpec, *, compression=Compression.none,
                    axis=None):
    """All-gather per-bucket shards back into the tree ``spec`` describes:
    one ``all_gather`` per bucket into the full padded buffer, the pad
    dropped by :func:`~.batching.unpack` (the leaves are views of the
    gathered buffers). A quantized ``compression`` gathers blockwise-
    quantized shards and dequantizes the full buckets."""
    buffers = shards.buffers if isinstance(shards, FlatBuckets) else list(shards)
    if is_quantized(compression):
        return _quantized_gather_unpack(buffers, spec, compression, axis)
    wire_scale = None
    if compression.needs_prescale:
        # Move-only leg: the same scale everywhere, no world factor.
        wire_scale = _uniform_cast_scale(buffers, 1.0, axis)
    full = []
    for buf, n in zip(buffers, spec.padded_sizes()):
        wire, ctx = _compress(compression, buf, wire_scale)
        gathered = torch.empty((n,), dtype=wire.dtype, device=wire.device)
        allgather_chunks(gathered, wire.contiguous(), axis=axis)
        full.append(compression.decompress(gathered, ctx))
    return unpack(full, spec)


def shard_slice(buffers, axis=None) -> FlatBuckets:
    """This rank's contiguous 1/N slice of full fused buffers (views) --
    the layout :func:`fused_reducescatter` produces, taken locally."""
    world, rank = world_size(axis), world_rank(axis)
    bufs = buffers.buffers if isinstance(buffers, FlatBuckets) else list(buffers)
    out = []
    for buf in bufs:
        n = buf.shape[0] // world
        out.append(buf[rank * n:(rank + 1) * n])
    return FlatBuckets(out)
