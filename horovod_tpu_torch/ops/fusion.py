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

One bucket's reduction is :func:`reduce_bucket`, and a :class:`BucketPlan`
holds a call's layout, wire settings and residuals: the reductions above
run every bucket through it in pack order, and the overlap pipeline
(:mod:`.layout`) runs each bucket through the same function from the hook
of its last gradient. The four fused reductions take ``stagger=`` for the
JAX package's API and ignore it: an eager call issues its buckets in pack
order on one stream already, which is what the JAX package's chained
dispatch pins.
"""

from __future__ import annotations

import time as _time
from typing import List, Optional, Sequence, Tuple

import torch

from ..obs import registry as _obs
from ..utils import env as _env
from ..utils import timeline as _timeline
from .batching import (
    PackSpec,
    _bucketize,
    leaf_nbytes,
    pack,
    pack_bucket,
    pack_spec,
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
    "BucketPlan",
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
    "reduce_bucket",
    "shard_slice",
    "unpack",
]


def _record_fusion_layout(kind: str, bucket_bytes, n_tensors, threshold):
    """Metrics of one fused collective: the bytes it moves, its bucket
    count and fill (the JAX package records them once a trace; the eager
    port once a call, so ``fusion.traces`` counts calls)."""
    if not _obs.enabled():
        return
    reg = _obs.metrics()
    total = int(sum(bucket_bytes))
    reg.counter("fusion.traces").inc()
    reg.gauge(f"fusion.{kind}.bytes_per_step").set(total)
    reg.gauge(f"fusion.{kind}.buckets").set(len(bucket_bytes))
    reg.gauge(f"fusion.{kind}.tensors").set(n_tensors)
    if bucket_bytes and threshold:
        reg.gauge(f"fusion.{kind}.bucket_fill").set(
            total / (len(bucket_bytes) * threshold)
        )


def _record_quant_layout(kind: str, bucket_wire_bytes) -> None:
    """Quantized-wire gauges: the payload and scale bytes one call moves."""
    if not _obs.enabled():
        return
    reg = _obs.metrics()
    reg.gauge(f"fusion.quant.{kind}.wire_bytes_per_step").set(
        int(sum(bucket_wire_bytes))
    )
    reg.gauge(f"fusion.quant.{kind}.buckets").set(len(bucket_wire_bytes))


def _observe_quant_ms(t0: float) -> None:
    _obs.metrics().histogram("fusion.quant_ms").observe(
        (_time.perf_counter() - t0) * 1e3
    )


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


def _split(buf: torch.Tensor, leaves) -> List[torch.Tensor]:
    """Views of a packed buffer shaped like ``leaves`` (the pad dropped)."""
    out, offset = [], 0
    for leaf in leaves:
        n = leaf.numel()
        out.append(buf[offset:offset + n].reshape(leaf.shape))
        offset += n
    return out


def reduce_bucket(
    leaves: Sequence[torch.Tensor],
    *,
    world: int,
    pad: int = 0,
    scatter: bool = False,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    compression=Compression.none,
    residual: Optional[torch.Tensor] = None,
    wire_scale=None,
    axis=None,
):
    """One fused bucket's reduction -- the one wire code every fused
    reduction below runs, bucket after bucket, and the overlap pipeline
    (:mod:`.layout`) runs from the hook of a bucket's last gradient:
    pack, cast or quantize, the collective, dequantize and unpack (or hand
    on this rank's shard), and the error-feedback residual.

    ``leaves`` are the bucket's tensors in pack order and ``pad`` the zeros
    packed after them (``world * block`` multiples on the quantized wire,
    ``world`` multiples for a reduce-scatter). Returns ``(out,
    new_residual)``: ``out`` the reduced leaves (``scatter=False``) or this
    rank's reduced 1/N shard of the packed bucket (``scatter=True``);
    ``new_residual`` None unless ``residual``, this bucket's fp32 EF
    buffer, is given.

    Quantized (``Compression.int8``/``fp8``): error feedback (the residual
    added in before the quantize is this rank's accumulated quantization
    error, and the new residual exactly the error of what was just sent,
    ``x - dequant(quant(x))``: no gradient mass is dropped, only delayed),
    a blockwise quantize, one ``all_to_all`` of the payload and one of the
    scales, a local fp32 dequantize-and-sum of this rank's chunk -- the
    reduce-scatter -- and for the allreduce a requantize of that chunk and
    one ``all_gather`` of each back."""
    if is_quantized(compression):
        qspec = compression.spec
        block = compression.block_size()
        buf = pack_bucket(leaves, pad)
        if not buf.is_floating_point():
            raise ValueError(
                "quantized collectives support floating-point trees only; "
                f"got a {buf.dtype} bucket"
            )
        x = scale(buf.float(), prescale_factor)
        if residual is not None:
            x = x + residual.float()
        q, s = quantize_blockwise(x, block, qspec)
        new_res = (x - dequantize_blockwise(q, s, block)
                   if residual is not None else None)
        chunk = q.shape[0] // world
        q2 = alltoall_chunks(torch.empty_like(q), q, axis=axis).reshape(
            world, chunk)
        s2 = alltoall_chunks(torch.empty_like(s), s, axis=axis).reshape(
            world, -1)
        red = _dequant_sum(q2, s2, world, block)
        if op == Average:
            red = divide_by_world(red, world)
        if scatter:
            return scale(red, postscale_factor).to(buf.dtype), new_res
        fq, fs = _gather_quantized(
            *quantize_blockwise(red, block, qspec), axis=axis
        )
        out = dequantize_blockwise(fq, fs, block)
        return (_split(scale(out, postscale_factor).to(buf.dtype), leaves),
                new_res)
    if scatter:
        buf = pack_bucket(leaves, pad)
        wire, ctx = _compress(
            compression, scale(buf, prescale_factor), wire_scale
        )
        red = compression.decompress(
            reducescatter_chunks(wire.contiguous(), axis=axis), ctx
        )
        return _finish(red, op, world, postscale_factor), None
    wires, ctxs = [], []
    for leaf in leaves:
        wire, ctx = _compress(
            compression, scale(leaf, prescale_factor), wire_scale
        )
        wires.append(wire.reshape(-1))
        ctxs.append(ctx)
    # cat copies: inputs kept
    buf = allreduce_(torch.cat(wires), Sum, axis=axis)
    out = [
        _finish(compression.decompress(red, ctx), op, world, postscale_factor)
        for red, ctx in zip(_split(buf, leaves), ctxs)
    ]
    return out, None


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


class BucketPlan:
    """One fused reduction of a nest, bucket by bucket.

    The layout comes from the leaves' shapes and dtypes alone (the
    gradients' or, before they exist, the parameters'), with the wire
    settings and the per-bucket EF residuals. :meth:`reduce` runs one
    bucket through :func:`reduce_bucket`; :meth:`assemble` puts the
    buckets' results together; :meth:`run` does both over every bucket in
    pack order, which is all the fused reductions below do. The overlap
    pipeline runs :meth:`reduce` from gradient hooks instead.

    ``scatter=True`` is the reduce-scatter (each rank keeps its 1/N shard
    of every bucket, padded to a multiple of the world size, or of
    ``world * block`` on the quantized wire). The fp16 wire's replica-
    uniform prescale needs every leaf (``needs_all_leaves``): :meth:`run`
    takes it, one scalar MAX all-reduce, before the first bucket, and the
    overlap pipeline leaves such a plan to :meth:`run`."""

    def __init__(self, tree, threshold_bytes: Optional[int] = None, *,
                 scatter: bool = False, op: ReduceOp = Average,
                 prescale_factor: float = 1.0, postscale_factor: float = 1.0,
                 compression=Compression.none, residuals=None, axis=None):
        self.world = world_size(axis)
        self.scatter = scatter
        self.op = op
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self.compression = compression
        self.axis = axis
        self.threshold_bytes = threshold_bytes
        quantized = is_quantized(compression)
        if quantized:
            pad_multiple = self.world * compression.block_size()
        else:
            pad_multiple = self.world if scatter else 1
        self.leaves, self.spec = pack_spec(
            tree, threshold_bytes, pad_multiple=pad_multiple)
        self.residuals = residuals
        self.res_bufs = _residual_buffers(residuals, len(self.spec.buckets))
        self.needs_all_leaves = (not quantized) and compression.needs_prescale
        self.wire_scale = None
        self.kind = "reducescatter" if scatter else "allreduce"
        tl = _timeline.global_timeline()
        if tl.enabled or _obs.enabled():
            self._record_layout(tl, quantized)

    def _record_layout(self, tl, quantized: bool) -> None:
        """The call's layout as gauges and, with the timeline on, one
        FUSE_BUCKETS instant (the reference's per-cycle fusion event)."""
        spec = self.spec
        padded = spec.padded_sizes()
        if quantized:
            block = self.compression.block_size()
            # The allreduce moves each quantized bucket twice (all-to-all
            # and all-gather), the reduce-scatter once.
            times = 1 if self.scatter else 2
            bucket_bytes = [
                times * quantized_wire_bytes(n, block, self.compression.spec)
                for n in padded
            ]
            _record_quant_layout(self.kind, bucket_bytes)
        else:
            bucket_bytes = [
                n * self.leaves[slots[0].index].element_size()
                for n, slots in zip(padded, spec.buckets)
            ]
            threshold = self.threshold_bytes or _env.fusion_threshold_bytes()
            _record_fusion_layout(self.kind, bucket_bytes, spec.n_leaves,
                                  threshold)
        if tl.enabled:
            tl.instant("fusion", "FUSE_BUCKETS", {
                "mode": self.kind, "n_tensors": spec.n_leaves,
                "n_buckets": len(spec.buckets), "bucket_bytes": bucket_bytes,
                "pad_elements": list(spec.pad),
            })

    @property
    def n_buckets(self) -> int:
        return len(self.spec.buckets)

    def bucket_of(self) -> List[int]:
        """The bucket each leaf (in flat order) belongs to."""
        out = [0] * self.spec.n_leaves
        for b, slots in enumerate(self.spec.buckets):
            for slot in slots:
                out[slot.index] = b
        return out

    def bucket_leaves(self, b: int, leaves=None) -> List[torch.Tensor]:
        leaves = self.leaves if leaves is None else leaves
        return [leaves[slot.index] for slot in self.spec.buckets[b]]

    def reduce(self, b: int, leaves: Sequence[torch.Tensor]):
        """Bucket ``b`` of ``leaves`` (its tensors in pack order); one
        activity of the bucket in the timeline when it is on."""
        tl = _timeline.global_timeline()
        if tl.enabled:
            act = (_timeline.DIST_REDUCE_SCATTER if self.scatter
                   else _timeline.DIST_ALLREDUCE)
            with tl.activity(f"bucket{b}", act):
                return self._reduce(b, leaves)
        return self._reduce(b, leaves)

    def _reduce(self, b: int, leaves: Sequence[torch.Tensor]):
        return reduce_bucket(
            leaves, world=self.world, pad=self.spec.pad[b],
            scatter=self.scatter, op=self.op,
            prescale_factor=self.prescale_factor,
            postscale_factor=self.postscale_factor,
            compression=self.compression,
            residual=None if self.res_bufs is None else self.res_bufs[b],
            wire_scale=self.wire_scale, axis=self.axis,
        )

    def assemble(self, results):
        """``(out, new residuals)`` from every bucket's :meth:`reduce`:
        ``out`` the reduced nest, or with ``scatter`` the
        :class:`FlatBuckets` of this rank's shards."""
        new_res = (None if self.res_bufs is None
                   else [r for _, r in results])
        res = _wrap_residuals(new_res, self.residuals, self.compression,
                              self.threshold_bytes)
        if self.scatter:
            return FlatBuckets([o for o, _ in results]), res
        out: List[Optional[torch.Tensor]] = [None] * self.spec.n_leaves
        for slots, (outs, _) in zip(self.spec.buckets, results):
            for slot, o in zip(slots, outs):
                out[slot.index] = o
        if self.spec.treedef is None:
            return out, res
        return tree_unflatten(self.spec.treedef, out), res

    def run(self):
        """Every bucket of the leaves the plan was built from, in pack
        order, then :meth:`assemble` (timed as ``fusion.quant_ms`` on the
        quantized wire, as in the JAX package)."""
        mx = _obs.enabled() and is_quantized(self.compression)
        t0 = _time.perf_counter() if mx else 0.0
        if self.needs_all_leaves:
            self.wire_scale = _uniform_cast_scale(
                self.leaves, float(self.world), self.axis)
        out = self.assemble([
            self.reduce(b, self.bucket_leaves(b))
            for b in range(self.n_buckets)
        ])
        if mx:
            _observe_quant_ms(t0)
        return out


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
    stagger: bool = False,
):
    """Allreduce a nest of tensors on the blockwise-quantized wire with
    optional error feedback; returns ``(reduced tree, new residuals)``.

    Per bucket (:func:`reduce_bucket`) the quantized all-to-all, local fp32
    dequantize-and-sum, requantize of the reduced chunk and all-gather:
    one ring allreduce at ``itemsize + 4/block`` bytes an element.
    ``residuals`` (an :class:`EFResiduals`, one fp32 buffer per bucket)
    arms error feedback on this rank's send-side quantization. The second
    (broadcast) quantization error is the same on every rank and unbiased
    across steps; it gets no residual. ``stagger`` is ignored (see the
    module docstring)."""
    _check_op(op, "quantized_fused_allreduce")
    return BucketPlan(
        tree, threshold_bytes, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, compression=compression,
        residuals=residuals, axis=axis,
    ).run()


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
    stagger: bool = False,
):
    """Reduce-scatter a nest of tensors on the quantized wire: the front
    half of :func:`quantized_fused_allreduce`. Each rank ends with the
    fp32-accurate reduced 1/N shard of every bucket (padded to ``world *
    block``), in the input dtype. Returns ``(FlatBuckets shards, PackSpec,
    new residuals)``; ``fused_allgather(compression=...)`` with the same
    compression is the matching back half. ``stagger`` is ignored."""
    _check_op(op, "quantized_fused_reducescatter")
    plan = BucketPlan(
        tree, threshold_bytes, scatter=True, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, residuals=residuals, axis=axis,
    )
    shards, res = plan.run()
    return shards, plan.spec, res


def _quantized_gather_unpack(buffers, spec: PackSpec, compression,
                             axis=None):
    """All-gather per-bucket shards on the quantized wire: each rank
    quantizes its shard blockwise, payload and scales ride the all-gather,
    and every rank dequantizes the full bucket. A shard whose length is not
    a whole number of blocks is padded per rank and the interleaved pads
    are dropped after the gather, so this leg also follows an unquantized
    reduce-scatter."""
    mx = _obs.enabled()
    t0 = _time.perf_counter() if mx else 0.0
    block = compression.block_size()
    full, wire_bytes = [], []
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
        # The full gathered payload (what lands on every rank), in wire
        # bytes, as the unquantized leg counts it.
        wire_bytes.append(fq.numel() * fq.element_size()
                          + fs.numel() * fs.element_size())
        full.append(out.to(buf.dtype))
    if mx:
        _record_quant_layout("allgather", wire_bytes)
        _observe_quant_ms(t0)
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
    stagger: bool = False,
):
    """Allreduce a nest (or flat list) of tensors with bucketed fusion:
    one ``all_reduce`` per bucket (:func:`reduce_bucket`). Returns new
    tensors in the input's structure; the inputs are left alone. A
    quantized ``compression`` takes the quantized wire (without error
    feedback). ``stagger`` is ignored."""
    _check_op(op, "fused_allreduce")
    out, _ = BucketPlan(
        tree, threshold_bytes, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, compression=compression,
        axis=axis,
    ).run()
    return out


def fused_reducescatter(
    tree,
    *,
    op: ReduceOp = Average,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    threshold_bytes: Optional[int] = None,
    compression=Compression.none,
    axis=None,
    stagger: bool = False,
) -> Tuple[FlatBuckets, PackSpec]:
    """Reduce-scatter a nest of tensors with bucketed fusion: buckets are
    packed, padded to a multiple of the world size N, and reduced with one
    ``reduce_scatter`` each, so rank ``k`` keeps elements ``[k*S/N,
    (k+1)*S/N)`` of every bucket. Returns ``(shards, spec)``; ``spec``
    restores the tree after :func:`fused_allgather`. A quantized
    ``compression`` takes the quantized wire (without error feedback),
    whose buckets pad to ``world * block``. ``stagger`` is ignored."""
    _check_op(op, "fused_reducescatter")
    plan = BucketPlan(
        tree, threshold_bytes, scatter=True, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        compression=compression, axis=axis,
    )
    shards, _ = plan.run()
    return shards, plan.spec


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
    if _obs.enabled():
        # The full padded bucket (the gathered result), not the 1/N shard
        # sent, so the reduce-scatter and all-gather gauges sum to one
        # ring allreduce, as the JAX package counts them.
        _record_fusion_layout(
            "allgather",
            [n * buf.element_size()
             for n, buf in zip(spec.padded_sizes(), buffers)],
            spec.n_leaves, _env.fusion_threshold_bytes())
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
