"""Pad-aware packing: the slot bookkeeping that routes requests into one
fixed-shape batch and responses back out.

The port of the JAX package's ``ops/batching.py``: :func:`pack` scatters
tensors into fused 1-D buffers (padded to a multiple), :class:`PackSpec`
records which slot holds which input, and :func:`unpack` reads the slot
ranges back, dropping the pad. :func:`pack_requests` /
:func:`unpack_responses` use the same machinery to pack 1..``batch_size``
single-example requests into the ONE ``[batch_size, ...]`` shape the
inference step sees and to route each response row to its request;
:func:`pack_prompts` packs variable-length token prompts for the decode
engine's prefill the same way.

Requests are nests of dicts, lists and tuples over tensors (numpy arrays
and Python scalars are taken as tensors); :func:`tree_flatten` /
:func:`tree_unflatten` are this module's own small replacement for
``jax.tree`` (dict keys in sorted order, as JAX orders them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import time as _time

import numpy as np
import torch

from ..obs import registry as _obs
from ..utils import env as _env

_LEAF = "*"


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` of a nest of dicts/lists/tuples; ``treedef``
    is a hashable description that compares equal for equal structures."""
    leaves: List[Any] = []

    def rec(node):
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(rec(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node), tuple(rec(c) for c in node))
        leaves.append(node)
        return _LEAF

    return leaves, rec(tree)


def tree_unflatten(treedef, leaves: Sequence[Any]):
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def rec(td):
        if td == _LEAF:
            return next(it)
        kind, meta, children = td
        if kind == "dict":
            return {k: rec(c) for k, c in zip(meta, children)}
        vals = [rec(c) for c in children]
        return vals if kind == "list" else tuple(vals)

    return rec(treedef)


def tree_map(fn, tree):
    leaves, td = tree_flatten(tree)
    return tree_unflatten(td, [fn(x) for x in leaves])


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def leaf_nbytes(leaf) -> int:
    """Payload bytes of one tensor-like leaf from its shape and dtype."""
    n = 1
    for s in leaf.shape:
        n *= int(s)
    return n * leaf.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class _Slot:
    index: int  # position in the flat input list
    shape: Tuple[int, ...]
    size: int


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Recipe to scatter fused buffers back into tensors.

    ``pad`` records the trailing zero-fill appended to each fused buffer;
    :func:`unpack` only reads the slot ranges, so padded tails are
    dropped for free.
    """

    treedef: Any  # None when the input was a flat list
    buckets: Tuple[Tuple[_Slot, ...], ...]  # per-buffer slot lists
    n_leaves: int
    pad: Tuple[int, ...] = ()  # per-buffer trailing pad elements

    def bucket_sizes(self) -> Tuple[int, ...]:
        """Unpadded payload elements per fused buffer."""
        return tuple(sum(s.size for s in slots) for slots in self.buckets)

    def padded_sizes(self) -> Tuple[int, ...]:
        pads = self.pad or (0,) * len(self.buckets)
        return tuple(size + p for size, p in zip(self.bucket_sizes(), pads))


def _bucketize(leaves: Sequence[torch.Tensor], threshold_bytes: int):
    """Greedy per-dtype bucketing up to ``threshold_bytes`` per bucket.

    Leaves are walked in REVERSE order, as the JAX package walks them (in
    gradient fusion bucket 0 holds the deepest layers, whose gradients
    exist first); slot indices keep the original positions, so
    :func:`unpack` round-trips regardless of walk order."""
    by_dtype: dict = {}
    for i in range(len(leaves) - 1, -1, -1):
        leaf = leaves[i]
        by_dtype.setdefault(leaf.dtype, []).append((i, leaf))
    buckets = []
    for _, items in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        cur, cur_bytes = [], 0
        for i, leaf in items:
            nbytes = leaf_nbytes(leaf)
            if cur and cur_bytes + nbytes > threshold_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append((i, leaf))
            cur_bytes += nbytes
        if cur:
            buckets.append(cur)
    return buckets


def _leaves_of(tree) -> Tuple[List[torch.Tensor], Any]:
    if isinstance(tree, (list, tuple)) and all(
        not isinstance(t, (list, tuple, dict)) for t in tree
    ):
        return [_as_tensor(t) for t in tree], None
    leaves, treedef = tree_flatten(tree)
    return [_as_tensor(t) for t in leaves], treedef


def pack_spec(
    tree, threshold_bytes: Optional[int] = None, *, pad_multiple: int = 1
) -> Tuple[List[torch.Tensor], PackSpec]:
    """``(leaves, spec)``: the flat leaves of a nest (or flat list) and the
    :class:`PackSpec` :func:`pack` would build for them, without packing
    (the leaves may be any tensor-likes with a shape and a dtype)."""
    if threshold_bytes is None:
        threshold_bytes = _env.fusion_threshold_bytes()
    leaves, treedef = _leaves_of(tree)
    spec_buckets, pads = [], []
    for bucket in _bucketize(leaves, threshold_bytes):
        size = sum(leaf.numel() for _, leaf in bucket)
        pads.append((-size) % max(1, pad_multiple))
        spec_buckets.append(
            tuple(
                _Slot(i, tuple(leaf.shape), leaf.numel())
                for i, leaf in bucket
            )
        )
    return leaves, PackSpec(
        treedef, tuple(spec_buckets), len(leaves), tuple(pads)
    )


def pack_bucket(leaves: Sequence[torch.Tensor], pad: int) -> torch.Tensor:
    """One fused 1-D buffer: ``leaves`` flattened end to end and ``pad``
    zeros after them (a single leaf without a pad is its own flat view)."""
    parts = [leaf.reshape(-1) for leaf in leaves]
    if pad:
        parts.append(parts[0].new_zeros((pad,)))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def pack(
    tree, threshold_bytes: Optional[int] = None, *, pad_multiple: int = 1
) -> Tuple[List[torch.Tensor], PackSpec]:
    """Flatten a nest (or flat list) of tensors into fused 1-D buffers,
    each zero-filled up to a multiple of ``pad_multiple``. With the metrics
    plane on, the call's time goes to ``fusion.pack_ms``."""
    mx = _obs.enabled()
    t0 = _time.perf_counter() if mx else 0.0
    leaves, spec = pack_spec(tree, threshold_bytes, pad_multiple=pad_multiple)
    buffers = [
        pack_bucket([leaves[s.index] for s in slots], pad)
        for slots, pad in zip(spec.buckets, spec.pad)
    ]
    if mx:
        _obs.metrics().histogram("fusion.pack_ms").observe(
            (_time.perf_counter() - t0) * 1e3)
    return buffers, spec


def unpack(buffers: Sequence[torch.Tensor], spec: PackSpec):
    """Inverse of :func:`pack` (timed as ``fusion.unpack_ms``)."""
    mx = _obs.enabled()
    t0 = _time.perf_counter() if mx else 0.0
    leaves: List[Optional[torch.Tensor]] = [None] * spec.n_leaves
    for buf, slots in zip(buffers, spec.buckets):
        offset = 0
        for slot in slots:
            leaves[slot.index] = buf[offset:offset + slot.size].reshape(
                slot.shape
            )
            offset += slot.size
    out = leaves if spec.treedef is None else tree_unflatten(
        spec.treedef, leaves
    )
    if mx:
        _obs.metrics().histogram("fusion.unpack_ms").observe(
            (_time.perf_counter() - t0) * 1e3)
    return out


# -- request batching (the serve dispatcher's layer) ----------------------


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Round-trip recipe for one packed request batch.

    ``leaf_specs`` holds one :class:`PackSpec` per leaf position of the
    request nest; ``row_to_request`` is read straight off the pack slots
    (``pack`` walks leaves in reverse, so batch row 0 holds the *last*
    request packed). ``n_valid`` rows carry real requests; the rest are
    the zero pad that fills the fixed shape.
    """

    treedef: Any  # request structure (one example, no batch dim)
    leaf_specs: Tuple[PackSpec, ...]
    batch_size: int
    n_valid: int

    @property
    def fill(self) -> float:
        """Fraction of batch rows carrying real requests."""
        return self.n_valid / self.batch_size if self.batch_size else 0.0

    @property
    def row_to_request(self) -> Tuple[int, ...]:
        """``row_to_request[row] == i`` means batch row ``row`` holds
        request ``i`` (submission order)."""
        return tuple(s.index for s in self.leaf_specs[0].buckets[0])


def pack_requests(requests: Sequence[Any], batch_size: int):
    """Pack 1..``batch_size`` single-example requests into one
    fixed-shape batch.

    Every request must share one schema -- structure, leaf shapes and
    dtypes. Each leaf position is packed with :func:`pack` at
    ``pad_multiple = batch_size * example_size``, so a partial batch
    zero-fills the tail rows. Returns ``(batch, spec)``: ``batch`` has the
    request structure with a leading batch dim on every leaf."""
    if not requests:
        raise ValueError("pack_requests needs at least one request")
    if len(requests) > batch_size:
        raise ValueError(
            f"{len(requests)} requests exceed batch_size={batch_size}"
        )
    flat0, treedef = tree_flatten(requests[0])
    per_leaf: List[List[torch.Tensor]] = [[_as_tensor(l)] for l in flat0]
    for r in requests[1:]:
        flat, td = tree_flatten(r)
        if td != treedef:
            raise ValueError(
                "request schema mismatch: every request in a batch must "
                f"share one structure ({td} != {treedef})"
            )
        for j, leaf in enumerate(flat):
            leaf = _as_tensor(leaf)
            ref = per_leaf[j][0]
            if tuple(leaf.shape) != tuple(ref.shape) or (
                leaf.dtype != ref.dtype
            ):
                raise ValueError(
                    "request schema mismatch at leaf "
                    f"{j}: {tuple(leaf.shape)}/{leaf.dtype} vs "
                    f"{tuple(ref.shape)}/{ref.dtype}"
                )
            per_leaf[j].append(leaf)
    batch_leaves, leaf_specs = [], []
    for leaves in per_leaf:
        example_size = leaves[0].numel() or 1
        bufs, spec = pack(
            list(leaves),
            threshold_bytes=batch_size * example_size * 16,
            pad_multiple=batch_size * example_size,
        )
        if len(bufs) != 1:  # pragma: no cover - same-schema leaves fuse
            raise AssertionError("request leaves must pack into one bucket")
        leaf_specs.append(spec)
        batch_leaves.append(
            bufs[0].reshape((batch_size,) + tuple(leaves[0].shape))
        )
    return (
        tree_unflatten(treedef, batch_leaves),
        BatchSpec(treedef, tuple(leaf_specs), batch_size, len(requests)),
    )


def pack_prompts(prompts: Sequence[Sequence[int]], batch_size: int,
                 bucket: int):
    """The token-level front half of :func:`pack_requests`: pad 1..
    ``batch_size`` variable-length token prompts to the fixed ``bucket``
    width and pack them into the one prefill shape. Returns ``(batch,
    spec)`` with ``batch["tokens"]`` ``[batch_size, bucket]`` int32 and
    ``batch["length"]`` ``[batch_size]`` int32 (pad rows zero-length), on
    the CPU; ``spec.row_to_request[row]`` says which prompt row ``row``
    carries, as for :func:`pack_requests` (the decode engine maps prefill
    rows back to streams through it)."""
    reqs = []
    for toks in prompts:
        arr = torch.as_tensor(np.asarray(toks, np.int32).reshape(-1))
        if arr.numel() > bucket:
            raise ValueError(
                f"prompt of {arr.numel()} tokens exceeds the {bucket}-token "
                "prefill bucket"
            )
        padded = torch.zeros((bucket,), dtype=torch.int32)
        padded[:arr.numel()] = arr
        reqs.append({"tokens": padded,
                     "length": torch.tensor(arr.numel(), dtype=torch.int32)})
    return pack_requests(reqs, batch_size)


def unpack_requests(batch, spec: BatchSpec) -> List[Any]:
    """Exact inverse of :func:`pack_requests` (pad rows stripped)."""
    batch_leaves, _ = tree_flatten(batch)
    per_request: List[List[Any]] = [[] for _ in range(spec.n_valid)]
    for leaf, pspec in zip(batch_leaves, spec.leaf_specs):
        flat = unpack([leaf.reshape(-1)], pspec)
        for i, val in enumerate(flat):
            per_request[i].append(val)
    return [tree_unflatten(spec.treedef, leaves) for leaves in per_request]


def unpack_responses(outputs, spec: BatchSpec) -> List[Any]:
    """Split a batched model output back into per-request responses, in
    submission order. ``outputs`` is any nest whose leaves carry the batch
    dim first; row->request routing comes from ``spec``; pad rows are
    dropped."""
    out_leaves, out_treedef = tree_flatten(outputs)
    for leaf in out_leaves:
        if leaf.shape[0] != spec.batch_size:
            raise ValueError(
                f"output leaf has leading dim {leaf.shape[0]}, expected "
                f"the batch size {spec.batch_size}"
            )
    responses: List[Any] = [None] * spec.n_valid
    for row, req_index in enumerate(spec.row_to_request):
        responses[req_index] = tree_unflatten(
            out_treedef, [leaf[row] for leaf in out_leaves]
        )
    return responses
