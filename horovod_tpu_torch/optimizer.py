"""Distributed optimizers: gradient reduction around an inner optimizer,
replicated or with the ZeRO-1 sharded update.

The port of the JAX package's ``optimizer.py``. An optimizer here has the
shape of an optax ``GradientTransformation``: ``init(params) -> state``
and ``update(grads, state, params) -> (updates, state)`` over dicts (or
nests) of tensors; the caller adds the updates to the parameters
(:mod:`.parallel.dp` does so in place). State tensors live on the
parameters' device, the step count included, so no step waits on the host.

* :func:`adamw` -- AdamW with optax ``adamw`` semantics: decay on every
  leaf, ``eps`` outside the square root and ``eps_root`` inside it, bias
  correction at ``count + 1``, ``weight_decay`` 1e-4 by default, update
  ``-lr * (m_hat / (sqrt(v_hat + eps_root) + eps) + wd * p)``.
  ``torch.optim.AdamW`` is not a drop-in (other default decay, decay
  folded into the parameter, another order of operations).
* :func:`sgd` -- SGD with optax ``sgd`` semantics (optional momentum).
* :func:`fused_adamw` -- the same optimizer carrying its hyperparameters
  as a :class:`~.ops.fused_adamw.FusedAdamSpec`, so the sharded update can
  run it as one fused kernel pass per flat shard bucket
  (``fused_update=True``; :mod:`.ops.fused_adamw`).
* :func:`DistributedOptimizer` -- replicated: one fused allreduce of the
  gradients (:func:`~.ops.fusion.fused_allreduce`), or their Adasum
  (:func:`~.ops.adasum.adasum_allreduce_tree`), then the inner update;
  ``backward_passes_per_step=k`` accumulates k passes' gradients locally
  and reduces and updates on every k-th.
* :func:`ShardedDistributedOptimizer` -- ZeRO-1: gradients packed into
  buckets padded to a multiple of the world size and reduce-scattered,
  the inner update on this rank's 1/N shard (with 1/N optimizer state),
  and one all-gather of the updates. Its state is this process's shards
  of the flat buckets of the *port's own* parameter dict (names sorted as
  strings), so it is not byte-compatible with the JAX package's runtime
  state, which packs the flax tree; the canonical form below is keyed by
  parameter name instead.

``compression=Compression.int8`` / ``Compression.fp8`` takes the
blockwise-quantized wire (:mod:`.ops.fusion`): both wrappers then keep
per-bucket **error-feedback residuals** in their state (``residual``, an
:class:`~.ops.fusion.EFResiduals`), this rank's quantization error, added
back into the next step's gradient so no gradient mass is lost, only
delayed; ``error_feedback=False`` drops them. The block size and the
fusion threshold are pinned at construction, since the residual layout is
state.

The world-size-portable form that checkpoints store (gather on save,
reshard on restore; :mod:`.checkpoint` applies it to every ``TrainState``):

* :func:`unshard_opt_state` -- a ZeRO-1 state to a
  :class:`CanonicalOptState`: every rank's shards all-gathered into the
  full buckets and unpacked into parameter-shaped leaves keyed by
  parameter name (:class:`CanonicalBuckets`), the padding stripped, so the
  form depends on neither the world size nor the bucket packing;
  :func:`reshard_opt_state` packs it back for any world, fusion threshold
  and block and keeps this rank's shards;
* :func:`canonicalize_dist_state` / :func:`reshard_dist_state` -- the same
  for a replicated state on the quantized wire, whose moments are
  replicated already and pass through;
* the EF residuals in their *mean-equivalent* form
  (:class:`CanonicalResiduals`): the sum over ranks divided by the world
  size, which every rank of the new world receives, so the residuals'
  effect on the Average-reduced gradient survives an N -> M rescale.

Unshard and canonicalize are collectives (an all-gather, an all-reduce):
every rank of the world that built the state calls them together, over
the world axes.

Both wrappers split a step in a reduce phase, bucket by bucket, and an
update phase on the reduced buckets or shards (:class:`Reduction`,
``wrapper.reduction``); ``update`` runs the two back to back, and the
overlap pipeline (:mod:`.ops.layout`) drives the reduce phase from the
gradient hooks.

Under the gradient guard (:mod:`.guard`) a wrapper's ``update`` and
``finish`` take the step's replica-uniform verdict ``ok`` (a 0-d bool
tensor on the device): the reduction and the update always run, and only
the commit depends on ``ok`` (:func:`guarded_commit`). The fused ZeRO-1
update writes its moments in place, so there ``ok`` reaches the fused
kernel as its skip flag and the count advances by ``ok``.

:func:`grad` and :func:`value_and_grad` are ``torch.func``'s with the
gradients reduced as the optimizer reduces them. Every wrapper takes
``axis=``, the mesh axes it reduces over (default the world's).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple, Optional

import torch

from .exceptions import HorovodTpuError
from .obs import registry as _obs
from .ops.batching import (
    PackSpec,
    _bucketize,
    _Slot,
    leaf_nbytes,
    tree_flatten,
    tree_unflatten,
    unpack,
)
from .ops.adasum import adasum_allreduce_tree
from .ops.collectives import (
    Adasum,
    Average,
    ReduceOp,
    Sum,
    allgather_chunks,
    allreduce,
    allreduce_,
)
from .ops.collectives import world_size as _world_size
from .ops.compression import Compression, is_quantized
from .ops.fused_adamw import FusedAdamSpec, fused_adamw_update
from .ops.fusion import (
    BucketPlan,
    EFResiduals,
    FlatBuckets,
    bucket_byte_layout,
    fused_allgather,
    fused_allreduce,
    pack,
    shard_slice,
)
from .utils import env as _env

__all__ = [
    "AdamState",
    "CanonicalBuckets",
    "CanonicalDistOptState",
    "CanonicalOptState",
    "CanonicalResiduals",
    "DistributedOptState",
    "DistributedOptimizer",
    "FusedAdamSpec",
    "Optimizer",
    "Reduction",
    "ShardedDistributedOptimizer",
    "ShardedOptState",
    "adamw",
    "sgd",
    "canonicalize_dist_state",
    "canonicalize_sharded_states",
    "ef_residual_norm",
    "fused_adamw",
    "grad",
    "guarded_commit",
    "has_canonical_state",
    "has_ef_residuals",
    "has_sharded_state",
    "reshard_dist_state",
    "reshard_opt_state",
    "reshard_sharded_states",
    "unshard_opt_state",
    "value_and_grad",
]


class Optimizer(NamedTuple):
    """``init(params) -> state``, ``update(grads, state, params) ->
    (updates, state)`` -- the shape of an optax GradientTransformation.
    ``fused_spec`` is set by :func:`fused_adamw`; ``reduction`` by the
    distributed wrappers (see :class:`Reduction`)."""

    init: Any
    update: Any
    fused_spec: Optional[FusedAdamSpec] = None
    reduction: Any = None


class Reduction(NamedTuple):
    """One step of a distributed wrapper split in its two phases, what the
    overlap pipeline (:mod:`.ops.layout`) drives: ``plan`` (a
    :class:`~.ops.fusion.BucketPlan`) reduces the gradients bucket by
    bucket, and ``finish(out, new_residuals, params) -> (updates,
    state)`` is the update phase on the plan's assembled result.
    ``wrapper.reduction(state, like)`` builds it over the leaves of
    ``like`` (the gradients, or the parameters they will be shaped like),
    or returns None for a pass that does not reduce bucket by bucket
    (Adasum, ``backward_passes_per_step > 1``). A wrapper's own ``update``
    runs both phases back to back."""

    plan: BucketPlan
    finish: Any


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count (an int32 tensor on
    the parameters' device) and the two moments, shaped like the
    parameters."""

    count: torch.Tensor
    mu: Any
    nu: Any


def _map(fn, *trees):
    """``fn`` over the leaves of like-structured nests (or FlatBuckets)."""
    if isinstance(trees[0], FlatBuckets):
        return FlatBuckets([fn(*xs) for xs in zip(*(t.buffers for t in trees))])
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(*(f[0] for f in flat))])


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, FlatBuckets):
        return tree.buffers[0]
    return tree_flatten(tree)[0][0]


def adamw(
    learning_rate: float,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    eps_root: float = 0.0,
    weight_decay: float = 1e-4,
) -> Optimizer:
    """AdamW with optax ``adamw`` semantics (see the module docstring);
    each step is a handful of elementwise ops per leaf, in fp32 for fp32
    parameters."""
    spec = FusedAdamSpec(float(learning_rate), float(b1), float(b2),
                         float(eps), float(eps_root), float(weight_decay))
    return Optimizer(*_adamw_fns(spec))


def _adamw_fns(spec: FusedAdamSpec):
    def init(params):
        device = _first_leaf(params).device
        return AdamState(
            torch.zeros((), dtype=torch.int32, device=device),
            _map(torch.zeros_like, params),
            _map(torch.zeros_like, params),
        )

    def update(grads, state: AdamState, params=None):
        count = state.count + 1
        c = count.float()
        bc1 = 1.0 - spec.b1 ** c
        bc2 = 1.0 - spec.b2 ** c
        mu = _map(lambda g, m: (1.0 - spec.b1) * g + spec.b1 * m, grads,
                  state.mu)
        nu = _map(lambda g, v: (1.0 - spec.b2) * (g * g) + spec.b2 * v, grads,
                  state.nu)

        def one(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2 + spec.eps_root) + spec.eps)
            if spec.weight_decay:
                if p is None:
                    raise ValueError("adamw with weight decay needs params")
                u = u + spec.weight_decay * p
            return -spec.learning_rate * u

        if params is None:
            updates = _map(lambda m, v: one(m, v, None), mu, nu)
        else:
            updates = _map(one, mu, nu, params)
        return updates, AdamState(count, mu, nu)

    return init, update


def fused_adamw(
    learning_rate: float,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    eps_root: float = 0.0,
    weight_decay: float = 1e-4,
) -> Optimizer:
    """:func:`adamw` that also runs as the fused ZeRO-1 update
    (``ShardedDistributedOptimizer(fused_update=True)``): its
    hyperparameters are static floats (no schedules) handed to the fused
    kernel as arguments. Unfused it is :func:`adamw` exactly."""
    if callable(learning_rate):
        raise ValueError(
            "fused_adamw needs a static float learning rate (the fused "
            "kernel takes it as an argument)"
        )
    spec = FusedAdamSpec(float(learning_rate), float(b1), float(b2),
                         float(eps), float(eps_root), float(weight_decay))
    return Optimizer(*_adamw_fns(spec), fused_spec=spec)


class TraceState(NamedTuple):
    """optax's ``TraceState``: the momentum buffer, shaped like the
    parameters."""

    trace: Any


def sgd(learning_rate: float, momentum: Optional[float] = None) -> Optimizer:
    """SGD with optax ``sgd`` semantics: with ``momentum`` the trace
    ``t = g + momentum * t`` (no Nesterov) and the update ``-lr * t``;
    without it ``-lr * g`` and an empty state."""
    lr = float(learning_rate)

    def init(params):
        if momentum is None:
            return TraceState(None)
        return TraceState(_map(torch.zeros_like, params))

    def update(grads, state: TraceState, params=None):
        if momentum is None:
            return _map(lambda g: -lr * g, grads), state
        trace = _map(lambda g, t: g + momentum * t, grads, state.trace)
        return _map(lambda t: -lr * t, trace), TraceState(trace)

    return Optimizer(init, update)


class DistributedOptState(NamedTuple):
    """State of :func:`DistributedOptimizer`, in the reference's field
    order: the inner state, the local gradient accumulator (None unless
    ``backward_passes_per_step > 1``), the passes taken (an int32 tensor on
    the parameters' device) and the quantized wire's EF residuals."""

    inner: Any
    acc: Any
    count: torch.Tensor
    residual: Optional[EFResiduals] = None


def _resolve_fused_update(optimizer: Optimizer, fused_update) -> bool:
    """An explicit ``True`` without a fused spec raises; the env default
    degrades to the unfused update with a warning."""
    explicit = fused_update is not None
    if fused_update is None:
        fused_update = _env.fused_update_default()
    if fused_update and optimizer.fused_spec is None:
        if explicit:
            raise HorovodTpuError(
                "fused_update=True needs an optimizer with static AdamW "
                "hyperparameters; build it with horovod_tpu_torch."
                "fused_adamw(lr, ...)"
            )
        warnings.warn(
            "HVDTPU_FUSED_UPDATE=1 ignored: the inner optimizer carries no "
            "fused spec (use horovod_tpu_torch.fused_adamw)",
            stacklevel=3,
        )
        return False
    return bool(fused_update)


def _resolve_quant(compression, threshold_bytes):
    """Pin a quantized compressor's block size and the fusion threshold at
    construction: the EF residual layout is state, so a later change of
    the env knobs must not desync it from the live buffers. Returns
    ``(compression, threshold_bytes, quantized)``."""
    if not is_quantized(compression):
        return compression, threshold_bytes, False
    compression = compression.with_block(compression.block_size())
    if threshold_bytes is None:
        threshold_bytes = _env.fusion_threshold_bytes()
    return compression, threshold_bytes, True


def _init_residuals(params, threshold_bytes, block, axis=None) -> EFResiduals:
    """Zero EF residuals, one fp32 ``[padded]`` buffer per bucket of the
    layout the quantized collectives pack (padded to ``world * block``):
    this rank's own."""
    layout = bucket_byte_layout(params, threshold_bytes,
                                pad_multiple=_world_size(axis) * block)
    device = _first_leaf(params).device
    bufs = [
        torch.zeros((nbytes // getattr(torch, dt).itemsize,),
                    dtype=torch.float32, device=device)
        for dt, nbytes in layout
    ]
    return EFResiduals(bufs, threshold=threshold_bytes, block=block)


def _record_grad_bytes(grads) -> None:
    """The gradient payload one optimizer update reduces (leaf bytes,
    before any compression): the optimizer-level view the per-collective
    fusion gauges roll up into. ``optimizer.reduce_traces`` counts the
    JAX package's traces, the port's calls."""
    if not _obs.enabled():
        return
    leaves, _ = tree_flatten(grads)
    total = sum(leaf_nbytes(l) for l in leaves)
    reg = _obs.metrics()
    reg.gauge("optimizer.grad_bytes_per_step").set(total)
    reg.counter("optimizer.reduce_traces").inc()


def _record_fused_update(n_buffers: int) -> None:
    if not _obs.enabled():
        return
    reg = _obs.metrics()
    reg.gauge("optimizer.fused_update").set(1.0)
    reg.gauge("optimizer.fused_update_buckets").set(n_buffers)


def _reduce_grads(grads, op, compression, prescale, postscale, axis,
                  threshold):
    """The reference's ``_reduce_grads``: Adasum per leaf (ignoring the
    wire's compression, the scale factors and the threshold), else one
    fused allreduce per bucket."""
    _record_grad_bytes(grads)
    if op == Adasum:
        return adasum_allreduce_tree(grads, axis=axis)
    return fused_allreduce(
        grads, op=op, prescale_factor=prescale, postscale_factor=postscale,
        axis=axis, threshold_bytes=threshold, compression=compression,
    )


def _zeros(tree):
    return _map(torch.zeros_like, tree)


def _select(ok, new, old):
    """``new`` where ``ok``, else ``old``, over two like-structured states;
    a node ``new`` shares with ``old`` (a buffer updated in place, the
    layout recipe) passes as it is."""
    if new is old or old is None:
        return new
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if isinstance(new, EFResiduals):
        return EFResiduals(_select(ok, new.buffers, old.buffers),
                           new.threshold, new.block)
    if isinstance(new, FlatBuckets):
        return FlatBuckets(_select(ok, new.buffers, old.buffers))
    if isinstance(new, dict):
        return type(new)((k, _select(ok, v, old[k])) for k, v in new.items())
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_select(ok, a, b) for a, b in zip(new, old)))
    if isinstance(new, (list, tuple)):
        return type(new)(_select(ok, a, b) for a, b in zip(new, old))
    return new


def guarded_commit(ok, updates, new_opt_state, opt_state, *,
                   updates_skipped: bool = False):
    """Commit or skip one optimizer step under the gradient guard: returns
    ``(updates, opt_state)`` -- the fresh pair where ``ok``, else updates
    of -0.0 (``p + (-0.0)`` is ``p`` bit for bit) and the incoming state
    -- selected on the device with ``torch.where``, with no host sync.

    The update and its collectives always run (``ok`` is replica-uniform,
    and collectives never sit under data-dependent control flow); only the
    commit depends on it. The selection covers the whole state: the inner
    moments and count, the ZeRO-1 flat buckets, the wrappers' counts and
    the quantized wire's EF residuals, which would otherwise keep the
    quantization error of a gradient that was never applied. A reduction
    writes its residuals to new buffers, so the incoming ones are the
    snapshot to restore. State updated in place (the fused kernel's
    moments, under its own skip flag) is the same object in both states
    and passes. ``updates_skipped`` says the updates are already -0.0 on a
    skip (the fused kernel's, through an exact gather). ``ok=None`` (no
    guard) commits the fresh pair as it is."""
    if ok is None:
        return updates, new_opt_state
    if not updates_skipped:
        updates = _map(lambda u: torch.where(ok, u, -0.0), updates)
    return updates, _select(ok, new_opt_state, opt_state)


class _Passes:
    """The host's count of passes beside the state's device ``count``, so
    ``backward_passes_per_step`` decides to skip or sync without reading
    the device every step: a state this optimizer returned is recognised
    by its ``count`` tensor, any other (the first, or a restored
    checkpoint's) is read once."""

    def __init__(self):
        self.tensor = None
        self.value = 0

    def next(self, count: torch.Tensor) -> int:
        value = self.value if count is self.tensor else int(count)
        return value + 1

    def keep(self, count: torch.Tensor, value: int) -> None:
        self.tensor, self.value = count, value


def DistributedOptimizer(
    optimizer: Optimizer,
    *,
    op: ReduceOp = Average,
    compression=Compression.none,
    backward_passes_per_step: int = 1,
    average_aggregated_gradients: bool = False,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    axis=None,
    threshold_bytes: Optional[int] = None,
    sharded: bool = False,
    gather_compression=Compression.none,
    fused_update: Optional[bool] = None,
    error_feedback: bool = True,
) -> Optimizer:
    """Wrap ``optimizer`` with gradient reduction across ``axis`` (default
    the world axes): one fused allreduce per bucket of at most
    ``threshold_bytes``, then the inner update, identical on every rank.
    ``sharded=True`` is :func:`ShardedDistributedOptimizer`.

    ``op=Adasum`` reduces per leaf through :func:`~.ops.adasum.
    adasum_allreduce_tree` and, as the reference's ``_reduce_grads`` does,
    ignores ``compression``, ``prescale_factor``, ``postscale_factor`` and
    ``threshold_bytes``, which apply to Average and Sum only.

    ``backward_passes_per_step=k`` adds each pass's gradients into the
    state's ``acc``; every k-th pass reduces ``acc`` (divided by k with
    ``average_aggregated_gradients``), runs the inner update and zeroes
    ``acc``, and the other passes return zero updates with the inner state
    untouched (the zero updates are -0.0, which an update added to the
    parameters leaves bit for bit). The skip decision reads a host count,
    not the device.

    A quantized ``compression`` reduces through
    :func:`~.ops.fusion.quantized_fused_allreduce`, with error-feedback
    residuals in the state unless ``error_feedback=False``."""
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if op not in (Average, Sum, Adasum):
        raise ValueError(
            "DistributedOptimizer reduces with Average, Sum or Adasum")
    if sharded:
        if backward_passes_per_step != 1:
            raise NotImplementedError(
                "sharded=True does not support backward_passes_per_step > 1"
            )
        return ShardedDistributedOptimizer(
            optimizer, op=op, compression=compression,
            gather_compression=gather_compression,
            prescale_factor=prescale_factor, postscale_factor=postscale_factor,
            axis=axis, threshold_bytes=threshold_bytes,
            fused_update=fused_update, error_feedback=error_feedback,
        )
    if fused_update:
        raise NotImplementedError(
            "fused_update requires the ZeRO-1 flat-shard layout; pass "
            "sharded=True"
        )
    if fused_update is None and _env.fused_update_default():
        warnings.warn(
            "HVDTPU_FUSED_UPDATE=1 ignored: the fused optimizer update "
            "requires the ZeRO-1 sharded path (sharded=True)",
            stacklevel=2,
        )

    compression, threshold_bytes, quantized = _resolve_quant(
        compression, threshold_bytes
    )
    if quantized and op not in (Average, Sum):
        raise ValueError("quantized compression supports op=Average/Sum")
    if quantized and backward_passes_per_step != 1:
        raise NotImplementedError(
            "quantized compression does not support "
            "backward_passes_per_step > 1 (the quantized wire's residuals "
            "follow every reduction; accumulate with "
            "make_train_step(accum_steps=K) instead)"
        )
    ef = quantized and error_feedback
    bpps = backward_passes_per_step
    passes = _Passes()

    def init(params):
        residual = (
            _init_residuals(params, threshold_bytes, compression.block_size(),
                            axis)
            if ef else None
        )
        return DistributedOptState(
            optimizer.init(params),
            None if bpps == 1 else _zeros(params),
            torch.zeros((), dtype=torch.int32,
                        device=_first_leaf(params).device),
            residual,
        )

    def reduction(state: DistributedOptState, like) -> Optional[Reduction]:
        # Adasum reduces per leaf, and the reference takes no stagger there;
        # an accumulating pass reduces (or not) after its backward.
        if op == Adasum or bpps != 1:
            return None
        _record_grad_bytes(like)
        plan = BucketPlan(
            like, threshold_bytes, op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, compression=compression,
            residuals=state.residual if quantized else None, axis=axis,
        )

        def finish(reduced, new_res, params=None, ok=None):
            updates, inner = optimizer.update(reduced, state.inner, params)
            new = DistributedOptState(inner, None, state.count + 1, new_res)
            return guarded_commit(ok, updates, new, state)

        return Reduction(plan, finish)

    def update(grads, state: DistributedOptState, params=None, ok=None):
        red = reduction(state, grads)
        if red is not None:
            return red.finish(*red.plan.run(), params, ok)
        return guarded_commit(ok, *_unbucketed_update(grads, state, params),
                              state)

    def _unbucketed_update(grads, state: DistributedOptState, params):
        if bpps == 1:  # Adasum
            reduced = _reduce_grads(grads, op, compression, prescale_factor,
                                    postscale_factor, axis, threshold_bytes)
            updates, inner = optimizer.update(reduced, state.inner, params)
            return updates, DistributedOptState(inner, None, state.count + 1)
        acc = _map(torch.add, state.acc, grads)
        value = passes.next(state.count)
        count = state.count + 1
        passes.keep(count, value)
        if value % bpps:
            # Negative zeros: p + (-0.0) is p for every p, where p + 0.0
            # turns a -0.0 parameter into +0.0.
            skip = _map(lambda a: torch.full_like(a, -0.0), acc)
            return skip, DistributedOptState(state.inner, acc, count)
        if average_aggregated_gradients:
            acc = _map(lambda g: g / bpps, acc)
        reduced = _reduce_grads(acc, op, compression, prescale_factor,
                                postscale_factor, axis, threshold_bytes)
        updates, inner = optimizer.update(reduced, state.inner, params)
        return updates, DistributedOptState(inner, _zeros(acc), count)

    return Optimizer(init, update, reduction=reduction)


class ShardedOptState(NamedTuple):
    """State of :func:`ShardedDistributedOptimizer`: the inner state over
    this rank's shards of the flat buckets (:class:`FlatBuckets` leaves),
    the step count, the layout recipe -- the fusion threshold, the world
    size and the quantization block the padding was built for (buckets pad
    to ``world * block``; 1 unquantized) -- and the quantized wire's EF
    residuals (None without error feedback)."""

    inner: Any
    count: torch.Tensor
    threshold: int
    world: int
    block: int = 1
    residual: Optional[EFResiduals] = None


def _fused_flat_update(g_shards, inner: AdamState, p_shards,
                       spec: FusedAdamSpec, ok=None):
    """One fused AdamW kernel pass per shard bucket. The moments are
    updated in place; the count stays on the device. With the guard's
    ``ok`` the kernel skips where it is False (updates of -0.0, the moments
    untouched) and the count advances by ``ok``."""
    if not isinstance(inner, AdamState) or not isinstance(inner.mu, FlatBuckets):
        raise HorovodTpuError(
            "fused_update could not find the flat-bucket Adam moments in "
            "the optimizer state; build the optimizer with "
            "horovod_tpu_torch.fused_adamw(...) and sharded=True"
        )
    flag = None if ok is None else ok.to(torch.int32)
    out = [
        fused_adamw_update(p, m, v, g, inner.count, spec, flag)
        for p, m, v, g in zip(p_shards.buffers, inner.mu.buffers,
                              inner.nu.buffers, g_shards.buffers)
    ]
    step = 1 if flag is None else flag
    _record_fused_update(len(out))
    return FlatBuckets(out), AdamState(inner.count + step, inner.mu, inner.nu)


def ShardedDistributedOptimizer(
    optimizer: Optimizer,
    *,
    op: ReduceOp = Average,
    compression=Compression.none,
    gather_compression=Compression.none,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    axis=None,
    threshold_bytes: Optional[int] = None,
    fused_update: Optional[bool] = None,
    error_feedback: bool = True,
) -> Optimizer:
    """Gradient reduction with the ZeRO-1 sharded weight update, across
    ``axis`` (one mesh axis, default the world's; Average or Sum).

    Gradients are packed into fused buckets padded to a multiple of the
    world size N and reduce-scattered (``compression`` rides that wire),
    the inner optimizer runs on this rank's contiguous 1/N shard of every
    bucket (1/N of the optimizer state and of the update work), and one
    all-gather of the updates (``gather_compression`` on that wire)
    restores the full tree. The inner optimizer must be elementwise.

    ``fused_update=True`` (default reads ``HVDTPU_FUSED_UPDATE``) runs the
    inner update as one fused AdamW kernel pass per shard bucket
    (:func:`~.ops.fused_adamw.fused_adamw_update`); it needs an optimizer
    from :func:`fused_adamw`, and its state is the unfused one's.

    A quantized ``compression`` reduce-scatters through
    :func:`~.ops.fusion.quantized_fused_reducescatter` (buckets padded to
    ``world * block``, error-feedback residuals in the state unless
    ``error_feedback=False``) and, unless ``gather_compression`` says
    otherwise, quantizes the update all-gather the same way."""
    if op not in (Average, Sum):
        raise ValueError(
            "ShardedDistributedOptimizer supports Average/Sum (Adasum's "
            "recursive halving has no scatter form here)"
        )
    if axis is not None and not isinstance(axis, str) and len(axis) != 1:
        raise HorovodTpuError(
            "sharded weight update supports a single world axis; got "
            f"{axis} (flatten the mesh or pass axis=<one name>)"
        )
    # Pinned at construction: init records the layout and update packs
    # with it, so a later change of the env knob cannot desync them.
    threshold_bytes = (
        threshold_bytes if threshold_bytes is not None
        else _env.fusion_threshold_bytes()
    )
    compression, threshold_bytes, quantized = _resolve_quant(
        compression, threshold_bytes
    )
    gather_compression, _, _ = _resolve_quant(gather_compression, None)
    if quantized and gather_compression is Compression.none:
        # One compression knob quantizes both legs; an explicit
        # gather_compression still wins.
        gather_compression = compression
    ef = quantized and error_feedback
    block = compression.block_size() if quantized else 1
    fused = _resolve_fused_update(optimizer, fused_update)

    def init(params):
        world = _world_size(axis)
        buffers, _ = pack(params, threshold_bytes, pad_multiple=world * block)
        shards = shard_slice(buffers, axis)
        residual = (
            _init_residuals(params, threshold_bytes, block, axis)
            if ef else None
        )
        return ShardedOptState(
            optimizer.init(shards),
            torch.zeros((), dtype=torch.int32, device=buffers[0].device),
            threshold_bytes, world, block, residual,
        )

    def reduction(state: ShardedOptState, like) -> Reduction:
        world = _world_size(axis)
        if world != state.world:
            raise HorovodTpuError(
                f"the sharded state was built for a world of {state.world}, "
                f"this world has {world} ranks"
            )
        _record_grad_bytes(like)
        plan = BucketPlan(
            like, threshold_bytes, scatter=True, op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, compression=compression,
            residuals=state.residual if quantized else None, axis=axis,
        )

        def finish(g_shards, new_res, params, ok=None):
            # The update phase: this rank's shards of the parameters, the
            # inner (or fused) update on them, the update all-gather; under
            # the guard, the commit selected on ``ok``.
            p_buffers, _ = pack(params, threshold_bytes,
                                pad_multiple=world * block)
            if [b.shape[0] for b in p_buffers] != list(
                    plan.spec.padded_sizes()):
                raise HorovodTpuError(
                    "gradient and parameter bucket layouts differ; the "
                    "sharded update needs grads to pack like params (same "
                    "tree, shapes and dtypes)"
                )
            p_shards = shard_slice(p_buffers, axis)
            if fused:
                u_shards, inner = _fused_flat_update(
                    g_shards, state.inner, p_shards, optimizer.fused_spec, ok
                )
            else:
                u_shards, inner = optimizer.update(g_shards, state.inner,
                                                   p_shards)
            updates = fused_allgather(u_shards, plan.spec,
                                      compression=gather_compression,
                                      axis=axis)
            new = state._replace(inner=inner, count=state.count + 1,
                                 residual=new_res)
            # The fused kernel's -0.0 survives an exact or cast gather; a
            # quantized one dequantizes it to +0.0, so it is selected again.
            return guarded_commit(
                ok, updates, new, state,
                updates_skipped=fused and not is_quantized(gather_compression))

        return Reduction(plan, finish)

    def update(grads, state: ShardedOptState, params=None, ok=None):
        if params is None:
            raise ValueError(
                "ShardedDistributedOptimizer.update requires params (the "
                "local param shard feeds the inner update)"
            )
        red = reduction(state, grads)
        return red.finish(*red.plan.run(), params, ok)

    return Optimizer(init, update, reduction=reduction)


def _nodes(tree, is_node):
    """Every node of ``tree`` (dataclasses, dicts, lists, tuples) that
    ``is_node`` picks, none below one."""
    if is_node(tree):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _nodes(getattr(tree, f.name), is_node)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _nodes(v, is_node)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _nodes(v, is_node)


def _ef_nodes(tree):
    return _nodes(tree, lambda n: isinstance(n, EFResiduals))


def has_ef_residuals(tree) -> bool:
    """True when ``tree`` (a train state, an optimizer state or any nest
    of them) carries quantized-wire EF residuals."""
    return any(True for _ in _ef_nodes(tree))


def ef_residual_norm(tree) -> Optional[float]:
    """L2 norm of every EF residual this process holds in ``tree`` (None
    when it carries none); reading it syncs with the device."""
    sq = [b.float().square().sum() for n in _ef_nodes(tree) for b in n.buffers]
    if not sq:
        return None
    return float(torch.stack(sq).sum().sqrt())


# -- the world-size-portable form (checkpoints) ------------------------------


class CanonicalOptState(NamedTuple):
    """World-size-portable form of :class:`ShardedOptState`: the inner
    state's flat buckets unpacked into parameter-shaped leaves
    (:class:`CanonicalBuckets`), the padding stripped; ``threshold`` and
    ``block`` the layout recipe to repack with (a checkpoint restore takes
    them from its target); ``residual`` the EF residuals'
    :class:`CanonicalResiduals`, or None."""

    inner: Any
    count: Any
    threshold: int
    block: int = 1
    residual: Optional["CanonicalResiduals"] = None


class CanonicalDistOptState(NamedTuple):
    """Canonical form of a quantized :class:`DistributedOptState`: ``inner``
    and ``acc`` are replicated and pass through; the EF residuals
    canonicalize as the sharded path's do."""

    inner: Any
    acc: Any
    count: Any
    residual: Any


class CanonicalResiduals:
    """The mean-equivalent EF residual (sum over ranks / world), unpacked
    into a parameter-shaped fp32 tree; ``threshold`` and ``block`` are the
    bucket-layout recipe the runtime :class:`~.ops.fusion.EFResiduals`
    repack with (a checkpoint restore takes them from its target)."""

    def __init__(self, tree, threshold: int = 0, block: int = 0):
        self.tree = tree
        self.threshold = int(threshold)
        self.block = int(block)

    def __repr__(self):
        return f"CanonicalResiduals(block={self.block})"


class CanonicalBuckets:
    """Marks a parameter-shaped tree standing where a :class:`FlatBuckets`
    stood, so :func:`reshard_opt_state` finds the re-pack boundaries."""

    def __init__(self, tree):
        self.tree = tree

    def __repr__(self):
        return "CanonicalBuckets(...)"


def _is_flat(n) -> bool:
    return isinstance(n, FlatBuckets)


def _is_canonical(n) -> bool:
    return isinstance(n, CanonicalBuckets)


def _map_nodes(fn, tree, is_node):
    """``fn`` on every node of ``tree`` that ``is_node`` picks; dicts,
    NamedTuples, lists and tuples are rebuilt as their own types, anything
    else passes through."""
    if is_node(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_nodes(fn, v, is_node))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_nodes(fn, v, is_node) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_nodes(fn, v, is_node) for v in tree)
    return tree


def has_sharded_state(tree) -> bool:
    """True when ``tree`` holds state that canonicalizes for a portable
    save: a :class:`ShardedOptState`, or a :class:`DistributedOptState`
    carrying EF residuals."""
    return any(
        isinstance(n, ShardedOptState) or n.residual is not None
        for n in _nodes(tree, lambda n: isinstance(
            n, (ShardedOptState, DistributedOptState)))
    )


def has_canonical_state(tree) -> bool:
    """True when ``tree`` holds a canonical (checkpoint-form) state."""
    return any(True for _ in _nodes(tree, lambda n: isinstance(
        n, (CanonicalOptState, CanonicalDistOptState))))


def _layout(params, threshold_bytes: int, pad_multiple: int) -> PackSpec:
    """The bucket layout :func:`~.ops.batching.pack` gives ``params``
    (padded to ``pad_multiple``), from shapes and dtypes alone."""
    leaves, treedef = tree_flatten(params)
    buckets, pads = [], []
    for bucket in _bucketize(leaves, threshold_bytes):
        size = sum(leaf.numel() for _, leaf in bucket)
        pads.append((-size) % max(1, pad_multiple))
        buckets.append(tuple(_Slot(i, tuple(leaf.shape), leaf.numel())
                             for i, leaf in bucket))
    return PackSpec(treedef, tuple(buckets), len(leaves), tuple(pads))


def _pack_as(tree, spec: PackSpec, dtype=None):
    """``tree`` (shaped like the params ``spec`` was made from) packed into
    ``spec``'s padded buffers, in ``dtype`` when given: the buckets follow
    the params' dtypes, so a fp32 residual tree packs as the runtime
    residuals of bf16 params do."""
    leaves, treedef = tree_flatten(tree)
    if treedef != spec.treedef:
        raise HorovodTpuError(
            "canonical opt-state leaves do not match the target params "
            "(did the model change since the checkpoint was written?)"
        )
    out = []
    for slots, pad in zip(spec.buckets, spec.pad):
        parts = []
        for slot in slots:
            leaf = leaves[slot.index]
            if tuple(leaf.shape) != slot.shape:
                raise HorovodTpuError(
                    f"canonical leaf of shape {tuple(leaf.shape)} where the "
                    f"target params hold {slot.shape}"
                )
            parts.append(leaf.reshape(-1) if dtype is None
                         else leaf.reshape(-1).to(dtype))
        if pad:
            parts.append(parts[0].new_zeros((pad,)))
        out.append(torch.cat(parts))
    return out


def _gather_full(shards) -> list:
    """Every rank's shard of each bucket gathered into the full buffer."""
    world = _world_size()
    full = []
    for shard in shards:
        buf = torch.empty((world * shard.shape[0],), dtype=shard.dtype,
                          device=shard.device)
        full.append(allgather_chunks(buf, shard.contiguous()))
    return full


def _mean_residuals(residual: EFResiduals, world: int) -> list:
    """The mean-equivalent residual buffers: every rank's residual feeds
    the Average reduction as ``r_k / world``, so their sum over the world
    divided by ``world`` is the quantity whose effect must survive."""
    return [allreduce_(b.float().clone()) / world for b in residual.buffers]


def _canonicalize_residuals(residual, spec: PackSpec,
                            world: int) -> Optional[CanonicalResiduals]:
    if residual is None:
        return None
    return CanonicalResiduals(
        unpack(_mean_residuals(residual, world), spec),
        threshold=residual.threshold, block=residual.block,
    )


def _reshard_residuals(canonical: Optional[CanonicalResiduals], params,
                       threshold_bytes: int,
                       world: int) -> Optional[EFResiduals]:
    """The inverse for a world of ``world`` ranks: the mean-equivalent tree
    packed into the quantized bucket layout (padded to ``world * block``),
    the same buffer on every rank."""
    if canonical is None:
        return None
    block = max(1, canonical.block)
    spec = _layout(params, threshold_bytes, world * block)
    return EFResiduals(_pack_as(canonical.tree, spec, torch.float32),
                       threshold=threshold_bytes, block=block)


def _check_world(world: int, what: str) -> None:
    live = _world_size()
    if world != live:
        raise HorovodTpuError(
            f"{what} was built for a world of {world} ranks and gathers "
            f"across it, but this world has {live}; canonicalize while the "
            "world that built it is up"
        )


def unshard_opt_state(state: ShardedOptState, params, *,
                      threshold_bytes: Optional[int] = None
                      ) -> CanonicalOptState:
    """A ZeRO-1 state to its world-size-portable :class:`CanonicalOptState`
    (a collective: every rank of the state's world calls it): each flat
    bucket's shards are all-gathered and unpacked into parameter-shaped
    leaves keyed by parameter name, the padding stripped; the EF residuals
    become their mean-equivalent form. The layout comes from the state's
    recorded ``threshold``, ``world`` and ``block`` (``threshold_bytes``
    overrides); ``params`` must be the tree the state was built over."""
    if threshold_bytes is None:
        threshold_bytes = int(state.threshold)
    world = int(state.world)
    _check_world(world, "the sharded optimizer state")
    block = max(1, int(state.block or 1))
    if state.residual is not None:
        block = max(block, state.residual.block or 1)
    spec = _layout(params, threshold_bytes, world * block)
    expected = list(spec.padded_sizes())
    if state.residual is not None:
        got = [int(b.shape[0]) for b in state.residual.buffers]
        if got != expected:
            raise HorovodTpuError(
                f"EF residual buffers ({got} a rank) do not match the padded "
                f"bucket layout {expected} for world={world}, block={block}"
            )

    def fix(n):
        got = [int(b.shape[0]) * world for b in n.buffers]
        if got != expected:
            raise HorovodTpuError(
                "sharded opt-state buffers do not match the bucket layout of "
                f"these params ({got} vs expected {expected} for "
                f"threshold={threshold_bytes}, world={world}); pass the "
                "params and threshold_bytes the optimizer was built with"
            )
        return CanonicalBuckets(unpack(_gather_full(n.buffers), spec))

    return CanonicalOptState(
        inner=_map_nodes(fix, state.inner, _is_flat),
        count=state.count,
        threshold=threshold_bytes,
        block=block,
        residual=_canonicalize_residuals(state.residual, spec, world),
    )


def reshard_opt_state(state: CanonicalOptState, params, *,
                      world: Optional[int] = None,
                      threshold_bytes: Optional[int] = None
                      ) -> ShardedOptState:
    """A :class:`CanonicalOptState` to the ZeRO-1 layout of a world of
    ``world`` ranks (default: this world), packed at ``threshold_bytes``
    (default: the state's) and padded to ``world * block``; this rank keeps
    its contiguous 1/N shard of every bucket. The inverse of
    :func:`unshard_opt_state` with the padding recomputed: how a checkpoint
    saved at N ranks restores onto M. ``params`` (the target's tree) is
    checked against the canonical leaves."""
    if world is None:
        world = _world_size()
    if threshold_bytes is None:
        threshold_bytes = int(state.threshold)
    block = max(1, int(state.block or 1))
    if state.residual is not None:
        block = max(block, state.residual.block or 1)
    spec = _layout(params, threshold_bytes, world * block)

    def fix(n):
        full = _pack_as(n.tree, spec)
        shards = shard_slice(full).buffers
        # A shard owns its memory: a view would keep the full bucket alive.
        return FlatBuckets([s.clone() for s in shards] if world > 1
                           else shards)

    return ShardedOptState(
        inner=_map_nodes(fix, state.inner, _is_canonical),
        count=state.count,
        threshold=threshold_bytes,
        world=world,
        block=block,
        residual=_reshard_residuals(state.residual, params, threshold_bytes,
                                    world),
    )


def canonicalize_dist_state(state: DistributedOptState, params, *,
                            world: Optional[int] = None):
    """A quantized replicated state to its portable form (a collective: the
    residuals' mean is an all-reduce): ``inner`` passes through, the EF
    residuals become their mean-equivalent tree. A state without residuals
    is returned as it is."""
    if state.residual is None:
        return state
    if world is None:
        world = _world_size()
    _check_world(world, "the replicated optimizer state")
    block = max(1, state.residual.block or 1)
    spec = _layout(params, state.residual.threshold or
                   _env.fusion_threshold_bytes(), world * block)
    return CanonicalDistOptState(
        inner=state.inner, acc=state.acc, count=state.count,
        residual=_canonicalize_residuals(state.residual, spec, world),
    )


def reshard_dist_state(state: CanonicalDistOptState, params, *,
                       world: Optional[int] = None) -> DistributedOptState:
    """The inverse of :func:`canonicalize_dist_state` for this (or the
    given) world; threshold and block come from the canonical residuals,
    which after a checkpoint restore are the target optimizer's."""
    if world is None:
        world = _world_size()
    threshold = (state.residual.threshold
                 or _env.fusion_threshold_bytes())
    return DistributedOptState(
        inner=state.inner, acc=state.acc, count=state.count,
        residual=_reshard_residuals(state.residual, params, threshold,
                                    world),
    )


def canonicalize_sharded_states(tree, params, **kwargs):
    """Every :class:`ShardedOptState` (and quantized
    :class:`DistributedOptState`) in ``tree`` replaced by its canonical
    form (see :func:`unshard_opt_state`, :func:`canonicalize_dist_state`)."""
    def fix(n):
        if isinstance(n, ShardedOptState):
            return unshard_opt_state(n, params, **kwargs)
        return canonicalize_dist_state(n, params)

    return _map_nodes(fix, tree, lambda n: isinstance(
        n, (ShardedOptState, DistributedOptState)))


def reshard_sharded_states(tree, params, **kwargs):
    """Every canonical state in ``tree`` replaced by its runtime form for
    this world (see :func:`reshard_opt_state`, :func:`reshard_dist_state`)."""
    def fix(n):
        if isinstance(n, CanonicalOptState):
            return reshard_opt_state(n, params, **kwargs)
        return reshard_dist_state(n, params)

    return _map_nodes(fix, tree, lambda n: isinstance(
        n, (CanonicalOptState, CanonicalDistOptState)))


# -- torch.func with reduced gradients --------------------------------------


def grad(fun, argnums=0, *, op: ReduceOp = Average, axis=None,
         **allreduce_kwargs):
    """``torch.func.grad`` with the gradients reduced across ``axis`` as
    :func:`DistributedOptimizer` reduces them (``compression``,
    ``prescale_factor``, ``postscale_factor`` and ``threshold_bytes`` as
    keywords): the face of the reference's ``DistributedGradientTape``."""

    def wrapped(*args, **kwargs):
        g = torch.func.grad(fun, argnums=argnums)(*args, **kwargs)
        return _reduce_kw(g, op, axis, allreduce_kwargs)

    return wrapped


def value_and_grad(fun, argnums=0, *, has_aux: bool = False,
                   op: ReduceOp = Average, axis=None,
                   average_loss: bool = True, **allreduce_kwargs):
    """``(value, grads)`` of ``fun`` (``((value, aux), grads)`` with
    ``has_aux``) through ``torch.func.grad_and_value``, the gradients
    reduced as :func:`grad` reduces them and, with ``average_loss``, the
    value averaged across ``axis`` so every rank reports the global loss."""

    def wrapped(*args, **kwargs):
        g, out = torch.func.grad_and_value(
            fun, argnums=argnums, has_aux=has_aux)(*args, **kwargs)
        g = _reduce_kw(g, op, axis, allreduce_kwargs)
        if average_loss:
            if has_aux:
                loss, aux = out
                out = (allreduce(loss, op=Average, axis=axis), aux)
            else:
                out = allreduce(out, op=Average, axis=axis)
        return out, g

    return wrapped


def _reduce_kw(g, op, axis, kw):
    return _reduce_grads(
        g, op, kw.get("compression", Compression.none),
        kw.get("prescale_factor", 1.0), kw.get("postscale_factor", 1.0),
        axis, kw.get("threshold_bytes"),
    )
