"""Data-parallel training step builder.

The port of the JAX package's ``parallel/dp.py``. Where the JAX package
compiles the step into one SPMD program (``jit`` over ``shard_map``), the
port runs it eagerly in each process of the ``torch.distributed`` world,
one process per card: forward and backward on this rank's batch shard,
the wrapped optimizer's collectives (:mod:`..optimizer`), and the update.
There is no ``jit`` and no buffer donation: the update is added to the
parameters in place under ``torch.no_grad()``, and the optimizer state
tensors are updated or replaced in place of the old ones.

Parameters are a dict of named leaf tensors -- ``dict(model.named_
parameters())`` when :func:`init_state` is given an ``nn.Module``, so the
module trains in place -- and ``loss_fn(params, batch)`` computes the loss
from them (for instance through ``torch.func.functional_call``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..context import resolve_device
from ..guard import GuardRuntime, check_gradients, fresh_state
from ..guard import resolve as _resolve_guard
from ..obs import flops as _flops
from ..ops.batching import tree_flatten, tree_map
from ..ops.collectives import Average, ReduceOp, allreduce, world_size
from ..ops.compression import Compression, is_quantized
from ..ops import actquant as _actquant
from ..ops.fp8 import fp8_state_optimizer, resolve_compute_dtype
from ..ops.layout import BucketScheduler
from ..optimizer import (
    DistributedOptimizer,
    Optimizer,
    ShardedDistributedOptimizer,
    guarded_commit,
)
from ..utils import env as _env

__all__ = [
    "TrainState",
    "accumulate_gradients",
    "init_state",
    "make_train_step",
]


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: Any
    step: torch.Tensor  # int32, on the parameters' device
    extra: Any = None
    # The gradient guard's bookkeeping (guard.GuardState) when the step was
    # built with guard=...; None otherwise.
    guard: Any = None


def _params_dict(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_state(params, wrapped_optimizer: Optimizer, extra=None,
               guard=None) -> TrainState:
    """A :class:`TrainState` from a parameter dict (or an ``nn.Module``,
    whose own parameters are then trained in place) and the optimizer
    :func:`make_train_step` returned. Every parameter becomes a leaf that
    requires grad. ``guard=True`` (or a :class:`~..guard.GuardConfig`)
    seeds the guard's bookkeeping now, so the state's structure is final
    before the first step (a checkpoint restore target); a guarded step
    otherwise seeds it at its first call."""
    params = _params_dict(params)
    if not params:
        raise ValueError("init_state needs at least one parameter")
    for name, p in params.items():
        if not p.is_floating_point():
            raise TypeError(f"parameter {name} is {p.dtype}, not floating")
        if not p.requires_grad:
            p.requires_grad_(True)
    device = next(iter(params.values())).device
    with torch.no_grad():
        opt_state = wrapped_optimizer.init(params)
    return TrainState(
        params, opt_state, torch.zeros((), dtype=torch.int32, device=device),
        extra, fresh_state(device) if guard else None,
    )


def accumulate_gradients(
    loss_fn: Callable,
    params: Dict[str, torch.Tensor],
    batch,
    accum_steps: int,
    *,
    has_aux: bool = False,
) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Microbatched value-and-grad. Every batch leaf is split along dim 0
    into ``accum_steps`` equal microbatches; loss and gradients are summed
    in fp32 and their means returned (the gradients in their own dtype).
    ``aux`` is the last microbatch's. Returns ``(loss, aux, grads)``, the
    loss detached."""
    return _accumulate(loss_fn, params, batch, accum_steps, has_aux)


def _accumulate(loss_fn, params, batch, accum_steps, has_aux,
                scheduler: Optional[BucketScheduler] = None):
    """:func:`accumulate_gradients`; with a ``scheduler`` the last
    microbatch's backward runs with its gradient hooks armed, each leaf's
    gradient is finished to the mean as it arrives -- ``((acc + g.float())
    / K).to(dtype)``, the arithmetic below -- and handed to the
    scheduler, and ``grads`` comes back None (the scheduler holds them).
    The first K-1 microbatches accumulate locally, with no collective."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    names = list(params)
    leaves = [params[n] for n in names]

    def one(mb, hooks=contextlib.nullcontext()):
        with torch.enable_grad():
            out = loss_fn(params, mb)
            loss, aux = out if has_aux else (out, None)
            with hooks:
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), aux, gs

    def zero_filled(gs):
        return {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, leaves, gs)
        }

    def last(mb, acc):
        if scheduler is None:
            loss, aux, gs = one(mb)
            return loss, aux, zero_filled(gs)
        # The scheduler's leaves are the parameter tensors in its plan's
        # order; autograd's are in ``names`` order.
        slot = {id(p): j for j, p in enumerate(leaves)}
        order = [slot[id(t)] for t in scheduler.leaves]
        if acc is not None:
            accs = [acc[names[j]] for j in order]
            scheduler.finish = lambda i, g: (
                (accs[i] + g.float()) / accum_steps).to(g.dtype)
        loss, aux, gs = one(mb, scheduler.armed())
        scheduler.flush([gs[j] for j in order])
        return loss, aux, None

    if accum_steps == 1:
        return last(batch, None)
    for leaf in tree_flatten(batch)[0]:
        if leaf.shape[0] % accum_steps:
            raise ValueError(
                f"batch dim {leaf.shape[0]} not divisible by "
                f"accum_steps={accum_steps}"
            )

    def micro(i):
        return tree_map(
            lambda x: x[i * (x.shape[0] // accum_steps):
                        (i + 1) * (x.shape[0] // accum_steps)],
            batch,
        )

    acc = {n: torch.zeros_like(p, dtype=torch.float32)
           for n, p in zip(names, leaves)}
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(accum_steps - 1):
        loss_i, _, gs = one(micro(i))
        g_i = zero_filled(gs)
        for n in names:
            acc[n] += g_i[n].float()
        loss_sum += loss_i.float()
    loss_k, aux, g_k = last(micro(accum_steps - 1), acc)
    loss = (loss_sum + loss_k.float()) / accum_steps
    if g_k is None:
        return loss, aux, None
    grads = {
        n: ((acc[n] + g_k[n].float()) / accum_steps).to(g_k[n].dtype)
        for n in names
    }
    return loss, aux, grads


# Knobs of the JAX package's make_train_step whose planes are not ported
# yet: each raises NotImplementedError naming the slice that brings it.
_WAITING = {
    "lint": "the analysis plane (torch.fx / torch.export graph lints)",
    "autotune": "the tuning plane (tune/)",
    "publish": "the streaming plane (stream/)",
}


def _armed(name: str, value) -> bool:
    if value is None or value is False:
        return False
    if name == "lint":
        return str(value).lower() not in ("", "off", "none", "no", "false", "0")
    if name == "publish":
        return int(value) > 0
    return True


def make_train_step(
    loss_fn: Callable,
    optimizer: Optimizer,
    *,
    has_aux: bool = False,
    distribute_optimizer: bool = True,
    op: ReduceOp = Average,
    compression=None,
    axis=None,
    sharded: bool = False,
    gather_compression=Compression.none,
    threshold_bytes: Optional[int] = None,
    fused_update: Optional[bool] = None,
    accum_steps: Optional[int] = None,
    tokens_per_step: Optional[int] = None,
    flops_per_step: Optional[float] = None,
    error_feedback: bool = True,
    device=None,
    overlap=None,
    stagger=None,
    lint=None,
    guard=None,
    autotune=None,
    publish=None,
    remat=None,
    compute_dtype=None,
    act_quant=None,
) -> Tuple[Callable, Optimizer]:
    """Build a data-parallel train step.

    ``loss_fn(params, batch) -> loss`` (or ``(loss, aux)`` with
    ``has_aux=True``) runs on this rank's batch shard; the gradients go
    through ``optimizer`` wrapped in :func:`~..optimizer.
    DistributedOptimizer` (one fused allreduce per bucket) or, with
    ``sharded=True``, :func:`~..optimizer.ShardedDistributedOptimizer`
    (ZeRO-1: reduce-scatter, the update on this rank's 1/N shard,
    all-gather; ``gather_compression`` compresses the all-gather wire, and
    ``fused_update=True`` -- default from ``HVDTPU_FUSED_UPDATE`` -- runs
    that update as one fused AdamW kernel pass per bucket, which needs
    :func:`~..optimizer.fused_adamw`). ``compression`` (none, bf16, fp16)
    casts the gradient wire; ``Compression.int8``/``fp8`` quantize it
    blockwise, with error-feedback residuals in the optimizer state unless
    ``error_feedback=False`` (and, sharded, the update all-gather too).
    ``compression=None`` reads ``HVDTPU_QUANT`` (off|int8|fp8); an
    explicit ``Compression.none`` wins over it. ``op=Adasum`` reduces the
    gradients per leaf through :mod:`..ops.adasum` (replicated path only,
    as in the JAX package); ``axis`` names the mesh axes the gradients and
    the loss are reduced over (default the world's). A user's own
    ``DistributedOptimizer`` -- with ``backward_passes_per_step=k``, say --
    goes in with ``distribute_optimizer=False``; its skipped passes' zero
    updates leave the parameters as they were. ``accum_steps=K`` (default from
    ``HVDTPU_OVERLAP_ACCUM_STEPS``) microbatches the step through
    :func:`accumulate_gradients`; the reduction still runs once a step.

    Returns ``(step_fn, wrapped_optimizer)``; build the state with
    :func:`init_state` from the wrapped optimizer. ``step_fn(state,
    batch) -> (state, loss[, aux])``: the parameters are updated in place
    (no ``jit``, no donation), ``state.step`` advances on the device, and
    the loss is the world average, a device scalar (reading it syncs).

    The step runs on ``device`` (default: this process's card, raising
    without CUDA; ``"cpu"`` for the CPU) and checks that the parameters
    live there. ``tokens_per_step`` (global tokens per step) and
    ``flops_per_step`` (training FLOPs per step per card) feed
    ``step_fn.throughput(seconds_per_step)``, which gives tokens/s and MFU
    against the card's peak (:mod:`..obs.flops`).

    ``compute_dtype="fp8"`` (default from ``HVDTPU_COMPUTE_DTYPE``) trains
    a model built with ``compute_dtype="fp8"``: the optimizer is wrapped in
    :func:`~..ops.fp8.fp8_state_optimizer` before the distributed wrapper,
    so the ``fp8_*`` state parameters are averaged with the gradients and
    committed by overwrite, never stepped by the optimizer. Replicated path
    with ``op=Average`` only, as in the JAX package.

    ``remat`` (default from ``HVDTPU_REMAT``) checkpoints the whole loss
    function (:func:`~..ops.remat.checkpoint_fn`): ``"full"``, a named
    policy such as ``"dots_saveable"``, or a policy callable; a typo
    raises ``ValueError`` here. The region is the whole loss, so the
    backward recomputes the whole forward at its first saved tensor and
    holds it: the memory saving comes from per-block remat
    (``TransformerConfig.remat``), as the reference's memory planner
    finds for its whole-loss ``jax.checkpoint``.

    ``overlap=True`` (default from ``HVDTPU_OVERLAP``) issues each
    gradient bucket's reduction from the last microbatch's gradient hooks
    as soon as its leaves are whole, on a side CUDA stream, in one order
    on every rank (pack order in the first step, then the order rank 0's
    buckets became whole in it; :mod:`~..ops.layout`); the update waits
    for every bucket. The result
    is the step's without overlap bit for bit. ``stagger`` (default: on
    with overlap, ``HVDTPU_OVERLAP_STAGGER``) chains every bucket's work on
    one side stream; ``stagger=False`` gives each bucket a stream of its
    own. An explicit ``stagger=True`` without overlap is the step without
    overlap, whose buckets already go out after the backward in pack
    order, one after the other. Adasum, a user's optimizer with
    ``backward_passes_per_step > 1``, the fp16 wire (whose prescale needs
    every leaf) and an optimizer without a distributed wrapper reduce
    after the backward, as without overlap.

    ``act_quant="int8"`` (default from ``HVDTPU_ACT_QUANT``) stores the
    activations at the model's boundaries as int8 payload and fp32 scales
    for the backward (:mod:`~..ops.actquant`); ``remat`` then applies to
    each segment between boundaries instead of the whole loss.

    ``guard=True`` (or a :class:`~..guard.GuardConfig`; default reads
    ``HVDTPU_GUARD``) arms the gradient guard (:mod:`..guard`): every
    step's gradients are screened for NaN/Inf and for a norm spike, the
    verdict made replica-uniform by one all-reduce, and a poisoned step is
    skipped -- parameters, optimizer state (the fused kernel through its
    skip flag) and EF residuals stay as they were and ``state.step`` does
    not advance -- with nothing read on the host. The bookkeeping rides
    ``TrainState.guard`` (seeded at the first call); the returned step
    carries ``step_fn.guard_runtime`` (:class:`~..guard.GuardRuntime`),
    which raises a recoverable ``HorovodInternalError`` after
    ``max_skips`` consecutive skips, runs the fail-silent chaos sites and,
    in a world of more than one process, the consistency audit. The guard
    combines with ``overlap`` (the screen reads the hooks' gradients),
    ``accum_steps`` (it screens the microbatch mean) and
    ``compute_dtype="fp8"`` (the fp8 state rides the screened gradients),
    as in the JAX package.

    ``lint``, ``autotune`` and ``publish`` are not ported yet: arming one,
    or leaving it None under an armed ``HVDTPU_LINT``, ``_AUTOTUNE`` or
    ``_PUBLISH_EVERY``, raises ``NotImplementedError`` naming the slice
    that brings it.
    """
    # None reads the knob's HVDTPU_* default, as the JAX package does; an
    # explicit off value wins over the environment.
    knobs = dict(
        lint=_env.lint_mode() if lint is None else lint,
        autotune=_env.autotune_default() if autotune is None else autotune,
        publish=_env.publish_every() if publish is None else publish,
    )
    for name, value in knobs.items():
        if _armed(name, value):
            raise NotImplementedError(
                f"make_train_step({name}={value!r}) is not ported yet; it "
                f"arrives with {_WAITING[name]}"
            )
    guard_cfg = _resolve_guard(guard)
    overlap = bool(_env.overlap_default() if overlap is None else overlap)
    # stagger picks the overlap pipeline's side streams. Without overlap the
    # buckets go out after the backward in pack order, one after the other,
    # which is what the JAX package's stagger without overlap asks for.
    stagger = bool(_env.overlap_stagger() if stagger is None else stagger)
    # act_quant: the int8 boundaries arm for the loss, and the remat policy
    # goes to their segments; off, remat checkpoints the whole loss.
    loss_fn = _actquant.checkpoint_fn(
        loss_fn, _env.remat_mode() if remat is None else remat,
        _actquant.resolve_mode(act_quant))
    if compression is None:
        # Unset: HVDTPU_QUANT=int8|fp8 arms the quantized wire. An explicit
        # compression -- Compression.none included -- wins over the env.
        q = _env.quant_mode()
        compression = Compression.by_name(q) if q else Compression.none
    if is_quantized(compression):
        # Pinned now, so the optimizer's residual layout and every later
        # step read one block size.
        compression = compression.with_block(compression.block_size())
    if axis is not None:
        world_size(axis)  # an unknown axis raises here, not in the step
    if accum_steps is None:
        accum_steps = _env.overlap_accum_steps()
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    dev = resolve_device(device)
    if resolve_compute_dtype(compute_dtype) == "fp8":
        if sharded:
            raise NotImplementedError(
                "compute_dtype='fp8' is replicated-path only: the ZeRO-1 "
                "flat-shard update cannot see which bucket slices are fp8 "
                "scale state, so the overwrite-with-gradient commit has no "
                "leaf boundary to mask on"
            )
        if op != Average:
            raise ValueError(
                "compute_dtype='fp8' requires op=Average: the delayed-"
                "scaling state rides the gradient reduction, and only the "
                "mean keeps amax histories replica-uniform"
            )
        # Before the distributed wrapper: fp8_* leaves commit the values
        # their gradients carry; every other leaf sees the optimizer.
        optimizer = fp8_state_optimizer(optimizer)

    if not distribute_optimizer:
        opt = optimizer
    elif sharded:
        opt = ShardedDistributedOptimizer(
            optimizer, op=op, compression=compression,
            gather_compression=gather_compression, axis=axis,
            threshold_bytes=threshold_bytes, fused_update=fused_update,
            error_feedback=error_feedback,
        )
    else:
        if fused_update:
            raise ValueError(
                "fused_update requires the ZeRO-1 flat-shard layout; pass "
                "sharded=True"
            )
        opt = DistributedOptimizer(
            optimizer, op=op, compression=compression, axis=axis,
            threshold_bytes=threshold_bytes, error_feedback=error_feedback,
        )

    # Each bucket layout's issue order under overlap, as its ranks agreed
    # on it after its first step (ops/layout.py); pack order until then.
    issue_order: Dict[Any, list] = {}

    def update(grads, state: TrainState, ok):
        """The optimizer's update; under the guard, committed or skipped on
        ``ok`` (a distributed wrapper selects its own state, and passes
        ``ok`` to the fused kernel)."""
        if ok is not None and opt.reduction is not None:
            return opt.update(grads, state.opt_state, state.params, ok=ok)
        return guarded_commit(
            ok, *opt.update(grads, state.opt_state, state.params),
            state.opt_state)

    def step_fn(state: TrainState, batch):
        for name, p in state.params.items():
            if p.device != dev:
                raise ValueError(
                    f"parameter {name} is on {p.device}; this step runs on "
                    f"{dev}"
                )
        ok = new_guard = None
        if guard_cfg is not None and state.guard is None:
            state = dataclasses.replace(state, guard=fresh_state(dev))
        red = None
        if overlap and getattr(opt, "reduction", None):
            red = opt.reduction(state.opt_state, state.params)
            if red is not None and red.plan.needs_all_leaves:
                red = None
        if red is None:
            loss, aux, grads = accumulate_gradients(
                loss_fn, state.params, batch, accum_steps, has_aux=has_aux
            )
            with torch.no_grad():
                if guard_cfg is not None:
                    # The screen before anything commits; the update and its
                    # collectives run whatever it says.
                    ok, _, new_guard = check_gradients(
                        grads, state.guard, guard_cfg, axis=axis)
                updates, new_opt = update(grads, state, ok)
        else:
            # The reduce phase goes out bucket by bucket from the last
            # microbatch's gradient hooks; the update phase waits for every
            # bucket.
            layout = red.plan.spec.buckets
            sched = BucketScheduler(red.plan, stagger=stagger,
                                    order=issue_order.get(layout))
            loss, aux, _ = _accumulate(loss_fn, state.params, batch,
                                       accum_steps, has_aux, sched)
            if layout not in issue_order:
                issue_order[layout] = sched.agree_order()
            with torch.no_grad():
                if guard_cfg is not None:
                    ok, _, new_guard = check_gradients(
                        sched.grads, state.guard, guard_cfg, axis=axis)
                updates, new_opt = red.finish(*sched.wait(), state.params,
                                              ok)
        with torch.no_grad():
            for name, p in state.params.items():
                p.add_(updates[name])
            loss = allreduce(loss, op=Average, axis=axis)
        # A guarded step advances by its verdict; an unguarded one keeps a
        # state's foreign guard bookkeeping as it is.
        new_state = TrainState(
            state.params, new_opt,
            state.step + (1 if ok is None else ok.to(state.step.dtype)),
            state.extra, state.guard if ok is None else new_guard)
        if has_aux:
            return new_state, loss, aux
        return new_state, loss

    def throughput(seconds_per_step: float) -> Dict[str, Optional[float]]:
        """tokens/s and MFU for a measured step time (None where
        ``tokens_per_step``/``flops_per_step`` were not given or the
        card's peak is unknown)."""
        tps = tokens_per_step / seconds_per_step if tokens_per_step else None
        m = None
        if flops_per_step and dev.type == "cuda":
            m = _flops.mfu(1.0 / seconds_per_step, flops_per_step,
                           torch.cuda.get_device_name(dev))
        return {"tokens_per_s": tps, "mfu": m}

    fn = step_fn
    guard_runtime = None
    if guard_cfg is not None:
        guard_runtime = GuardRuntime(guard_cfg, sharded=sharded)
        fn = guard_runtime.wrap(step_fn)
    fn.throughput = throughput
    fn.guard_config = guard_cfg
    fn.guard_runtime = guard_runtime
    return fn, opt
