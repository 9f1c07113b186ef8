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
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..context import resolve_device
from ..guard import GuardRuntime, check_gradients, fresh_state
from ..guard import resolve as _resolve_guard
from ..obs import export as _export
from ..obs import flops as _flops
from ..obs import goodput as _goodput
from ..obs import registry as _obs
from ..obs import trace as _trace
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
    ef_residual_norm,
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


# The knob of the JAX package's make_train_step whose plane is not ported
# yet: armed, it raises NotImplementedError naming the slice that brings it.
_WAITING = {
    "lint": "the analysis plane (torch.fx / torch.export graph lints)",
}


def _armed(name: str, value) -> bool:
    if value is None or value is False:
        return False
    return str(value).lower() not in ("", "off", "none", "no", "false", "0")


def _instrument_step(fn: Callable, dev: torch.device, tokens_per_step,
                     flops_per_step, overlap: bool = False,
                     accum_steps: int = 1, quantized: bool = False,
                     fp8: bool = False) -> Callable:
    """Telemetry wrapper of a built train step (the JAX package's
    ``_instrument_step``).

    The enablement check is per call, so ``obs.enable()``/``disable()``
    work on an already-built step: with the metrics, trace and goodput
    planes all off, a call costs three cached booleans and returns
    ``fn(state, batch)`` untouched. With a plane on, each call is
    bracketed: ``step.host_dispatch_ms`` is the Python enqueue of forward,
    backward and update (``fn`` returning), ``step.device_ms`` the wait
    for the card after it (``torch.cuda.synchronize``; 0 on the CPU, where
    the eager step has run when ``fn`` returns), ``step.total_ms`` both.
    A step that reads the device itself -- the guard's counter read
    (``guard/runtime.py``), a loss printed -- waits inside ``fn``, and
    that wait is counted in ``host_dispatch``. The bracket serializes host
    and card per step, which is why it runs only with a plane on.

    Besides the histograms: ``step.count``/``step.tokens`` counters, the
    ``step.per_sec``/``step.tokens_per_sec``/``step.mfu`` gauges (MFU from
    :mod:`..obs.flops` against the card's peak, as ``throughput()``
    computes it), ``quant.residual_norm`` and the ``fp8.*`` gauges on the
    first step and every 10th, three trace spans (``step``,
    ``step.host_dispatch``, ``step.device``) and the goodput ledger's step
    bracket. The reporter is ticked with this wrapper's own step count:
    the cross-process summary fires on the same call on every rank, and a
    rebuilt step (a rescale) restarts the count on every rank together.
    """
    peak = None  # resolved at the first instrumented step
    local_step = 0
    on_card = dev.type == "cuda"

    def wrapped(state, batch):
        nonlocal peak, local_step
        trace_on = _trace.enabled()
        goodput_on = _goodput.enabled()
        if not _obs.enabled() and not trace_on and not goodput_on:
            return fn(state, batch)
        reg = _obs.metrics()
        w0 = time.time()
        t0 = time.perf_counter()
        out = fn(state, batch)
        t_dispatch = time.perf_counter()
        if on_card:
            torch.cuda.synchronize(dev)
        t_done = time.perf_counter()
        total = t_done - t0
        if trace_on:
            rec = _trace.recorder()
            w0_us = int(w0 * 1e6)
            disp_us = int((t_dispatch - t0) * 1e6)
            rec.complete("step", "train", w0_us, int(total * 1e6),
                         args={"step": local_step})
            rec.complete("step.host_dispatch", "train", w0_us, disp_us)
            rec.complete("step.device", "train", w0_us + disp_us,
                         int((t_done - t_dispatch) * 1e6))
        if goodput_on:
            _goodput.record_step(w0, total, t_dispatch - t0,
                                 t_done - t_dispatch)
        reg.histogram("step.total_ms").observe(total * 1e3)
        reg.histogram("step.host_dispatch_ms").observe(
            (t_dispatch - t0) * 1e3)
        reg.histogram("step.device_ms").observe((t_done - t_dispatch) * 1e3)
        reg.counter("step.count").inc()
        reg.gauge("overlap.enabled").set(1.0 if overlap else 0.0)
        reg.gauge("overlap.accum_steps").set(accum_steps)
        local_step += 1
        if total > 0:
            reg.gauge("step.per_sec").set(1.0 / total)
        if tokens_per_step:
            reg.counter("step.tokens").inc(int(tokens_per_step))
            reg.gauge("step.tokens_per_sec").set(
                tokens_per_step / total if total > 0 else 0.0)
        if quantized and _obs.enabled() and local_step % 10 == 1:
            # First step, then every 10th: a reduction over every EF
            # residual, metrics plane only.
            norm = ef_residual_norm(out[0].opt_state)
            if norm is not None:
                reg.gauge("quant.residual_norm").set(norm)
        if fp8 and _obs.enabled() and local_step % 10 == 1:
            from ..ops.fp8 import fp8_state_gauges

            g = fp8_state_gauges(out[0].params)
            if g:
                reg.gauge("fp8.amax_max").set(g["fp8.amax_max"])
                reg.gauge("fp8.scale_min").set(g["fp8.scale_min"])
                reg.gauge("fp8.cast_residual_norm").set(
                    g["fp8.cast_residual_norm"])
        if flops_per_step and total > 0:
            if peak is None:
                peak = _flops.peak_tflops(
                    torch.cuda.get_device_name(dev) if on_card else "")
            m = _flops.mfu(1.0 / total, flops_per_step, peak=peak)
            if m is not None:
                reg.gauge("step.mfu").set(m)
        _export.reporter().tick(step=local_step)
        return out

    return wrapped


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

    ``autotune=True`` (or a :class:`~..tune.AutotuneConfig`; default
    reads ``HVDTPU_AUTOTUNE``) wraps the step in the closed-loop autotuner
    (:mod:`..tune`): under an elastic launcher the step follows the
    driver's rollout coordinator through the KV (lockstep switches), else
    it runs its own search. Cheap knobs flip in place, retrace knobs
    rebuild the step from the env the switch wrote. The wrapper exposes
    the client as ``step.autotune`` (``.done``, ``.best``,
    ``.switch_log``). Knobs the call pins (``threshold_bytes=``,
    ``compute_dtype=``, ``act_quant=``; ``stagger=`` or no overlap) leave
    the space, and a build whose optimizer state depends on the bucket
    layout (``sharded``, ``fused_update``, quantized error feedback) pins
    the fusion threshold too.

    ``publish=N`` (default ``HVDTPU_PUBLISH_EVERY``) publishes the
    committed parameters every N steps into the weight stream
    (:class:`~..stream.WeightPublisher`, over the elastic KV), gated by
    the guard's audit when ``guard`` is armed; the step carries it as
    ``step_fn.stream_publisher``.

    ``lint`` is not ported yet: arming it, or leaving it None under an
    armed ``HVDTPU_LINT``, raises ``NotImplementedError`` naming the slice
    that brings it.
    """
    lint = _env.lint_mode() if lint is None else lint
    if _armed("lint", lint):
        raise NotImplementedError(
            f"make_train_step(lint={lint!r}) is not ported yet; it arrives "
            f"with {_WAITING['lint']}")
    autotune_cfg = None
    if autotune is not False:
        from .. import tune as _tune

        autotune_cfg = _tune.resolve(autotune)
    if autotune_cfg is not None:
        build_kwargs = dict(
            has_aux=has_aux, distribute_optimizer=distribute_optimizer,
            op=op, compression=compression, axis=axis, sharded=sharded,
            gather_compression=gather_compression,
            threshold_bytes=threshold_bytes, fused_update=fused_update,
            accum_steps=accum_steps, tokens_per_step=tokens_per_step,
            flops_per_step=flops_per_step, error_feedback=error_feedback,
            device=device, overlap=overlap, stagger=stagger, lint=lint,
            guard=guard, autotune=False, publish=publish, remat=remat,
            compute_dtype=compute_dtype, act_quant=act_quant,
        )
        pinned = []
        if threshold_bytes is not None:
            pinned.append(_env.FUSION_THRESHOLD)
        if compute_dtype is not None:
            pinned.append(_env.COMPUTE_DTYPE)
        if act_quant is not None:
            pinned.append(_env.ACT_QUANT)
        overlap_on = overlap if overlap is not None else _env.overlap_default()
        if stagger is not None or not overlap_on:
            # Pinned, or inert without the overlap pipeline: tuning it
            # would score noise.
            pinned.append(_env.OVERLAP_STAGGER)
        quant_on = (is_quantized(compression) if compression is not None
                    else bool(_env.quant_mode()))
        fused_on = (_env.fused_update_default() if fused_update is None
                    else fused_update)
        structure_locked = bool(
            sharded or fused_on or (quant_on and error_feedback))
        from .. import context as _ctx

        c = _ctx._context
        step = _tune.attach_train_autotuner(
            lambda: make_train_step(loss_fn, optimizer, **build_kwargs),
            autotune_cfg,
            pinned=pinned,
            mesh_shape=dict(c.mesh.shape) if c is not None else {},
            cross_axes=((_ctx.CROSS_AXIS,) if c is not None
                        and _ctx.CROSS_AXIS in c.mesh.shape else ()),
            structure_locked=structure_locked,
            device=resolve_device(device),
        )
        if step is not None:
            return step, step.opt
        # Empty effective space (every live knob pinned by this build):
        # build the plain untuned step.
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
    publisher = None
    publish_every = (_env.publish_every() if publish is None
                     else max(0, int(publish)))
    if publish_every > 0:
        publisher, fn = _streamed(fn, publish_every, guard_runtime,
                                  threshold_bytes)
    # The telemetry bracket wraps the guard's and the publisher's wrappers:
    # a guarded step's counter read is inside its host_dispatch.
    fn = _instrument_step(
        fn, dev, tokens_per_step, flops_per_step, overlap=overlap,
        accum_steps=accum_steps, quantized=is_quantized(compression),
        fp8=resolve_compute_dtype(compute_dtype) == "fp8")
    fn.throughput = throughput
    fn.guard_config = guard_cfg
    fn.guard_runtime = guard_runtime
    fn.stream_publisher = publisher
    return fn, opt


def _streamed(fn: Callable, every: int, guard_runtime, threshold_bytes):
    """The weight-stream publisher around a built step: OUTSIDE the guard
    wrapper (it reads the audit's verdict and is not audited) and inside
    the metrics bracket. The cadence runs on a host step clock anchored
    once to the real ``state.step`` (one device read, first step only) and
    re-anchored on each cadence hit, where the real step is read anyway:
    an elastic restore or a guard skip that moved ``state.step`` cannot
    desynchronize it. Off-cadence steps read nothing on the device."""
    from ..stream import WeightPublisher

    publisher = WeightPublisher(publish_every=every,
                                guard_runtime=guard_runtime,
                                threshold_bytes=threshold_bytes)
    clock = {"base": None, "n": 0}

    def streamed(state, batch):
        out = fn(state, batch)
        new_state = out[0]
        if clock["base"] is None:
            clock["base"] = int(new_state.step) - 1
        clock["n"] += 1
        hint = clock["base"] + clock["n"]
        if hint % every == 0:
            real_step = int(new_state.step)
            if real_step != hint:
                clock["base"] = real_step - clock["n"]
            # The capture is a host copy taken now, before the next step
            # updates the parameters in place.
            publisher.maybe_publish(new_state.params, real_step)
        elif publisher._pending:
            # Queued behind the guard gate or a KV outage: retry the
            # flush each step until it drains.
            publisher.flush()
        return out

    return publisher, streamed
