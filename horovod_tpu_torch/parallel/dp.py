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

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..context import resolve_device
from ..obs import flops as _flops
from ..ops.batching import tree_flatten, tree_map
from ..ops.collectives import Average, ReduceOp, allreduce, world_size
from ..ops.compression import Compression, is_quantized
from ..ops.fp8 import fp8_state_optimizer, resolve_compute_dtype
from ..ops.remat import checkpoint_fn
from ..optimizer import DistributedOptimizer, Optimizer, ShardedDistributedOptimizer
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


def _params_dict(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_state(params, wrapped_optimizer: Optimizer, extra=None) -> TrainState:
    """A :class:`TrainState` from a parameter dict (or an ``nn.Module``,
    whose own parameters are then trained in place) and the optimizer
    :func:`make_train_step` returned. Every parameter becomes a leaf that
    requires grad."""
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
        extra,
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
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    names = list(params)
    leaves = [params[n] for n in names]

    def one(mb):
        with torch.enable_grad():
            out = loss_fn(params, mb)
            loss, aux = out if has_aux else (out, None)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, leaves, gs)
        }
        return loss.detach(), aux, grads

    if accum_steps == 1:
        return one(batch)
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
        loss_i, _, g_i = one(micro(i))
        for n in names:
            acc[n] += g_i[n].float()
        loss_sum += loss_i.float()
    loss_k, aux, g_k = one(micro(accum_steps - 1))
    grads = {
        n: ((acc[n] + g_k[n].float()) / accum_steps).to(g_k[n].dtype)
        for n in names
    }
    return (loss_sum + loss_k.float()) / accum_steps, aux, grads


# Knobs of the JAX package's make_train_step whose planes are not ported
# yet: each raises NotImplementedError naming the slice that brings it.
_WAITING = {
    "overlap": "the overlap slice (per-bucket collectives on a side stream)",
    "stagger": "the overlap slice (per-bucket collectives on a side stream)",
    "lint": "the analysis plane (torch.fx / torch.export graph lints)",
    "guard": "the fault planes (ops/guards.py, guard/)",
    "autotune": "the tuning plane (tune/)",
    "publish": "the streaming plane (stream/)",
    "act_quant": "its own slice (ops/actquant.py)",
}


def _armed(name: str, value) -> bool:
    if value is None or value is False:
        return False
    if name in ("lint", "act_quant"):
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

    ``overlap``, ``stagger``, ``lint``, ``guard``, ``autotune``,
    ``publish`` and ``act_quant`` are not ported yet: arming one, or
    leaving it None under an armed ``HVDTPU_OVERLAP``, ``_LINT``,
    ``_GUARD``, ``_AUTOTUNE``, ``_PUBLISH_EVERY`` or ``_ACT_QUANT``, raises
    ``NotImplementedError`` naming the slice that brings it.
    """
    # None reads the knob's HVDTPU_* default, as the JAX package does; an
    # explicit off value wins over the environment.
    knobs = dict(
        overlap=_env.overlap_default() if overlap is None else overlap,
        stagger=stagger,
        lint=_env.lint_mode() if lint is None else lint,
        guard=_env.guard_default() if guard is None else guard,
        autotune=_env.autotune_default() if autotune is None else autotune,
        publish=_env.publish_every() if publish is None else publish,
        act_quant=_env.act_quant_mode() if act_quant is None else act_quant,
    )
    for name, value in knobs.items():
        if _armed(name, value):
            raise NotImplementedError(
                f"make_train_step({name}={value!r}) is not ported yet; it "
                f"arrives with {_WAITING[name]}"
            )
    loss_fn = checkpoint_fn(
        loss_fn, _env.remat_mode() if remat is None else remat)
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

    def step_fn(state: TrainState, batch):
        for name, p in state.params.items():
            if p.device != dev:
                raise ValueError(
                    f"parameter {name} is on {p.device}; this step runs on "
                    f"{dev}"
                )
        loss, aux, grads = accumulate_gradients(
            loss_fn, state.params, batch, accum_steps, has_aux=has_aux
        )
        with torch.no_grad():
            updates, new_opt = opt.update(grads, state.opt_state, state.params)
            for name, p in state.params.items():
                p.add_(updates[name])
            loss = allreduce(loss, op=Average, axis=axis)
        new_state = TrainState(state.params, new_opt, state.step + 1,
                               state.extra)
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

    step_fn.throughput = throughput
    return step_fn, opt
