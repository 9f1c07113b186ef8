"""Selective rematerialization -- one knob for the whole zoo; the port of
the JAX package's ``ops/remat.py`` on ``torch.utils.checkpoint``.

Rematerialization trades recompute for memory: the backward pass
recomputes the intermediates of a checkpointed region from its inputs
instead of keeping them from the forward. The named policies make the trade
selective through ``torch.utils.checkpoint.create_selective_checkpoint_
contexts``, as ``jax.checkpoint_policies`` do in the reference:

* ``"dots_saveable"`` keeps the outputs of every matmul (``aten.mm``,
  ``addmm``, ``bmm``, ``baddbmm``) and recomputes the elementwise chains;
* ``"dots_with_no_batch_dims_saveable"`` keeps ``mm`` and ``addmm`` only;
* ``"everything_saveable"`` keeps every op's output (nothing recomputed);
* ``"nothing_saveable"`` keeps nothing but the region's inputs;
* ``"full"`` (or ``True``) is the plain non-reentrant checkpoint: only the
  inputs are saved.

The CUDA kernels (flash attention, the fp8 and int8 matmuls) are ``hvt``
ops (:mod:`._library`), not aten ops: every named policy treats them as
not saveable (``everything_saveable`` too), so a checkpointed region
recomputes them in the backward, as a ``pallas_call`` is recomputed under
``dots_saveable`` in JAX.

Every surface shares :func:`resolve_policy`:

* ``parallel.dp.make_train_step(remat=...)`` wraps the loss function in
  :func:`checkpoint_fn`;
* ``TransformerConfig.remat`` (and its subclasses) wraps each block class
  in :func:`remat_module`;
* ``HVDTPU_REMAT`` sets the train-step default.

Accepted values: ``None``/``False``/``""``/``"none"`` (off),
``True``/``"full"``, a name of :data:`POLICY_NAMES`, or a custom policy
callable ``(ctx, op, *args, **kwargs) -> CheckpointPolicy`` (anything
``create_selective_checkpoint_contexts`` takes).

A checkpointed region runs twice. A forward with a side effect takes it
once: the recompute runs under :func:`is_recomputing`, which the BatchNorm
of ``models/resnet.py`` reads to leave its running statistics alone. A
remat block reads its parameters and buffers as inputs of the region, so
the recompute sees the tensors the forward saw, also under
``torch.func.functional_call`` with tensors other than the module's.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ._library import is_hvt_op

__all__ = ["POLICY_NAMES", "resolve_policy", "checkpoint_fn",
           "checkpoint_module", "remat_module", "is_recomputing"]

POLICY_NAMES: Tuple[str, ...] = (
    "dots_saveable",
    "dots_with_no_batch_dims_saveable",
    "everything_saveable",
    "nothing_saveable",
)

RematArg = Union[None, bool, str, Callable]

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default)
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)


def _saving(ops) -> Callable:
    def policy(ctx, op, *args, **kwargs):
        if op in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _save_all(ctx, op, *args, **kwargs):
    if is_hvt_op(op):
        return CheckpointPolicy.PREFER_RECOMPUTE
    return CheckpointPolicy.MUST_SAVE


def _save_none(ctx, op, *args, **kwargs):
    return CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {
    "dots_saveable": _saving(_DOTS),
    "dots_with_no_batch_dims_saveable": _saving(_DOTS_NO_BATCH),
    "everything_saveable": _save_all,
    "nothing_saveable": _save_none,
}


def resolve_policy(remat: RematArg) -> Tuple[bool, Optional[Callable]]:
    """Normalize a remat knob to ``(enabled, policy_or_None)``.

    ``policy`` is ``None`` for full remat (save only the inputs) and a
    selective-checkpoint policy function otherwise. Unknown strings raise
    ``ValueError`` and other types ``TypeError``: a typo must not silently
    change the memory/compute trade of every step."""
    if remat is None or remat is False:
        return False, None
    if remat is True:
        return True, None
    if callable(remat):
        return True, remat
    if isinstance(remat, str):
        name = remat.strip().lower()
        if name in ("", "none", "off", "0", "false", "no"):
            return False, None
        if name in ("full", "1", "true", "yes", "on"):
            return True, None
        if name in POLICY_NAMES:
            return True, _POLICIES[name]
        raise ValueError(
            f"unknown remat policy {remat!r}; use none|full|"
            + "|".join(POLICY_NAMES)
            + " or a selective-checkpoint policy callable"
        )
    raise TypeError(
        f"remat must be None/bool/str/callable, got {type(remat).__name__}"
    )


_RECOMPUTING = threading.local()


def is_recomputing() -> bool:
    """True while a checkpointed region runs again in the backward: what a
    forward with a side effect (BatchNorm's running statistics) reads to
    take that effect once a step, as the reference's functional
    ``batch_stats`` do."""
    return getattr(_RECOMPUTING, "depth", 0) > 0


@contextlib.contextmanager
def _recomputing():
    _RECOMPUTING.depth = getattr(_RECOMPUTING, "depth", 0) + 1
    try:
        yield
    finally:
        _RECOMPUTING.depth -= 1


def _checkpointed(fn: Callable, policy: Optional[Callable]) -> Callable:
    context_fn = (
        functools.partial(create_selective_checkpoint_contexts, policy)
        if policy is not None else None
    )

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():  # nothing to save: plain forward
            return fn(*args, **kwargs)
        calls = []

        def body(*a, **kw):  # the first call is the forward, later ones
            calls.append(1)  # the backward's recompute
            if len(calls) == 1:
                return fn(*a, **kw)
            with _recomputing():
                return fn(*a, **kw)

        if context_fn is None:
            return checkpoint(body, *args, use_reentrant=False, **kwargs)
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=context_fn, **kwargs)

    return run


@contextlib.contextmanager
def _bound(module: torch.nn.Module, state: Dict[str, torch.Tensor]):
    """``module`` reading ``state``'s tensors as its parameters and
    buffers, its own put back on exit."""
    saved = []
    try:
        for name, t in state.items():
            owner, _, leaf = name.rpartition(".")
            sub = module.get_submodule(owner)
            slots = sub._parameters if leaf in sub._parameters else sub._buffers
            saved.append((slots, leaf, slots[leaf]))
            slots[leaf] = t
        yield
    finally:
        for slots, leaf, t in reversed(saved):
            slots[leaf] = t


def checkpoint_fn(fn: Callable, remat: RematArg) -> Callable:
    """``fn`` checkpointed per the resolved policy (``fn`` itself when
    remat is off) -- what ``make_train_step(remat=...)`` applies to the
    loss function. The region is the whole of ``fn``: the backward
    recomputes its forward once, at the first saved tensor it needs."""
    enabled, policy = resolve_policy(remat)
    if not enabled:
        return fn
    return functools.wraps(fn)(_checkpointed(fn, policy))


def _run_bound(module, state, call, *args, **kwargs):
    with _bound(module, state):
        if call is None:
            return module.forward(*args, **kwargs)
        return call(*args, **kwargs)


def checkpoint_module(module: torch.nn.Module, policy: Optional[Callable],
                      *args, call: Optional[Callable] = None, **kwargs):
    """``module.forward(*args, **kwargs)`` -- or ``call(*args,
    **kwargs)``, code that runs ``module`` -- as one checkpointed region
    under ``policy`` (None: save only the inputs). The parameters and
    buffers ``module`` reads now enter the region as its inputs, so the
    recompute reads the tensors the forward read (see the module
    docstring); the activation-storage segments (:mod:`.actquant`) run
    through it."""
    state = dict(module.named_parameters(remove_duplicate=False))
    state.update(module.named_buffers(remove_duplicate=False))
    return _checkpointed(_run_bound, policy)(module, state, call, *args,
                                             **kwargs)


@functools.lru_cache(maxsize=None)
def _remat_class(module_cls, policy):
    class Remat(module_cls):
        def forward(self, *args, **kwargs):
            # The tensors the block reads now (the module's own, or those
            # a functional_call put in) enter the region as inputs: the
            # recompute runs after a functional_call has put the module's
            # own back, and must read the ones the forward read.
            return checkpoint_module(
                self, policy, *args,
                call=functools.partial(module_cls.forward, self), **kwargs)

    Remat.__name__ = Remat.__qualname__ = f"Remat{module_cls.__name__}"
    Remat.__module__ = module_cls.__module__
    return Remat


def remat_module(module_cls, remat: RematArg):
    """The module face of the same knob: a subclass of ``module_cls`` whose
    ``forward`` runs checkpointed per the resolved policy (``module_cls``
    itself when remat is off) -- what the zoo's per-block remat uses. The
    subclass adds no parameter or buffer, so state dicts are unchanged."""
    enabled, policy = resolve_policy(remat)
    if not enabled:
        return module_cls
    return _remat_class(module_cls, policy)
