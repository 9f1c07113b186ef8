"""Hook-based distributed optimizer for PyTorch.

The port of the JAX package's ``horovod_tpu/torch/optimizer.py``
(reference ``horovod/torch/optimizer.py``): ``_DistributedOptimizer`` with
grad-accumulator hooks (``:110-142``), delayed allreduce with
``backward_passes_per_step`` (``:170-198``), ``synchronize`` /
``skip_synchronize`` (``:200-227``), ``_DistributedAdasumOptimizer``
(``:270``) and the ``DistributedOptimizer`` factory (``:441``).

The hooks fire as autograd accumulates each parameter's gradient and
enqueue it, in place and by the parameter's name, into the runtime, whose
background thread negotiates, fuses and reduces it while the rest of the
backward runs (on the card: on the runtime's stream, after an event the
hook recorded on autograd's stream). One difference from the JAX package:
the hooks and the runtime run at every world size, one rank included,
where the JAX package skips them at one (Average there divides by 1, so
the step is the unwrapped optimizer's bit for bit).

Under an elastic launcher a reset between a backward and its step (a
failed collective, a fault raised in between) restarts the runtime
(:func:`~horovod_tpu_torch.elastic.worker.rejoin_world`): the handles of
the old runtime can never be synchronized, and the rolled-back step starts
over, so the optimizer forgets them at its next hook, step or
``zero_grad``.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional

import torch

from .. import native
from . import mpi_ops
from .compression import Compression


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1, op=mpi_ops.Average,
                 gradient_predivide_factor=1.0, num_groups=0):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.op = op
        self.backward_passes_per_step = backward_passes_per_step
        self.gradient_predivide_factor = gradient_predivide_factor
        self._num_groups = num_groups

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                (f"allreduce.noname.{i}.{j}", v)
                for i, g in enumerate(self.param_groups)
                for j, v in enumerate(g["params"])
            ]
        dups = _find_duplicates([k for k, _ in named_parameters])
        if dups:
            raise ValueError(
                f"Parameter names in named_parameters must be unique. "
                f"Found duplicates: {', '.join(sorted(dups))}"
            )
        all_params = {
            v for group in self.param_groups for v in group["params"]
        }
        unnamed = all_params - {v for _, v in named_parameters}
        if unnamed:
            raise ValueError(
                "named_parameters was specified, but one or more model "
                "parameters were not named."
            )
        self._parameter_names = {v: k for k, v in named_parameters}
        self._handles = {}
        self._handles_of = 0  # native.generation() that issued the handles
        self._grad_accs = []
        self._requires_update = set()
        self._synchronized = False
        self._should_synchronize = True
        self._allreduce_delay = {
            v: self.backward_passes_per_step
            for group in self.param_groups for v in group["params"]
        }
        self._register_hooks()

    def _register_hooks(self):
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    # Classic grad-accumulator hook: fires once autograd has
                    # fully accumulated p.grad (reference :110-142).
                    p_tmp = p.expand_as(p)
                    grad_acc = p_tmp.grad_fn.next_functions[0][0]
                    grad_acc.register_hook(self._make_hook(p))
                    self._grad_accs.append(grad_acc)

    def _forget_stale_handles(self):
        """Drop the handles of a runtime that has since been restarted,
        with the backward passes counted toward them."""
        if self._handles and self._handles_of != native.generation():
            self._handles.clear()
            for p in self._allreduce_delay:
                self._allreduce_delay[p] = self.backward_passes_per_step
            self._synchronized = False

    def _allreduce_grad_async(self, p):
        self._handles_of = native.generation()
        name = self._parameter_names.get(p)
        if p.grad is None:
            # Parameter did not participate in the loss this step (its hook
            # never fired); every rank must still contribute a tensor to the
            # collective, so allreduce zeros (reference behavior).
            p.grad = torch.zeros_like(p)
        tensor = p.grad
        if self.op == mpi_ops.Average:
            # predivide locally, postdivide the rest across ranks
            prescale = 1.0 / self.gradient_predivide_factor
            postscale = self.gradient_predivide_factor / mpi_ops.size()
            op, pre, post = mpi_ops.Sum, prescale, postscale
        else:
            op, pre, post = self.op, 1.0, 1.0
        tensor_compressed, ctx = self._compression.compress(tensor)
        handle = mpi_ops.allreduce_async_(
            tensor_compressed, name=name, op=op,
            prescale_factor=pre, postscale_factor=post,
        )
        return handle, (tensor_compressed, ctx)

    def _make_hook(self, p):
        def hook(*ignore):
            self._forget_stale_handles()
            if p in self._handles and self._handles[p][0] is not None:
                if self._allreduce_delay[p] <= 0:
                    raise AssertionError(
                        "Gradients were computed more than "
                        "backward_passes_per_step times before call to "
                        "step(). Increase backward_passes_per_step."
                    )
            handle, ctx = None, None
            self._allreduce_delay[p] -= 1
            if self._allreduce_delay[p] == 0:
                handle, ctx = self._allreduce_grad_async(p)
            self._handles[p] = (handle, ctx)
            self._handles_of = native.generation()

        return hook

    def synchronize(self):
        """Finish all outstanding allreduces and write back grads
        (reference ``:200-227``)."""
        self._forget_stale_handles()
        missing = [p for p in self._requires_update if p not in self._handles]
        for p in missing:
            self._allreduce_delay[p] = 0  # force now
            handle, ctx = self._allreduce_grad_async(p)
            self._handles[p] = (handle, ctx)
        for p, (handle, ctx) in self._handles.items():
            if handle is None:
                handle, ctx = self._allreduce_grad_async(p)
                self._handles[p] = (handle, ctx)
        for p, (handle, (compressed, ctx)) in self._handles.items():
            output = mpi_ops.synchronize(handle)
            self._allreduce_delay[p] = self.backward_passes_per_step
            if compressed is not p.grad:  # in place already otherwise
                p.grad.copy_(self._compression.decompress(
                    output, ctx).reshape(p.grad.shape))
        self._handles.clear()
        self._synchronized = True

    @contextlib.contextmanager
    def skip_synchronize(self):
        """``with opt.skip_synchronize(): opt.step()`` after a manual
        ``opt.synchronize()`` (reference idiom for grad clipping)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                import warnings

                warnings.warn(
                    "optimizer.step() called without a prior "
                    "optimizer.skip_synchronize() context after "
                    "optimizer.synchronize(); gradients were reduced twice."
                )
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        self._forget_stale_handles()
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize()."
            )
        return super(self.__class__, self).zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """Adasum-over-deltas (reference ``optimizer.py:270``): run the local
    optimizer step, Adasum-allreduce the parameter *delta*, apply the
    reduced delta — scale-invariant combination of whole updates."""

    def __init__(self, params, compression, backward_passes_per_step=1):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._step_count = 0

    def step(self, closure=None):
        self._step_count += 1
        if self._step_count % self.backward_passes_per_step != 0:
            return None
        if mpi_ops.size() == 1:
            return super(self.__class__, self).step(closure)
        starts = {}
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    starts[p] = p.detach().clone()
        loss = super(self.__class__, self).step(closure)
        handles = []
        for gi, group in enumerate(self.param_groups):
            for pi, p in enumerate(group["params"]):
                if p.grad is None:
                    continue
                delta = p.detach() - starts[p]
                compressed, ctx = self._compression.compress(delta)
                h = mpi_ops.allreduce_async(
                    compressed, name=f"adasum.delta.{gi}.{pi}", op=mpi_ops.Adasum
                )
                handles.append((p, h, ctx))
        for p, h, ctx in handles:
            reduced = self._compression.decompress(mpi_ops.synchronize(h), ctx)
            with torch.no_grad():
                p.copy_(starts[p] + reduced.reshape(p.shape))
        return loss

    def synchronize(self):
        pass

    @contextlib.contextmanager
    def skip_synchronize(self):
        yield


def _find_duplicates(lst):
    seen, dups = set(), set()
    for x in lst:
        if x in seen:
            dups.add(x)
        seen.add(x)
    return dups


def DistributedOptimizer(
    optimizer: torch.optim.Optimizer,
    named_parameters: Optional[Iterable] = None,
    compression=Compression.none,
    backward_passes_per_step: int = 1,
    op: int = mpi_ops.Average,
    gradient_predivide_factor: float = 1.0,
    num_groups: int = 0,
):
    """Wrap a torch optimizer for data-parallel training (reference factory
    ``horovod/torch/optimizer.py:441``)."""
    if gradient_predivide_factor != 1.0 and op != mpi_ops.Average:
        raise ValueError(
            "gradient_predivide_factor not supported with op != Average"
        )
    if op != mpi_ops.Adasum:
        cls = type(
            optimizer.__class__.__name__,
            (optimizer.__class__,),
            dict(_DistributedOptimizer.__dict__),
        )
        return cls(
            optimizer.param_groups, named_parameters, compression,
            backward_passes_per_step, op, gradient_predivide_factor, num_groups,
        )
    cls = type(
        optimizer.__class__.__name__,
        (optimizer.__class__,),
        dict(_DistributedAdasumOptimizer.__dict__),
    )
    return cls(optimizer.param_groups, compression, backward_passes_per_step)
