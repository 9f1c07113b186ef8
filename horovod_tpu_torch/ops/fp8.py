"""fp8 training matmuls with per-tensor delayed scaling.

The port of the JAX package's ``ops/fp8.py`` (``HVDTPU_COMPUTE_DTYPE=fp8``):
every attention and MLP projection runs on ``float8_e4m3fn`` operands in the
forward pass and pairs a ``float8_e5m2`` incoming gradient with the saved
e4m3 operands in the backward pass, through
:func:`~.quantization.fp8_matmul` (kernel 8 on the card, its plain version
on the CPU).

* **One cast a tensor, both orientations.** Each cast is one
  :func:`~.quantization.fp8_cast` (one pass of ``csrc/fp8_cast.cu`` on the
  card): scale from the ring, saturating cast, amax pushed, and the payload
  written row-major and transposed. Kernel 8 reads K-major operands only
  (Hopper's fp8 ``wgmma`` has no transposed fp8 operand), and the two
  orientations are exactly what the three products need: ``x`` and ``w``
  row-major now, their transposes saved for ``dW = g^T x`` and
  ``dX = g w``; ``g`` both ways in the backward pass. One fp8 copy of ``x``
  and of ``w`` is saved, as before. So a GPT-2-small step runs 216 casts
  (2 forward, 1 backward a projection) and no relayout.

* **Delayed scaling, state in the parameters.** Each tensor's cast scale
  comes from a ring of past max-abs values (``HVDTPU_FP8_AMAX_HISTORY``),
  so the cast needs nothing from the host. The rings and the weight-cast
  error-feedback residual are ordinary parameters whose names start with
  ``fp8_`` (:func:`add_fp8_state`): checkpointed and broadcast like every
  other parameter.
* **State updates ride the gradient.** :class:`Fp8Linear`'s backward
  returns the *new* ring and residual values as those inputs' gradients.
  ``DistributedOptimizer``'s allreduce (op must be Average) makes them
  replica-uniform, and :func:`fp8_state_optimizer` commits them as the
  update ``new - old`` while keeping them away from the inner optimizer (no
  moments, no decay).
* **fp32 master weights and cast-error feedback.** The weight is cast to
  e4m3 at every step after its bf16 rounding (flax's ``Dense`` casts the
  kernel to ``dtype`` before the dot); what the cast dropped is carried in
  ``fp8_k_residual`` and added back before the next cast, which keeps the
  time-averaged effective weight near its master value.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..optimizer import Optimizer
from ..utils import env as _env
from .quantization import E4M3_MAX, fp8_cast, fp8_matmul

__all__ = [
    "FP8_STATE_PREFIX",
    "Fp8Linear",
    "add_fp8_state",
    "fp8_linear",
    "fp8_state_gauges",
    "fp8_state_optimizer",
    "has_fp8_state",
    "resolve_compute_dtype",
]

FP8_STATE_PREFIX = "fp8_"
STATE_NAMES = ("fp8_x_amax_history", "fp8_k_amax_history",
               "fp8_g_amax_history", "fp8_k_residual")


def resolve_compute_dtype(mode: Optional[str]) -> str:
    """A config's ``compute_dtype``: ``None`` reads ``HVDTPU_COMPUTE_DTYPE``;
    ``""`` or ``"off"`` computes in the model's dtype, ``"fp8"`` through
    :class:`Fp8Linear`; anything else raises."""
    if mode is None:
        return _env.compute_dtype_mode()
    if mode in ("", "off"):
        return ""
    if mode != "fp8":
        raise ValueError(
            f"compute_dtype={mode!r} is not recognized; use ''|'fp8'"
        )
    return mode


class Fp8Linear(torch.autograd.Function):
    """``x @ w.T`` on fp8 operands under delayed scales.

    ``x`` is ``[..., K]`` and ``w`` the ``[N, K]`` weight as the op sees it
    (rounded to the compute dtype); ``kr`` is the fp32 weight-cast residual
    (``w``'s shape), ``xh``/``kh``/``gh`` the amax rings of x, of the
    weight and of the incoming gradient. The output is ``[..., N]`` in the
    promoted dtype of ``x`` and ``w``. The backward returns ``dx``, ``dw``
    and, as the gradients of ``kr``, ``xh``, ``kh`` and ``gh``, their new
    values; the forward alone (eval) leaves the state untouched."""

    @staticmethod
    def forward(ctx, x, w, kr, xh, kh, gh):
        n, k = w.shape
        out_dtype = torch.promote_types(x.dtype, w.dtype)
        x2 = x.detach().reshape(-1, k)
        if x2.stride(-1) != 1:
            x2 = x2.contiguous()
        # The transposes only feed the backward products.
        grad = any(ctx.needs_input_grad)
        e4 = torch.float8_e4m3fn
        cx = fp8_cast(x2, xh, e4, transposed=grad)
        # The weight after its bf16 rounding plus what the last cast
        # dropped; the new residual is what this cast drops, added back
        # before the next one so the rounding bias cannot accumulate.
        ck = fp8_cast(w.detach(), kh, e4, transposed=grad, residual=kr)
        out = fp8_matmul(cx.q, ck.q.t(), cx.scale, scale_b=ck.scale,
                         out_dtype=out_dtype)
        ctx.save_for_backward(cx.qt, ck.qt, cx.scale, ck.scale, gh,
                              cx.history, ck.history, ck.residual)
        ctx.x_shape = x.shape
        ctx.out_dtype = out_dtype
        return out.reshape(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        qxt, qkt, sx, sk, gh, new_xh, new_kh, new_kr = ctx.saved_tensors
        n = qkt.shape[1]
        g2 = g.reshape(-1, n)
        if g2.stride(-1) != 1:
            g2 = g2.contiguous()
        cg = fp8_cast(g2, gh, torch.float8_e5m2)
        # K-major operands throughout: dX = g W contracts over n, which g
        # and W^T hold contiguous; dW = g^T x over the rows, which g^T and
        # x^T hold contiguous.
        dx = fp8_matmul(cg.q, qkt.t(), cg.scale, scale_b=sk,
                        out_dtype=ctx.out_dtype)
        dw = fp8_matmul(cg.qt, qxt.t(), sx, scale_b=cg.scale,
                        out_dtype=ctx.out_dtype)
        return (dx.reshape(ctx.x_shape), dw, new_kr, new_xh, new_kh,
                cg.history)


def add_fp8_state(module: nn.Module, weight_shape, *, device=None) -> None:
    """Register one fp8 matmul's state on ``module`` (the parameters of the
    JAX package's ``Fp8DotGeneral`` scope): three fp32 amax rings of
    ``HVDTPU_FP8_AMAX_HISTORY`` slots and the fp32 weight-cast residual,
    all zero."""
    hlen = _env.fp8_amax_history()
    for name in STATE_NAMES[:3]:
        module.register_parameter(name, nn.Parameter(
            torch.zeros((hlen,), dtype=torch.float32, device=device)))
    module.register_parameter("fp8_k_residual", nn.Parameter(
        torch.zeros(tuple(weight_shape), dtype=torch.float32, device=device)))


def fp8_linear(x: torch.Tensor, w: torch.Tensor, state: nn.Module):
    """:class:`Fp8Linear` with the state :func:`add_fp8_state` put on
    ``state``."""
    return Fp8Linear.apply(x, w, state.fp8_k_residual, state.fp8_x_amax_history,
                           state.fp8_k_amax_history, state.fp8_g_amax_history)


# -- state plumbing ---------------------------------------------------------


def _is_state(name: str) -> bool:
    return any(part.startswith(FP8_STATE_PREFIX) for part in name.split("."))


def has_fp8_state(params: Dict[str, torch.Tensor]) -> bool:
    """True when the parameter dict (dotted names, as ``named_parameters``
    gives them) carries delayed-scaling state."""
    return any(_is_state(name) for name in params)


def fp8_state_optimizer(optimizer: Optimizer) -> Optimizer:
    """Wrap a training optimizer for fp8 delayed-scaling state, over
    parameter dicts with dotted names.

    Regular leaves see ``optimizer`` unchanged; ``fp8_`` leaves bypass it
    (no moments, no decay) and get the update ``new - old``, so adding it
    lands on the value their gradient carried. Harmless on parameters
    without fp8 state."""

    def init(params):
        return optimizer.init(
            {n: p for n, p in params.items() if not _is_state(n)})

    def update(grads, state, params=None):
        if params is None:
            raise ValueError(
                "fp8 state overwrite needs params; use "
                "optimizer.update(grads, state, params)"
            )
        regular = {n: g for n, g in grads.items() if not _is_state(n)}
        updates, state = optimizer.update(
            regular, state, {n: params[n] for n in regular})
        updates = dict(updates)
        for n, g in grads.items():
            if _is_state(n):
                updates[n] = (g - params[n]).to(params[n].dtype)
        return {n: updates[n] for n in grads}, state

    return Optimizer(init, update)


def fp8_state_gauges(params: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar health gauges over the delayed-scaling state: the largest
    amax any ring holds, the smallest e4m3 scale those rings give, and the
    L2 norm of every weight-cast residual. ``{}`` without fp8 state;
    reading them syncs with the device."""
    amaxes, residual_sq = [], []
    for name, leaf in params.items():
        parts = name.split(".")
        if any(p.endswith("_amax_history") for p in parts):
            amaxes.append(leaf.detach().max())
        elif "fp8_k_residual" in parts:
            residual_sq.append(leaf.detach().float().square().sum())
    if not amaxes:
        return {}
    ring_amax = torch.stack(amaxes)
    scales = torch.where(
        ring_amax > 0, ring_amax / torch.tensor(
            E4M3_MAX, dtype=ring_amax.dtype, device=ring_amax.device),
        torch.ones_like(ring_amax))
    out = {"fp8.amax_max": float(ring_amax.max()),
           "fp8.scale_min": float(scales.min())}
    if residual_sq:
        out["fp8.cast_residual_norm"] = float(
            torch.stack(residual_sq).sum().sqrt())
    return out
