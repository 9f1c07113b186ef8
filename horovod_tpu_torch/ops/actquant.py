"""int8 activation storage for the backward pass (``HVDTPU_ACT_QUANT``).

The port of the JAX package's ``ops/actquant.py``: at every boundary a
model declares, the activation the backward keeps is an int8 payload and
fp32 per-block scales instead of the model dtype, and the backward
dequantizes it where it reads it -- about 4x (fp32) or 2x (bf16) fewer
activation bytes.

* Models call :func:`boundary` after every block. Outside an active
  context (:func:`activate`) it is the identity. Inside, it quantizes the
  activation blockwise (kernel 4 on the card: ``quantize_blockwise`` of the
  flat fp32 activation, block ``HVDTPU_QUANT_BLOCK``), and its value is the
  dequantized activation (kernel 5) cast back to the activation's dtype --
  bit for bit the reference's eager ``boundary`` -- with a straight-through
  gradient (the identity on the input).
* Models run each block through :func:`segment`. Active, a segment is one
  non-reentrant checkpoint of the block (:func:`..ops.remat.
  checkpoint_module`), so the backward keeps only the segment's inputs and
  recomputes the rest. The segment's input is the previous boundary's
  output, which is exactly ``dequant(q, s)``: a ``saved_tensors_hooks``
  pair holds it as ``(q, s)`` and rebuilds it with kernel 5 when the
  recompute unpacks it -- bit for bit the value the forward read. (The
  pair is armed for the whole armed forward, so whatever follows the last
  boundary holds its input that way too.) Under a
  base remat policy (``make_train_step(remat=...)``) a segment keeps what
  that policy saves as well, as ``save_from_both_policies`` does in the
  reference.

The reference stores the int8 buffers by checkpointing the whole loss with
``save_only_these_names``, and XLA recomputes each stretch between
boundaries from them. A non-reentrant checkpoint of the whole loss in torch
recomputes the whole forward at the first unpack and holds all of it, so
the port's storage comes from checkpointing each segment instead; what
lies before the first segment (embeddings, a stem) and the activations
after the last boundary's (final norm, head, loss) are stored as without
act-quant.

ResNet's activations are ``[B, C, H, W]`` in ``channels_last`` memory; its
boundary (``nhwc=True``) quantizes them in NHWC order -- ``x.permute(0, 2,
3, 1)``, contiguous in that memory -- so each 256-block holds the elements
the reference's NHWC block holds.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, NamedTuple, Optional

import torch

from ..utils import env as _env
from . import remat as _remat
from .quantization import INT8, dequantize_blockwise, quantize_blockwise

__all__ = [
    "Q_NAME",
    "S_NAME",
    "active_mode",
    "activate",
    "boundary",
    "checkpoint_fn",
    "resolve_mode",
    "segment",
]

# The reference's names for the saved payload and scales (its checkpoint
# policy saves these names); here they tag what a segment holds.
Q_NAME = "hvdtpu_act_q8"
S_NAME = "hvdtpu_act_scale"

# Enablement travels in a thread-local, so one process can run act-quant
# and plain steps side by side; the segment policy rides with it.
_state = threading.local()

_HELD = "_hvdtpu_act_held"  # a boundary output's (q, s), for the pack hook


def active_mode() -> str:
    return getattr(_state, "mode", "")


def _active_policy() -> Optional[Callable]:
    return getattr(_state, "policy", None)


@contextlib.contextmanager
def activate(mode: str, policy: Optional[Callable] = None):
    """Arm :func:`boundary` and :func:`segment` for the extent of a forward;
    ``policy`` (a resolved remat policy, None for "save only the inputs")
    is what each segment's checkpoint saves besides its int8 input. While
    armed, any tensor autograd saves that is a boundary output -- a
    segment's input, or the input of what follows the last boundary -- is
    held as its int8 payload and scales."""
    prev = (active_mode(), _active_policy())
    _state.mode, _state.policy = mode, policy
    try:
        if mode:
            with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
                yield
        else:
            yield
    finally:
        _state.mode, _state.policy = prev


def resolve_mode(act_quant: Optional[str]) -> str:
    """Normalize a ``make_train_step(act_quant=...)`` argument: ``None``
    reads ``HVDTPU_ACT_QUANT``, ``""`` is off, ``"int8"`` on."""
    if act_quant is None:
        return _env.act_quant_mode()
    if act_quant in ("", "int8"):
        return act_quant
    raise ValueError(
        f"act_quant={act_quant!r} is not recognized; use ''|'int8'"
    )


class _Held(NamedTuple):
    """What a segment holds for a boundary output: the int8 payload, the
    fp32 scales and what it takes to rebuild the activation."""

    q: torch.Tensor
    s: torch.Tensor
    shape: torch.Size
    dtype: torch.dtype
    nhwc: bool
    block: int


def _flat(x: torch.Tensor, nhwc: bool) -> torch.Tensor:
    if nhwc:
        x = x.permute(0, 2, 3, 1)
    return x.reshape(-1).float()


def _rebuild(h: _Held) -> torch.Tensor:
    """``dequant(q, s)`` in the activation's shape, layout and dtype."""
    flat = dequantize_blockwise(h.q, h.s, h.block)
    if h.nhwc:
        b, c, hh, w = h.shape
        return flat.reshape(b, hh, w, c).permute(0, 3, 1, 2).to(h.dtype)
    return flat.reshape(h.shape).to(h.dtype)


class _StraightThrough(torch.autograd.Function):
    """Value: the held activation rebuilt; gradient: the identity on
    ``x``."""

    @staticmethod
    def forward(ctx, x, held):
        return _rebuild(held)

    @staticmethod
    def backward(ctx, g):
        return g, None


def boundary(x: torch.Tensor, *, nhwc: bool = False) -> torch.Tensor:
    """Declare an activation-storage boundary: the identity unless an
    act-quant context is active (or ``x`` is not floating); else the
    int8-rounded activation with a straight-through gradient. ``nhwc``
    quantizes a ``[B, C, H, W]`` activation in NHWC order."""
    if not active_mode() or not x.is_floating_point():
        return x
    block = _env.quant_block()
    q, s = quantize_blockwise(_flat(x.detach(), nhwc), block=block,
                              spec=INT8)
    held = _Held(q, s, x.shape, x.dtype, nhwc, block)
    y = _StraightThrough.apply(x, held)
    setattr(y, _HELD, held)
    return y


def _pack(t: torch.Tensor):
    held = getattr(t, _HELD, None)
    return t if held is None else held


def _unpack(packed):
    return _rebuild(packed) if isinstance(packed, _Held) else packed


def segment(module: torch.nn.Module, *args, call: Optional[Callable] = None,
            **kwargs):
    """``module(*args, **kwargs)`` (or ``call(*args, **kwargs)``, code that
    runs ``module``) as one segment between two boundaries: a plain call
    unless an act-quant context is active and autograd records; else one
    checkpoint of it under the context's remat policy, holding an input
    that is a boundary output as its int8 payload and scales."""
    if not active_mode() or not torch.is_grad_enabled():
        return module(*args, **kwargs) if call is None else call(*args,
                                                                 **kwargs)
    return _remat.checkpoint_module(module, _active_policy(), *args,
                                    call=call, **kwargs)


def checkpoint_fn(fn: Callable, remat, act_quant: str) -> Callable:
    """The act-quant-aware extension of :func:`..ops.remat.checkpoint_fn`:
    off, ``remat`` checkpoints the whole of ``fn`` as it does without
    act-quant; on, ``fn`` runs with the boundaries armed and ``remat``'s
    policy goes to every segment (off or ``"full"``: each segment saves
    only its int8 input)."""
    if not act_quant:
        return _remat.checkpoint_fn(fn, remat)
    enabled, policy = _remat.resolve_policy(remat)

    @functools.wraps(fn)
    def armed(*args, **kwargs):
        with activate(act_quant, policy if enabled else None):
            return fn(*args, **kwargs)

    return armed
