"""The ``hvt`` op library: every CUDA kernel's entry as a dispatcher op.

Each kernel wrapper of :mod:`.flash_attention`, :mod:`.fused_adamw` and
:mod:`.quantization` calls its kernel through one op of the ``hvt``
namespace (``torch.ops.hvt.flash_fwd`` and so on), registered here with
``torch.library``: one implementation for both devices, which takes the
plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors (or raises), and a fake implementation that gives the outputs'
shapes, dtypes and devices and computes nothing. The fake is what lets
the analysis plane (:mod:`..analysis.record`) run a step under
``FakeTensorMode`` through its kernels with no device and no memory; the
launch counters count in the real implementations only.

The ops are registered with ``torch.library.Library`` (``define``,
``impl``, ``register_fake``) rather than the ``custom_op`` decorator,
whose Python autograd wrapper and aliasing checks add host time to every
launch (an op's host cost a call is in ``PERF.md``). No op has an
autograd formula: the kernels run inside ``torch.autograd.Function``
bodies, under ``no_grad``, or for inference. A selective-checkpoint policy treats every ``hvt`` op as not
saveable (:mod:`.remat`), as XLA recomputes a ``pallas_call``.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["NAMESPACE", "define", "is_hvt_op"]

NAMESPACE = "hvt"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, impl: Callable, fake: Callable):
    """Register ``hvt::<schema>`` with ``impl`` for CPU and CUDA tensors and
    ``fake`` for fake ones; returns the op overload to call."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CPU")
    _LIB.impl(name, impl, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def is_hvt_op(op) -> bool:
    """True for an overload of this library's ops."""
    return getattr(op, "namespace", None) == NAMESPACE
