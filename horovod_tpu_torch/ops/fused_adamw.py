"""Fused AdamW update over flat buffers: the CUDA kernel, its wrapper and
its plain version.

The port of ``horovod_tpu/ops/pallas_kernels.py::_fused_adamw_kernel``
(through ``fused_adamw_update_pallas`` and ``optimizer.fused_adamw_update``),
the ZeRO-1 sharded update's one pass over each flat shard bucket. The
kernel is ``csrc/fused_adamw.cu`` (hand-written CUDA C++ for sm_90a, built
with nvcc at first use by :mod:`._build`).

* :class:`FusedAdamSpec` -- the static AdamW hyperparameters.
* :func:`fused_adamw_update_reference` -- the plain PyTorch version:
  ``(update, new_m, new_v)`` from flat ``p, m, v, g`` and the step count
  before this update, op for op the JAX package's
  ``_fused_adamw_update_jax`` (fp32 math whatever the buffer dtypes; the
  update lands in ``p``'s dtype, the moments keep theirs).
* :func:`fused_adamw_update` -- the dispatching wrapper. It updates ``m``
  and ``v`` in place and returns the update. CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise.

``count`` is a device int32 scalar on the card: the kernel reads it there,
so a step never syncs with the host for it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Tuple

import torch

from . import _build

__all__ = [
    "FusedAdamSpec",
    "fused_adamw_update",
    "fused_adamw_update_reference",
    "launches",
    "reset_launches",
]

KERNEL_SOURCE = "fused_adamw"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since import (or the last reset_launches()): the wrapper
# adds one where it launches the kernel and nowhere else.
launches = 0
_count_lock = threading.Lock()
_fn = None


class FusedAdamSpec(NamedTuple):
    """Static AdamW hyperparameters of a ``fused_adamw`` optimizer -- what
    the fused kernel takes as its arguments."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float = 1e-4


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def fused_adamw_update_reference(
    p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    count, spec: FusedAdamSpec,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: ``(update, new_m, new_v)``, new tensors, in the
    JAX package's order of operations."""
    c = (torch.as_tensor(count, device=p.device).to(torch.int32) + 1).float()
    g32 = g.float()
    p32 = p.float()
    nm = (1.0 - spec.b1) * g32 + spec.b1 * m.float()
    nv = (1.0 - spec.b2) * (g32 * g32) + spec.b2 * v.float()
    mhat = nm / (1.0 - spec.b1 ** c)
    vhat = nv / (1.0 - spec.b2 ** c)
    # sqrt through float64: torch's vectorized fp32 sqrt on the CPU is not
    # always correctly rounded; the double's root rounded to fp32 is
    # (53 >= 2 * 24 + 2 bits), so every op here rounds as IEEE fp32 does --
    # like the JAX twin, and like the kernel's __fsqrt_rn on the card.
    u = mhat / (torch.sqrt((vhat + spec.eps_root).double()).float() + spec.eps)
    if spec.weight_decay:
        u = u + spec.weight_decay * p32
    return (
        (-spec.learning_rate * u).to(p.dtype),
        nm.to(m.dtype),
        nv.to(v.dtype),
    )


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load(KERNEL_SOURCE).hvt_fused_adamw
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = (
            [ptr] * 8 + [ctypes.c_longlong, i32, i32] + [f32] * 8 + [ptr]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(p, m, v, g, count):
    n = p.numel()
    for name, x in (("p", p), ("m", m), ("v", v), ("g", g)):
        if x.dim() != 1 or x.numel() != n:
            raise ValueError(
                f"fused AdamW takes flat buffers of one length; {name} has "
                f"shape {tuple(x.shape)}, p has {n} elements"
            )
        if x.device != p.device:
            raise ValueError(f"{name} is on {x.device}, p on {p.device}")
    if not isinstance(count, torch.Tensor) or count.numel() != 1:
        raise TypeError("count must be a one-element int32 tensor")


def _launch(p, m, v, g, count, spec):
    for name, x in (("p", p), ("m", m), ("v", v), ("g", g)):
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(
                f"the CUDA AdamW kernel takes float32 or bfloat16, got "
                f"{x.dtype} for {name}"
            )
        if x.stride(0) != 1:
            raise ValueError(f"{name} must be contiguous")
    if g.dtype != p.dtype or v.dtype != m.dtype:
        raise TypeError(
            "the CUDA AdamW kernel takes g in p's dtype and v in m's dtype; "
            f"got p {p.dtype}, g {g.dtype}, m {m.dtype}, v {v.dtype}"
        )
    if count.dtype != torch.int32 or count.device != p.device:
        raise TypeError(
            f"count must be an int32 tensor on {p.device}, got {count.dtype} "
            f"on {count.device}"
        )
    u = torch.empty_like(p)
    fn = _kernel_fn()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(
            p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
            u.data_ptr(), m.data_ptr(), v.data_ptr(), count.data_ptr(),
            p.numel(), _DTYPE_CODES[p.dtype], _DTYPE_CODES[m.dtype],
            -spec.learning_rate, spec.b1, spec.b2, 1.0 - spec.b1,
            1.0 - spec.b2, spec.eps, spec.eps_root, spec.weight_decay, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_adamw kernel launch failed with cudaError_t {rc}"
        )
    _count_launch()
    return u


def fused_adamw_update(
    p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    count: torch.Tensor, spec: FusedAdamSpec,
) -> torch.Tensor:
    """One fused AdamW step over flat 1-D buffers (a ZeRO-1 shard): updates
    ``m`` and ``v`` in place and returns the update (``-lr`` applied, in
    ``p``'s dtype). ``count`` is the step count before this update, an
    int32 tensor on ``p``'s device. CUDA tensors launch the kernel; CPU
    tensors run :func:`fused_adamw_update_reference`."""
    _check(p, m, v, g, count)
    device = p.device.type
    if device == "cpu":
        u, nm, nv = fused_adamw_update_reference(p, m, v, g, count, spec)
        m.copy_(nm)
        v.copy_(nv)
        return u
    if device != "cuda":
        raise ValueError(f"fused AdamW runs on cuda or cpu, not {device}")
    return _launch(p, m, v, g, count, spec)
