"""Flash-attention forward: the CUDA kernel, its wrapper and its plain
version.

The port of ``horovod_tpu/ops/pallas_kernels.py::_fwd_kernel`` (through
``_fwd_pallas``, ``flash_attention_with_lse`` and ``flash_attention``).
The kernel is ``csrc/flash_fwd.cu`` -- hand-written CUDA C++ for sm_90a,
built with nvcc at first use (:mod:`._build`); its source note says what
bounds it on an H100 and what the simple design leaves on the table.

* :func:`flash_attention_with_lse` -- ``(out, lse)``: out in the input
  dtype, lse fp32 ``[B, H, Sq]``; causal masking on global positions
  ``q_offset``/``kv_offset``; keys at or past ``kv_len`` (default: all of
  them) are masked; rows with no valid key give out 0 and lse ``-inf``.
* :func:`flash_attention` -- the output only.
* :func:`flash_attention_reference` -- the plain PyTorch version with
  the same signature and outputs: fp32 scores, the same mask and ``-inf``
  rules, ``p`` rounded to V's dtype before the PV product.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise. Layouts are the JAX
package's: ``"bshd"`` ``[B, S, H, D]``, ``"bhsd"`` ``[B, H, S, D]`` and
the packed ``"bsm"`` ``[B, S, H*D]`` with ``n_heads`` given -- the
projection's native layout, which the kernel reads in place through
strides (a strided view such as one third of a fused QKV output is read
without a copy). The kernel takes bf16 with head dim 64 or 128.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "flash_attention",
    "flash_attention_with_lse",
    "flash_attention_reference",
    "launches",
    "reset_launches",
]

KERNEL_SOURCE = "flash_fwd"
HEAD_DIMS = (64, 128)

# Kernel launches since import (or the last reset_launches()): the wrapper
# adds one where it launches the kernel and nowhere else, so a run can show
# that its main path went through the kernel.
launches = 0
_count_lock = threading.Lock()
_fn = None


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def _views(q, k, v, layout: str, n_heads: int):
    """``[B, S, H, D]`` views of q/k/v (no copies)."""
    if layout == "bsm":
        if n_heads <= 0:
            raise ValueError("layout='bsm' requires n_heads")
        if q.shape[-1] % n_heads:
            raise ValueError(
                f"packed width {q.shape[-1]} is not a multiple of "
                f"n_heads={n_heads}"
            )
        d = q.shape[-1] // n_heads
        return tuple(x.unflatten(-1, (n_heads, d)) for x in (q, k, v))
    if layout == "bshd":
        return q, k, v
    if layout == "bhsd":
        return tuple(x.transpose(1, 2) for x in (q, k, v))
    raise ValueError(
        f"layout must be 'bshd', 'bhsd' or 'bsm', got {layout!r}"
    )


def _empty_out(b, sq, h, d, layout, like):
    """Output tensor in ``layout`` and its ``[B, Sq, H, D]`` view."""
    if layout == "bsm":
        out = torch.empty((b, sq, h * d), dtype=like.dtype, device=like.device)
        return out, out.unflatten(-1, (h, d))
    if layout == "bhsd":
        out = torch.empty((b, h, sq, d), dtype=like.dtype, device=like.device)
        return out, out.transpose(1, 2)
    out = torch.empty((b, sq, h, d), dtype=like.dtype, device=like.device)
    return out, out


def _check(q4, k4, v4, kv_len):
    if not (q4.dtype == k4.dtype == v4.dtype):
        raise TypeError(
            f"q/k/v dtypes differ: {q4.dtype}, {k4.dtype}, {v4.dtype}"
        )
    if not (q4.device == k4.device == v4.device):
        raise ValueError(
            f"q/k/v devices differ: {q4.device}, {k4.device}, {v4.device}"
        )
    b, sq, h, d = q4.shape
    if k4.shape[0] != b or k4.shape[2:] != (h, d) or v4.shape != k4.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q4.shape)}, k {tuple(k4.shape)}, "
            f"v {tuple(v4.shape)} (as [B, S, H, D])"
        )
    skv = k4.shape[1]
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len={kv_len} outside [0, {skv}]")
    return kv_len


def _scalar(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset=0,
    kv_offset=0,
    sm_scale: Optional[float] = None,
    layout: str = "bshd",
    n_heads: int = 0,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel (same signature, same
    outputs). Scores and softmax statistics are fp32; ``p`` is rounded to
    V's dtype before the PV product, which accumulates in fp32."""
    q4, k4, v4 = _views(q, k, v, layout, n_heads)
    kv_len = _check(q4, k4, v4, kv_len)
    b, sq, h, d = q4.shape
    skv = k4.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qh = q4.transpose(1, 2).float()  # [B, H, Sq, D]
    kh = k4.transpose(1, 2).float()
    vh = v4.transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale  # [B, H, Sq, Skv]
    col = torch.arange(skv, device=q.device)
    valid = (col < kv_len).expand(sq, skv)
    if causal:
        q_pos = _scalar(q_offset) + torch.arange(sq, device=q.device)
        valid = valid & (q_pos[:, None] >= _scalar(kv_offset) + col[None, :])
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vh.float())
    has = l > 0
    o = torch.where(has, o / torch.where(has, l, torch.ones_like(l)), 0.0)
    lse = torch.where(has, m_safe + torch.log(l), float("-inf")).squeeze(-1)
    out, out4 = _empty_out(b, sq, h, d, layout, q)
    out4.copy_(o.transpose(1, 2))
    return out, lse


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load(KERNEL_SOURCE).hvt_flash_fwd_bf16
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [ptr] * 5 + [i32] * 5 + [i64] * 12
            + [i32, i32, i32, ctypes.c_float, i32, ptr]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q4, k4, v4, *, causal, q_offset, kv_offset, sm_scale, layout,
            kv_len):
    if q4.dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA flash kernel takes bfloat16, got {q4.dtype}"
        )
    b, sq, h, d = q4.shape
    skv = k4.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash kernel takes head dim {HEAD_DIMS}, got {d}"
        )
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid limit")
    for name, x in (("q", q4), ("k", k4), ("v", v4)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a unit stride along D")
        if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} rows must be 16-byte aligned: strides "
                f"{tuple(x.stride())}, address {x.data_ptr():#x}"
            )
    out, o4 = _empty_out(b, sq, h, d, layout, q4)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q4.device)
    if b == 0 or h == 0 or sq == 0:
        return out, lse
    fn = _kernel_fn()
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        rc = fn(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            lse.data_ptr(), b, h, sq, skv, d,
            *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
            o4.stride(0), o4.stride(1), o4.stride(2),
            kv_len, q_offset, kv_offset, float(sm_scale), int(bool(causal)),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed with cudaError_t {rc}"
        )
    _count_launch()
    return out, lse


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset=0,
    kv_offset=0,
    sm_scale: Optional[float] = None,
    layout: str = "bshd",
    n_heads: int = 0,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise attention returning ``(out, lse)`` -- the port of the
    JAX package's ``flash_attention_with_lse``. CUDA tensors run the
    kernel; CPU tensors run :func:`flash_attention_reference`."""
    device = q.device.type
    if device == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
            sm_scale=sm_scale, layout=layout, n_heads=n_heads, kv_len=kv_len,
        )
    if device != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {device}")
    q4, k4, v4 = _views(q, k, v, layout, n_heads)
    kv_len = _check(q4, k4, v4, kv_len)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q4.shape[-1])
    return _launch(
        q4, k4, v4, causal=causal, q_offset=_scalar(q_offset),
        kv_offset=_scalar(kv_offset), sm_scale=sm_scale, layout=layout,
        kv_len=kv_len,
    )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask=None,
    sm_scale: Optional[float] = None,
    layout: str = "bshd",
    n_heads: int = 0,
) -> torch.Tensor:
    """Memory-efficient attention output (the port of the JAX package's
    ``flash_attention``). A dense ``mask`` is not supported by the
    blockwise kernel."""
    if mask is not None:
        raise ValueError(
            "flash_attention supports causal masking only; pass mask=None"
        )
    out, _ = flash_attention_with_lse(
        q, k, v, causal=causal, sm_scale=sm_scale, layout=layout,
        n_heads=n_heads,
    )
    return out
