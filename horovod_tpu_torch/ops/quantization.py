"""Blockwise-scaled quantization: the int8/fp8 wire format, its CUDA
kernels, their wrappers and their plain versions.

The port of the wire half of the JAX package's ``ops/quantization.py``. A
flat buffer is cut into fixed-size blocks; each block is scaled by its own
max-abs so the wire dtype's whole range is used per block, and the
per-block fp32 scales ride along as a side channel (``4/block`` overhead,
1.6% at the default block of 256). :mod:`.fusion` runs these codecs around
the quantized collectives; :mod:`.compression` exposes them as
``Compression.int8`` / ``Compression.fp8``.

* :func:`quantize_blockwise_reference` / :func:`dequantize_blockwise_
  reference` -- the plain PyTorch versions, op for op the JAX package's
  ``impl="jax"`` path: ``scale = amax / qmax`` (1 where ``amax`` is not
  positive, so all-zero and NaN blocks get 1), ``x / scale`` by IEEE
  division, ``torch.round`` (half to even) and a clip to ``±qmax`` for
  int8, a round-to-nearest-even cast for e4m3; ``q * scale`` back.
* :func:`quantize_blockwise` / :func:`dequantize_blockwise` -- the
  dispatching wrappers: CPU tensors take the plain versions, CUDA tensors
  launch the kernels of ``csrc/quant_blockwise.cu`` (built with nvcc at
  first use by :mod:`._build`) or raise. int8 and fp8 alike, any block
  size: the TPU kernel's int8-only, 128-aligned limit is a TPU layout
  limit the port has no reason to copy.

The fp8-compute half (``HVDTPU_COMPUTE_DTYPE=fp8``): the delayed-scaling
algebra (:func:`fp8_scale_from_history`, :func:`fp8_push_amax`,
:func:`fp8_saturating_cast`, op for op the JAX package's);
:func:`fp8_cast`, which does a tensor's whole cast in one pass of
``csrc/fp8_cast.cu`` on the card -- scale from the ring, saturating cast,
the payload row-major and transposed, the amax pushed onto a new ring, and
for a weight the error-feedback residual -- and :func:`fp8_cast_reference`
(exactly the composition of those helpers) on the CPU; and
:func:`fp8_matmul`, which launches ``csrc/fp8_matmul.cu`` (kernel 8, fp8
``wgmma`` on K-major operands) on CUDA tensors and runs
:func:`fp8_matmul_reference` on CPU tensors. :mod:`.fp8` builds the training
matmul on them, handing kernel 8 the K-major payloads the casts wrote. Scales
stay device tensors throughout, so a step never syncs on one.

The weight half (``ServePool(weight_dtype="int8")``): a 2-D matmul weight is
quantized once per checkpoint load with one fp32 scale per output column
(:func:`quantize_weight`: the blockwise codec at ``block = K`` on the
``[N, K]`` row-major view, kernel 4 on the card), and
:func:`int8_weight_matmul` applies the scales, and a bias when given, in the
epilogue of ``csrc/int8_matmul.cu`` (kernel 7) on CUDA tensors, or runs
:func:`int8_weight_matmul_reference` on CPU tensors. :func:`qmatmul` is the
quantization-transparent matmul an ``infer_fn`` routes its products
through; :func:`quantize_params` picks the weights (a dict nest) or
quantizes every ``Dense`` of a model in place.

The KV-head half (the decode engine's int8 KV cache, :mod:`..serve.
kvcache`): :func:`quantize_kv_heads` stores every head vector of a
``[..., H, head_dim]`` fp32 buffer int8 with one fp32 max-abs scale, the
blockwise codec at ``block = head_dim`` on the buffer viewed flat (kernel 4
on a CUDA tensor, counted in ``launches_quant``), and
:func:`dequantize_kv_heads` reads it back (kernel 5, ``launches_dequant``);
:func:`quantize_kv_heads_reference` / :func:`dequantize_kv_heads_reference`
are their plain versions, the JAX package's formula.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import env as _env
from . import _build

__all__ = [
    "E4M3_MAX",
    "E5M2_MAX",
    "FP8",
    "Fp8Cast",
    "INT8",
    "QuantSpec",
    "QuantizedWeight",
    "SCALE_DTYPE",
    "default_block",
    "dequantize_blockwise",
    "dequantize_blockwise_reference",
    "dequantize_kv_heads",
    "dequantize_kv_heads_reference",
    "dequantize_weight",
    "fp8_cast",
    "fp8_cast_reference",
    "fp8_matmul",
    "fp8_matmul_reference",
    "fp8_push_amax",
    "fp8_saturating_cast",
    "fp8_scale_from_history",
    "int8_weight_matmul",
    "int8_weight_matmul_reference",
    "launches_dequant",
    "launches_fp8_cast",
    "launches_fp8_matmul",
    "launches_fp8_relayout",
    "launches_int8_matmul",
    "launches_int8_matmul_reduce",
    "launches_int8_relayout",
    "launches_quant",
    "qmatmul",
    "quant_spec",
    "quantize_blockwise",
    "quantize_blockwise_reference",
    "quantize_kv_heads",
    "quantize_kv_heads_reference",
    "quantize_params",
    "quantize_weight",
    "quantized_wire_bytes",
    "reset_launches",
    "supports_fp8",
]

KERNEL_SOURCE = "quant_blockwise"
FP8_MATMUL_SOURCE = "fp8_matmul"
FP8_CAST_SOURCE = "fp8_cast"
INT8_MATMUL_SOURCE = "int8_matmul"
SCALE_DTYPE = torch.float32
# Past this magnitude round-to-nearest-even lands beyond e4m3's largest
# finite value (448), and e4m3 has no infinity: the value becomes NaN.
_E4M3_OVERFLOW = 464.0

# Kernel launches since import (or the last reset_launches()): each wrapper
# adds one where it launches its kernel and nowhere else.
launches_quant = 0
launches_dequant = 0
launches_fp8_matmul = 0
launches_int8_matmul = 0  # kernel 7, one a call
launches_int8_matmul_reduce = 0  # its split-contraction sum
launches_int8_relayout = 0  # calls that copied an operand onto 16-byte rows
launches_fp8_cast = 0  # the fused cast-transpose-amax kernel's casts
launches_fp8_relayout = 0  # its byte mode: a K-major copy for kernel 8
_count_lock = threading.Lock()
_fns = {}


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """One wire format: its dtype, the largest magnitude a block's scale
    maps the block's max-abs onto, and whether values round to integers."""

    name: str
    wire_dtype_name: str
    qmax: float
    integer: bool

    @property
    def wire_dtype(self) -> torch.dtype:
        return getattr(torch, self.wire_dtype_name)

    @property
    def itemsize(self) -> int:
        return self.wire_dtype.itemsize

    @property
    def wire_code(self) -> int:
        """The kernels' name for the wire: 0 int8, 1 fp8 e4m3."""
        return 0 if self.integer else 1


INT8 = QuantSpec(name="int8", wire_dtype_name="int8", qmax=127.0, integer=True)
# e4m3 keeps the most mantissa of the fp8 pair; 448 is its max finite.
FP8 = QuantSpec(
    name="fp8", wire_dtype_name="float8_e4m3fn", qmax=448.0, integer=False
)


def supports_fp8() -> bool:
    """True when this torch build has the fp8 dtypes (float8_e4m3fn)."""
    return hasattr(torch, "float8_e4m3fn")


def quant_spec(name: str) -> QuantSpec:
    if name == "int8":
        return INT8
    if name == "fp8":
        if not supports_fp8():
            raise RuntimeError(
                "fp8 wire format requested but this torch build has no "
                "float8_e4m3fn dtype; use int8"
            )
        return FP8
    raise ValueError(f"unknown quantization {name!r}; use int8|fp8")


def default_block() -> int:
    return _env.quant_block()


def quantized_wire_bytes(n_elements: int, block: int, spec: QuantSpec) -> int:
    """Wire bytes of one quantized buffer: the payload in the wire dtype
    plus the fp32 per-block scales."""
    n_blocks = -(-n_elements // block)
    return n_elements * spec.itemsize + n_blocks * SCALE_DTYPE.itemsize


_COUNTERS = ("quant", "dequant", "fp8_matmul", "int8_matmul",
             "int8_matmul_reduce", "int8_relayout", "fp8_cast",
             "fp8_relayout")


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    with _count_lock:
        for which in _COUNTERS:
            globals()["launches_" + which] = 0


def _count_launch(which: str) -> None:
    with _count_lock:
        globals()["launches_" + which] += 1


def _blocks_view(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int, int]:
    """Flat buffer -> (``[n_blocks, block]`` fp32 rows, n, pad). Any length
    is zero-padded up to a whole block (padding quantizes to exact zeros
    and is sliced off after dequantization)."""
    n = int(x.shape[0])
    pad = (-n) % block
    xf = x.float()
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad,))])
    return xf.reshape(-1, block), n, pad


def _check_flat(x: torch.Tensor, name: str) -> None:
    if x.dim() != 1:
        raise ValueError(
            f"blockwise quantization takes flat buffers; {name} has shape "
            f"{tuple(x.shape)}"
        )


def quantize_blockwise_reference(
    x: torch.Tensor, block: Optional[int] = None, spec: QuantSpec = INT8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``(q, scales)``, ``q`` the wire-dtype payload of
    ``x``'s length and ``scales`` fp32 of length ``ceil(len / block)``."""
    if block is None:
        block = default_block()
    _check_flat(x, "x")
    rows, n, _ = _blocks_view(x, block)
    amax = rows.abs().amax(dim=1, keepdim=True)
    # Divide by a tensor on x's device: on the card torch turns a division
    # by a host scalar into a multiply by its reciprocal, an ulp off.
    qmax = torch.tensor(spec.qmax, dtype=torch.float32, device=x.device)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    y = rows / scale
    if spec.integer:
        q = torch.clamp(torch.round(y), -spec.qmax, spec.qmax).to(
            spec.wire_dtype
        )
    else:
        # The round-to-nearest-even cast without saturation, as jax's and
        # the kernel's: torch's CPU cast saturates out-of-range values.
        y = torch.where(y.abs() > _E4M3_OVERFLOW, torch.nan, y)
        q = y.to(spec.wire_dtype)
    return q.reshape(-1)[:n], scale[:, 0].to(SCALE_DTYPE)


def dequantize_blockwise_reference(
    q: torch.Tensor,
    scales: torch.Tensor,
    block: Optional[int] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain version: the inverse of :func:`quantize_blockwise_
    reference` up to the rounding the wire performed."""
    if block is None:
        block = default_block()
    _check_flat(q, "q")
    n = int(q.shape[0])
    pad = (-n) % block
    if pad:
        q = torch.cat([q, torch.zeros((pad,), dtype=q.dtype, device=q.device)])
    rows = q.reshape(-1, block).float() * scales.float()[:, None]
    return rows.reshape(-1)[:n].to(out_dtype)


_SOURCES = {"hvt_fp8_matmul": FP8_MATMUL_SOURCE,
            "hvt_fp8_cast": FP8_CAST_SOURCE,
            "hvt_int8_matmul": INT8_MATMUL_SOURCE,
            "hvt_int8_weight_map": INT8_MATMUL_SOURCE}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(_SOURCES.get(name, KERNEL_SOURCE)), name)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "hvt_quantize_blockwise":
            fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, ctypes.c_float, ptr]
        elif name == "hvt_fp8_matmul":
            fn.argtypes = ([ptr] * 6 + [i32] * 3 + [i64] * 3 + [i32] * 5
                           + [ptr])
        elif name == "hvt_fp8_cast":
            fn.argtypes = ([ptr, i64] + [ptr] * 6 + [i64, ptr, i64, ptr]
                           + [i32] * 3 + [ctypes.c_float, i32, i32, ptr])
        elif name == "hvt_int8_matmul":
            fn.argtypes = ([ptr] * 7 + [i32] * 4 + [i64] * 3 + [i32] * 4
                           + [ptr])
        elif name == "hvt_int8_weight_map":
            fn.argtypes = [ptr, ptr, i32, i32, i64, i32]
        else:
            fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _spec_of_wire(dtype: torch.dtype) -> QuantSpec:
    for spec in (INT8, FP8):
        if dtype == spec.wire_dtype:
            return spec
    raise TypeError(
        f"the dequantize kernel takes an int8 or float8_e4m3fn payload, got "
        f"{dtype}"
    )


def _check_device(x: torch.Tensor) -> str:
    device = x.device.type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"blockwise quantization runs on cuda or cpu, not {device}")
    return device


def _check_kernel_input(x: torch.Tensor, name: str, dtype=None) -> None:
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"the CUDA kernel takes {dtype} for {name}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def quantize_blockwise(
    x: torch.Tensor, block: Optional[int] = None, spec: QuantSpec = INT8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a flat buffer: ``(q, scales)``, ``q`` the wire-dtype
    payload (same length as ``x``) and ``scales`` fp32 of length
    ``ceil(len / block)``. CPU tensors run :func:`quantize_blockwise_
    reference`; CUDA tensors (contiguous fp32) launch the kernel."""
    if block is None:
        block = default_block()
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    _check_flat(x, "x")
    if _check_device(x) == "cpu":
        return quantize_blockwise_reference(x, block, spec)
    _check_kernel_input(x, "x", torch.float32)
    n = x.shape[0]
    q = torch.empty((n,), dtype=spec.wire_dtype, device=x.device)
    scales = torch.empty((-(-n // block),), dtype=SCALE_DTYPE, device=x.device)
    if n == 0:
        return q, scales
    fn = _kernel("hvt_quantize_blockwise")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), n, block,
                spec.wire_code, spec.qmax, stream)
    if rc != 0:
        raise RuntimeError(
            f"quantize_blockwise kernel launch failed with cudaError_t {rc}"
        )
    _count_launch("quant")
    return q, scales


def dequantize_blockwise(
    q: torch.Tensor,
    scales: torch.Tensor,
    block: Optional[int] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (up to the rounding the wire
    format performed). CPU tensors run :func:`dequantize_blockwise_
    reference`; CUDA tensors launch the kernel, which writes fp32 (a cast
    to another ``out_dtype`` follows it)."""
    if block is None:
        block = default_block()
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    _check_flat(q, "q")
    n = q.shape[0]
    if scales.dim() != 1 or scales.shape[0] != -(-n // block):
        raise ValueError(
            f"{n} elements in blocks of {block} need {-(-n // block)} scales, "
            f"got shape {tuple(scales.shape)}"
        )
    if scales.device != q.device:
        raise ValueError(f"scales are on {scales.device}, q on {q.device}")
    if _check_device(q) == "cpu":
        return dequantize_blockwise_reference(q, scales, block, out_dtype)
    spec = _spec_of_wire(q.dtype)
    _check_kernel_input(q, "q")
    _check_kernel_input(scales, "scales", SCALE_DTYPE)
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n == 0:
        return out.to(out_dtype)
    fn = _kernel("hvt_dequantize_blockwise")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, block,
                spec.wire_code, stream)
    if rc != 0:
        raise RuntimeError(
            f"dequantize_blockwise kernel launch failed with cudaError_t {rc}"
        )
    _count_launch("dequant")
    return out.to(out_dtype)


# -- the int8 KV cache -------------------------------------------------------
#
# The decode engine's paged KV pool (serve/kvcache.py) stores keys and values
# int8 with one fp32 max-abs scale per (token, head): the blockwise codec with
# block = head_dim, so a loud head cannot crush a quiet one's resolution. The
# scales ride in a parallel fp32 pool: 4/head_dim overhead (6% at head_dim
# 64) against a 4x cut of an fp32 cache's bytes.


def _check_heads(x: torch.Tensor, name: str) -> int:
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"{name} needs a last (head_dim) axis, got shape "
                         f"{tuple(x.shape)}")
    return int(x.shape[-1])


def quantize_kv_heads_reference(
    x: torch.Tensor, spec: QuantSpec = INT8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``x[..., H, head_dim]`` -> ``(q, scales)``, ``q``
    the wire-dtype payload of ``x``'s shape and ``scales`` fp32 of shape
    ``x.shape[:-1]``: per head vector ``scale = amax / qmax`` (1 where
    ``amax`` is not positive), ``round(x / scale)`` clipped to ``qmax``."""
    hd = _check_heads(x, "x")
    q, scales = quantize_blockwise_reference(
        x.to(torch.float32).reshape(-1), hd, spec)
    return q.reshape(x.shape), scales.reshape(x.shape[:-1])


def dequantize_kv_heads_reference(
    q: torch.Tensor, scales: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain version: ``q * scales[..., None]`` in fp32, then
    ``out_dtype``."""
    hd = _check_heads(q, "q")
    out = dequantize_blockwise_reference(
        q.reshape(-1), scales.to(torch.float32).reshape(-1), hd)
    return out.reshape(q.shape).to(out_dtype)


def quantize_kv_heads(
    x: torch.Tensor, spec: QuantSpec = INT8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize every head vector of ``x[..., H, head_dim]``: ``(q,
    scales)`` as :func:`quantize_kv_heads_reference`. A CPU tensor runs the
    plain version; a CUDA tensor launches kernel 4 at ``block = head_dim``
    on its contiguous fp32 buffer viewed flat (one launch)."""
    hd = _check_heads(x, "x")
    if _check_device(x) == "cpu":
        return quantize_kv_heads_reference(x, spec)
    flat = x.to(torch.float32).contiguous().reshape(-1)
    q, scales = quantize_blockwise(flat, hd, spec)
    return q.reshape(x.shape), scales.reshape(x.shape[:-1])


def dequantize_kv_heads(
    q: torch.Tensor, scales: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_heads` (up to the wire's rounding). A
    CPU tensor runs the plain version; a CUDA tensor launches kernel 5 at
    ``block = head_dim`` on the flat payload (one launch)."""
    hd = _check_heads(q, "q")
    if tuple(scales.shape) != tuple(q.shape[:-1]):
        raise ValueError(f"scales of shape {tuple(scales.shape)} for a "
                         f"payload of shape {tuple(q.shape)}")
    if _check_device(q) == "cpu":
        return dequantize_kv_heads_reference(q, scales, out_dtype)
    out = dequantize_blockwise(q.contiguous().reshape(-1),
                               scales.contiguous().reshape(-1), hd)
    return out.reshape(q.shape).to(out_dtype)


# -- fp8 training compute ---------------------------------------------------
#
# Training matmuls on e4m3 operands (e5m2 for the incoming gradient in the
# backward pass) under per-tensor *delayed* scales: each tensor's scale comes
# from a short ring of past max-abs values, so the cast needs nothing from
# the host. The helpers below are the scale algebra; ops/fp8.py wires them
# into the training matmul with its state as parameters.

E4M3_MAX = 448.0  # max finite of float8_e4m3fn
E5M2_MAX = 57344.0  # max finite of float8_e5m2
_device_consts = {}


def _const(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as an fp32 scalar on ``device``, made once per device:
    torch on the card turns a division by a host scalar into a multiply by
    its reciprocal, an ulp off the JAX package's division."""
    key = (value, device)
    t = _device_consts.get(key)
    if t is None:
        t = torch.tensor(value, dtype=torch.float32, device=device)
        _device_consts[key] = t
    return t


def fp8_scale_from_history(hist: torch.Tensor, qmax: float) -> torch.Tensor:
    """Delayed per-tensor scale from an amax history ring: the ring's
    running max mapped onto ``qmax``, a device scalar. An all-zero (fresh)
    ring gives scale 1 -- the first step casts unscaled and seeds the
    ring."""
    amax = hist.max()
    return torch.where(amax > 0, amax / _const(qmax, hist.device),
                       torch.ones_like(amax)).to(SCALE_DTYPE)


def fp8_push_amax(hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Roll the ring one slot and record ``amax(x)`` at slot 0 (a new
    tensor): the delayed-scaling state update."""
    amax = x.detach().abs().amax().to(hist.dtype)
    return torch.cat([amax.reshape(1), hist[:-1]])


def fp8_saturating_cast(
    x: torch.Tensor, scale: torch.Tensor, wire_dtype: torch.dtype, qmax: float
) -> torch.Tensor:
    """``x / scale`` clipped into the wire dtype's finite range, then cast
    (round to nearest even). Saturation, not overflow to inf/NaN, is what
    makes a stale delayed scale a graceful error instead of a poisoned
    step; NaN stays NaN."""
    y = x.detach().to(torch.float32, copy=True).div_(scale)
    return y.clamp_(-qmax, qmax).to(wire_dtype)


def _fp8_qmax(wire_dtype: torch.dtype) -> float:
    """The largest finite magnitude of an fp8 wire dtype."""
    if wire_dtype == torch.float8_e4m3fn:
        return E4M3_MAX
    if wire_dtype == torch.float8_e5m2:
        return E5M2_MAX
    raise TypeError(f"fp8 casts write float8_e4m3fn or float8_e5m2, not "
                    f"{wire_dtype}")


class Fp8Cast(NamedTuple):
    """What one delayed-scaling cast of a 2-D tensor ``x [R, C]`` gives:
    the payload ``q [R, C]`` and its transpose ``qt [C, R]`` (None unless
    asked for), the pushed amax ring, the fp32 scale the cast divided by (a
    device scalar) and, in weight mode, the new fp32 residual."""

    q: torch.Tensor
    qt: Optional[torch.Tensor]
    history: torch.Tensor
    scale: torch.Tensor
    residual: Optional[torch.Tensor]


def _check_cast(x: torch.Tensor, history: torch.Tensor, residual) -> None:
    if x.dim() != 2:
        raise ValueError(f"fp8_cast takes a 2-D tensor, got {tuple(x.shape)}")
    if history.dim() != 1 or history.numel() < 1:
        raise ValueError(f"the amax ring must be 1-D and non-empty, got "
                         f"{tuple(history.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"the residual {tuple(residual.shape)} must have x's "
                         f"shape {tuple(x.shape)}")
    for name, t in (("history", history), ("residual", residual)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def fp8_cast_reference(
    x: torch.Tensor,
    history: torch.Tensor,
    wire_dtype: torch.dtype,
    *,
    transposed: bool = True,
    residual: Optional[torch.Tensor] = None,
) -> Fp8Cast:
    """The plain version of :func:`fp8_cast`: exactly the composition the
    fp8 matmul's casts were written as -- :func:`fp8_scale_from_history`,
    ``v = x`` (or ``x.float() + residual``), :func:`fp8_saturating_cast`,
    ``q.t().contiguous()``, :func:`fp8_push_amax` of ``v`` and the residual
    ``v - q.float() * scale``."""
    _check_cast(x, history, residual)
    qmax = _fp8_qmax(wire_dtype)
    scale = fp8_scale_from_history(history, qmax)
    v = x if residual is None else x.to(torch.float32) + residual
    q = fp8_saturating_cast(v, scale, wire_dtype, qmax)
    new_res = (None if residual is None else
               (v - q.to(torch.float32) * scale).to(residual.dtype))
    return Fp8Cast(q, q.t().contiguous() if transposed else None,
                   fp8_push_amax(history, v), scale, new_res)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _payload(rows: int, cols: int, dtype, device) -> torch.Tensor:
    """An uninitialised ``[rows, cols]`` payload whose rows start on 16-byte
    boundaries (a row stride of ``cols`` rounded up to 16): the layout the
    TMA loads of kernel 8 take."""
    padded = _round16(cols)
    out = torch.empty((rows, padded), dtype=dtype, device=device)
    return out if padded == cols else out[:, :cols]


def _launch_on(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream, with the device
    made current around the launch when it is not already: the fp8 path's
    launches are short, so their host time counts."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


_cast_ws = {}


def _cast_workspace(device: torch.device, stream: int) -> torch.Tensor:
    """Two zeroed words a device and stream (the amax bits and the block
    ticket): each cast kernel leaves them zero for the next."""
    key = (device, stream)
    ws = _cast_ws.get(key)
    if ws is None:
        ws = torch.zeros((2,), dtype=torch.int32, device=device)
        _cast_ws[key] = ws
    return ws


def _launch_cast(x, ldx, in_kind, *, q=None, qt=None, history=None,
                 residual=None, wire_dtype=None):
    """One launch of ``hvt_fp8_cast``; returns (new ring, scale, new
    residual), None each in byte mode."""
    rows, cols = x.shape
    new_hist = scale = new_res = None
    if history is not None:
        # The new ring and the scale in one allocation.
        state = torch.empty((history.numel() + 1,), dtype=torch.float32,
                            device=x.device)
        new_hist, scale = state[:-1], state[-1]
        if residual is not None:
            new_res = torch.empty_like(residual)
    e5m2 = int(wire_dtype == torch.float8_e5m2)
    qmax = _fp8_qmax(wire_dtype) if wire_dtype is not None else 0.0
    fn = _kernel("hvt_fp8_cast")

    def ptr(t):
        return None if t is None else t.data_ptr()

    def call(stream):
        ws = None if history is None else _cast_workspace(x.device, stream)
        return fn(x.data_ptr(), ldx, ptr(residual), ptr(new_res),
                  ptr(history), ptr(new_hist), ptr(scale), ptr(q),
                  q.stride(0) if q is not None else 0, ptr(qt),
                  qt.stride(0) if qt is not None else 0, ptr(ws), rows, cols,
                  history.numel() if history is not None else 0, qmax,
                  in_kind, e5m2, stream)

    rc = _launch_on(x.device, call)
    if rc != 0:
        raise RuntimeError(f"fp8_cast kernel launch failed with cudaError_t {rc}")
    return new_hist, scale, new_res


def fp8_cast(
    x: torch.Tensor,
    history: torch.Tensor,
    wire_dtype: torch.dtype,
    *,
    transposed: bool = True,
    residual: Optional[torch.Tensor] = None,
) -> Fp8Cast:
    """The delayed-scaling cast of ``x [R, C]`` to ``wire_dtype``
    (``float8_e4m3fn``, or ``float8_e5m2`` for gradients) under the scale
    of the amax ring ``history``, in one pass.

    Returns :class:`Fp8Cast`: the payload row-major and, with
    ``transposed``, transposed too, the ring with ``amax(|v|)`` pushed at
    slot 0, the scale, and -- with ``residual`` (weight mode: ``v = x.float() +
    residual``) -- the new residual ``v - q.float() * scale``. CPU tensors
    run :func:`fp8_cast_reference`. CUDA tensors launch ``csrc/fp8_cast.cu``
    or raise: ``x`` bf16 or fp32 with unit inner stride, the ring and the
    residual contiguous fp32; each payload's rows start on 16-byte
    boundaries (a padded row stride), bit for bit the plain version's."""
    _check_cast(x, history, residual)
    if _check_device(x) == "cpu":
        return fp8_cast_reference(x, history, wire_dtype,
                                  transposed=transposed, residual=residual)
    _fp8_qmax(wire_dtype)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the fp8 cast kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    r, c = x.shape
    if r == 0 or c == 0:
        raise ValueError(f"the fp8 cast kernel takes a non-empty tensor, got "
                         f"{tuple(x.shape)}")
    if c > 1 and x.stride(1) != 1:
        raise ValueError(f"the fp8 cast kernel reads x with unit inner "
                         f"stride; got strides {tuple(x.stride())}")
    _check_kernel_input(history, "history", torch.float32)
    if residual is not None:
        _check_kernel_input(residual, "residual", torch.float32)
    # Separate allocations: the training path saves only one of the two.
    q = _payload(r, c, wire_dtype, x.device)
    qt = _payload(c, r, wire_dtype, x.device) if transposed else None
    new_hist, scale, new_res = _launch_cast(
        x, x.stride(0) if r > 1 else c, int(x.dtype == torch.bfloat16),
        q=q, qt=qt, history=history, residual=residual,
        wire_dtype=wire_dtype)
    _count_launch("fp8_cast")
    return Fp8Cast(q, qt, new_hist, scale, new_res)


def _check_fp8_operands(x_q: torch.Tensor, w_q: torch.Tensor):
    if x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError(
            f"fp8_matmul takes 2-D operands, got {tuple(x_q.shape)} and "
            f"{tuple(w_q.shape)}"
        )
    if x_q.shape[1] != w_q.shape[0]:
        raise ValueError(
            f"fp8_matmul shapes disagree: x {tuple(x_q.shape)} vs w "
            f"{tuple(w_q.shape)}"
        )
    for name, t in (("x_q", x_q), ("w_q", w_q)):
        if t.dtype not in (torch.float8_e4m3fn, torch.float8_e5m2):
            raise TypeError(
                f"fp8_matmul takes float8_e4m3fn or float8_e5m2 operands; "
                f"{name} is {t.dtype}"
            )


def _scale_tensor(scale, device: torch.device) -> torch.Tensor:
    if (isinstance(scale, torch.Tensor) and scale.dim() == 0
            and scale.dtype == torch.float32 and scale.device == device):
        return scale
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if scale.numel() != 1:
        raise ValueError(f"fp8_matmul takes one scale, got shape "
                         f"{tuple(scale.shape)}")
    return scale.reshape(())


def fp8_matmul_reference(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale,
    *,
    out_dtype: torch.dtype = torch.float32,
    scale_b=None,
) -> torch.Tensor:
    """The plain version: ``(x_q[M, K] @ w_q[K, N]) * scale`` (times
    ``scale_b`` when given, the two scales multiplied first) with the fp8
    operands upcast to fp32 (every product exact) and fp32 sums, in
    ``out_dtype``. Any strides."""
    _check_fp8_operands(x_q, w_q)
    acc = torch.matmul(x_q.to(torch.float32), w_q.to(torch.float32))
    s = _scale_tensor(scale, acc.device)
    if scale_b is not None:
        s = s * _scale_tensor(scale_b, acc.device)
    return (acc * s).to(out_dtype)


def _kmajor(t: torch.Tensor, contract_dim: int, name: str):
    """``(storage, row stride)`` of operand ``t`` as kernel 8 reads it:
    ``[rows, K]`` with k contiguous and rows on 16-byte boundaries. ``t``
    itself when it is laid out so; otherwise one copy through the cast
    kernel's byte mode (transposing when ``t`` is contiguous along its other
    dim), counted in ``launches_fp8_relayout``."""
    other = 1 - contract_dim
    rows, k = t.shape[other], t.shape[contract_dim]
    k_major = t.stride(contract_dim) == 1 or k == 1
    ld = t.stride(other) if rows > 1 else _round16(k)
    if k_major and ld % 16 == 0 and ld >= k and t.data_ptr() % 16 == 0:
        return t, ld
    if k_major:  # rows misaligned: copy them onto 16-byte boundaries
        src = t if contract_dim == 1 else t.t()
        out = _payload(rows, k, t.dtype, t.device)
        _launch_cast(src, src.stride(0) if rows > 1 else k, 2, q=out)
    elif t.stride(other) == 1 or rows == 1:  # contiguous along rows
        src = t.t() if contract_dim == 1 else t
        out = _payload(rows, k, t.dtype, t.device)
        _launch_cast(src, src.stride(0) if k > 1 else rows, 2, qt=out)
    else:
        raise ValueError(
            f"fp8_matmul needs one dim of {name} with unit stride; got "
            f"strides {tuple(t.stride())}"
        )
    _count_launch("fp8_relayout")
    return out, out.stride(0)


_sm_counts = {}


def _sm_count(device: torch.device) -> int:
    sms = _sm_counts.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device] = sms
    return sms


def _splits(m: int, n: int, k: int, device: torch.device) -> int:
    """Contraction splits for kernel 8's persistent grid (one block an SM).
    An output of fewer than two rounds of 128 x 128 tiles over a deep
    contraction (K >= 4096) splits 3 ways when the splits fit one round
    (the 768 x 768 weight gradient: 36 tiles, 108 blocks) and 4 ways
    otherwise (144 tiles: 5 rounds of 32 k-tiles in place of 2 of 128);
    every other output takes 1."""
    sms = _sm_count(device)
    tiles = -(-m // 128) * -(-n // 128)
    if k < 4096 or tiles >= 2 * sms:
        return 1
    return 3 if 3 * tiles <= sms else 4


def fp8_matmul(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale,
    *,
    out_dtype: torch.dtype = torch.float32,
    scale_b=None,
) -> torch.Tensor:
    """``[M, K] x [K, N]`` over fp8 operands (``float8_e4m3fn`` or
    ``float8_e5m2``, mixed allowed) with fp32 accumulation and the combined
    per-tensor scale (an fp32 device scalar, times ``scale_b`` when given)
    applied at the end, in ``out_dtype`` (fp32 or bf16 on the card).

    CPU tensors run :func:`fp8_matmul_reference`. CUDA tensors launch
    kernel 8 or raise. The kernel reads K-major operands only (``x_q`` with
    k contiguous, ``w_q`` with k contiguous, i.e. the transposed view of an
    ``[N, K]`` row-major payload), rows on 16-byte boundaries; an operand in
    another layout (contiguous along M or N, or misaligned rows) costs one
    K-major copy first (``launches_fp8_relayout``). :func:`fp8_cast` writes
    the fp8 training path's payloads so that it needs none."""
    _check_fp8_operands(x_q, w_q)
    if w_q.device != x_q.device:
        raise ValueError(f"w_q is on {w_q.device}, x_q on {x_q.device}")
    device = _check_device(x_q)
    if device == "cpu":
        return fp8_matmul_reference(x_q, w_q, scale, out_dtype=out_dtype,
                                    scale_b=scale_b)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the fp8 matmul kernel writes float32 or bfloat16, "
                        f"not {out_dtype}")
    scale = _scale_tensor(scale, x_q.device)
    if scale_b is not None:
        scale_b = _scale_tensor(scale_b, x_q.device)
    m, k = x_q.shape
    n = w_q.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=x_q.device)
    a, lda = _kmajor(x_q, 1, "x_q")
    b, ldb = _kmajor(w_q, 0, "w_q")
    # The kernel's TMA stores need rows on 16-byte boundaries: an N that is
    # not a multiple of 8 gets a padded row stride (a strided view).
    ldc = -(-n // 8) * 8
    out = torch.empty((m, ldc), dtype=out_dtype, device=x_q.device)
    if ldc != n:
        out = out[:, :n]
    splits = _splits(m, n, k, x_q.device)
    ws = (torch.empty((splits, m, ldc), dtype=torch.float32,
                      device=x_q.device) if splits > 1 else None)
    rc = _launch_on(
        x_q.device, _kernel("hvt_fp8_matmul"), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), ws.data_ptr() if ws is not None else None,
        scale.data_ptr(), scale_b.data_ptr() if scale_b is not None else None,
        m, n, k, lda, ldb, ldc, int(x_q.dtype == torch.float8_e5m2),
        int(w_q.dtype == torch.float8_e5m2), int(out_dtype == torch.bfloat16),
        splits, x_q.device.index)
    if rc != 0:
        raise RuntimeError(
            f"fp8_matmul kernel launch failed with cudaError_t {rc}"
        )
    _count_launch("fp8_matmul")
    return out


# -- int8 serving weights -----------------------------------------------------
#
# The serving face of the same codec: a 2-D matmul weight is quantized once
# per checkpoint load with one scale per output channel -- blockwise
# quantization of the [N, K] row-major view with block = K -- and the matmul
# applies the scales in its epilogue (kernel 7), so no dequantized weight
# exists in device memory. Serving matmuls at small batch are bound by the
# weight bytes, which int8 halves against bf16.

_MATMUL_BLOCK_K = 256  # K-tile of the plain version's blocked accumulation


class QuantizedWeight:
    """One quantized matmul weight: ``q`` int8 ``[K, N]`` and ``scales``
    fp32 ``[N]`` (one per output channel); ``dtype_name`` records the
    original storage dtype for :func:`dequantize_weight`. ``q`` is the
    transposed view of ``[N, K]`` row-major storage, the layout kernel 7
    reads (``q.t()`` is contiguous)."""

    def __init__(self, q: torch.Tensor, scales: torch.Tensor,
                 dtype_name: str = "float32"):
        self.q = q
        self.scales = scales
        self.dtype_name = dtype_name

    @property
    def shape(self):
        return self.q.shape

    def to(self, device) -> "QuantizedWeight":
        """The payload and scales on ``device`` (the layout kept)."""
        return QuantizedWeight(self.q.t().to(device).t(),
                               self.scales.to(device), self.dtype_name)

    def __repr__(self):
        return (f"QuantizedWeight(shape={tuple(self.q.shape)}, "
                f"dtype={self.dtype_name})")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def quantize_weight(w: torch.Tensor, spec: QuantSpec = INT8) -> QuantizedWeight:
    """Quantize a ``[K, N]`` matmul weight with per-output-channel scales:
    :func:`quantize_blockwise` of the ``[N, K]`` row-major flat view at
    ``block = K`` (kernel 4 on a CUDA tensor), so each column's max-abs maps
    onto ``qmax`` and the scales are the codec's per-block scales. Bit for
    bit the JAX package's ``quantize_weight``. An ``nn.Linear``-style
    ``[N, K]`` weight ``v`` goes in as ``v.t()`` (no copy when ``v`` is
    contiguous and fp32)."""
    if w.dim() != 2:
        raise ValueError(f"quantize_weight needs a 2-D weight, got "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    rows = w.t().to(torch.float32).contiguous()
    q_flat, scales = quantize_blockwise(rows.reshape(-1), block=max(k, 1),
                                        spec=spec)
    return QuantizedWeight(q_flat.reshape(n, k).t(), scales,
                           dtype_name=_dtype_name(w.dtype))


def dequantize_weight(w: QuantizedWeight) -> torch.Tensor:
    """``q * scales`` in fp32, cast back to the original storage dtype."""
    return (w.q.to(torch.float32) * w.scales.reshape(1, -1)).to(
        getattr(torch, w.dtype_name))


def quantize_params(tree, spec: QuantSpec = INT8, *, min_size: int = 4096):
    """What ``ServePool(weight_dtype="int8")`` runs once per checkpoint load.

    On a nest of dicts/lists/tuples (a new nest; the input is untouched):
    every 2-D floating tensor of at least ``min_size`` elements becomes a
    :class:`QuantizedWeight`, the JAX package's rule; biases, norms and small
    tensors keep their dtype. On an ``nn.Module`` (quantized in place and
    returned): every ``models.transformer.Dense`` whose weight has at least
    ``min_size`` elements keeps an int8 payload and fp32 scales as buffers
    in place of its floating weight, and its forward runs :func:`qmatmul`;
    embeddings, LayerNorms and the tied head stay floating. A model computing
    in fp8 raises: int8 weights and fp8 compute do not combine."""
    if isinstance(tree, torch.nn.Module):
        from ..models.transformer import Dense

        dense = [m for m in tree.modules() if isinstance(m, Dense)]
        if any(m.fp8 for m in dense):
            raise ValueError(
                "int8 weights cannot combine with compute_dtype='fp8': the "
                "fp8 projections cast their own fp32 weights")
        for m in dense:
            if not m.quantized and m.weight.numel() >= min_size:
                m.quantize_(spec)
        return tree
    from .batching import tree_map

    def fix(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() == 2
                and leaf.is_floating_point() and leaf.numel() >= min_size):
            return quantize_weight(leaf, spec)
        return leaf

    return tree_map(fix, tree)


def _check_int8_operands(x: torch.Tensor, w: QuantizedWeight,
                         bias: Optional[torch.Tensor]) -> None:
    if not isinstance(w, QuantizedWeight):
        raise TypeError(f"int8_weight_matmul takes a QuantizedWeight, got "
                        f"{type(w).__name__}")
    if w.q.dim() != 2 or w.q.dtype != torch.int8:
        raise TypeError(f"the payload must be a 2-D int8 [K, N] tensor, got "
                        f"{w.q.dtype} {tuple(w.q.shape)}")
    if x.dim() < 1 or x.shape[-1] != w.q.shape[0]:
        raise ValueError(f"matmul shapes disagree: x {tuple(x.shape)} vs "
                         f"weight {tuple(w.q.shape)}")
    if w.scales.shape != (w.q.shape[1],):
        raise ValueError(f"{w.q.shape[1]} output columns need as many scales, "
                         f"got shape {tuple(w.scales.shape)}")
    if bias is not None and bias.shape != (w.q.shape[1],):
        raise ValueError(f"{w.q.shape[1]} output columns need as many bias "
                         f"values, got shape {tuple(bias.shape)}")
    for name, t in (("q", w.q), ("scales", w.scales), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"the weight's {name} is on {t.device}, x on "
                             f"{x.device}")


def int8_weight_matmul_reference(
    x: torch.Tensor, w: QuantizedWeight, bias: Optional[torch.Tensor] = None,
    *, block_k: int = _MATMUL_BLOCK_K
) -> torch.Tensor:
    """The plain version, in the JAX package's order: fp32 partial products
    of x against the payload cast to x's dtype (exact for |q| <= 127) over
    ``block_k``-wide K tiles, summed in order, times the column scales, cast
    to ``x.dtype``; then, with ``bias``, ``+ bias.to(x.dtype)`` in x's dtype.
    ``x`` is ``[..., K]``; the result ``[..., N]``."""
    _check_int8_operands(x, w, bias)
    k, n = w.q.shape
    x2 = x.reshape(math.prod(x.shape[:-1]), k)
    acc = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, block_k):
        acc += torch.matmul(
            x2[:, k0:k0 + block_k].to(torch.float32),
            w.q[k0:k0 + block_k].to(x.dtype).to(torch.float32))
    out = (acc * w.scales.to(torch.float32).reshape(1, -1)).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out.reshape(*x.shape[:-1], n)


def _rows_layout(x: torch.Tensor) -> Tuple[int, int, int]:
    """``(rows_inner, stride_outer, stride_inner)`` of the rows of
    ``x [..., K]`` flattened to ``[M, K]``: row ``r`` starts at
    ``(r // rows_inner) * stride_outer + (r % rows_inner) * stride_inner``
    elements. Leading dims that are contiguous with each other merge; x
    must reduce to at most two row dims."""
    dims = []
    for size, stride in zip(x.shape[:-1], x.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == stride * size:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    if not dims:
        return 1, 0, 0
    if len(dims) == 1:
        return dims[0][0], 0, dims[0][1]
    if len(dims) == 2:
        return dims[1][0], dims[0][1], dims[1][1]
    raise ValueError(
        f"int8_weight_matmul reads x in place and takes at most two row "
        f"dims that do not merge; got shape {tuple(x.shape)} strides "
        f"{tuple(x.stride())}")


_INT8_BK = 64  # kernel 7's k tile (a stage)
_int8_plans = {}


def _int8_splits(tiles: int, k: int, device: torch.device) -> Tuple[int, int]:
    """``(splits, k tiles a split)`` of kernel 7's contraction. Fewer than two
    rounds of 128 x 128 tiles over at least 4 k tiles of 64 split so that the
    split tiles fit two rounds, each split at least 2 k tiles, choosing the
    split that needs the fewest rounds times k tiles a round, a split sum
    counting as 2 more (the reduce kernel's launch); e.g. the decode-sized
    products of GPT-2 small (M = 8): 768 -> 2304 splits 6 ways, 3072 -> 768
    16 ways. Every other product takes 1."""
    key = (tiles, k, device)
    plan = _int8_plans.get(key)
    if plan is not None:
        return plan
    sms = _sm_count(device)
    kt = -(-k // _INT8_BK)
    plan, best = (1, kt), -(-tiles // sms) * kt
    if tiles < 2 * sms and kt >= 4:
        for s in range(2, kt // 2 + 1):
            if tiles * s > 2 * sms:
                break
            per = -(-kt // s)
            splits = -(-kt // per)  # no empty split
            cost = -(-(tiles * splits) // sms) * per + 2
            if cost < best:
                plan, best = (splits, per), cost
    _int8_plans[key] = plan
    return plan


_wmaps = {}


def _weight_map(ptr: int, n: int, k: int, ldw: int, dev: int):
    """The encoded TMA map (128 bytes) of an int8 ``[N, K]`` weight at
    ``ptr`` on card ``dev`` with row stride ``ldw``, encoded once: a map
    holds the address, shape and strides and nothing else, so the key is
    safe to reuse."""
    key = (ptr, n, k, ldw)
    buf = _wmaps.get(key)
    if buf is None:
        buf = ctypes.create_string_buffer(128)
        rc = _kernel("hvt_int8_weight_map")(buf, ptr, n, k, ldw, dev)
        if rc != 0:
            raise RuntimeError(
                f"int8_matmul weight map refused (cudaError_t {rc})")
        if len(_wmaps) >= 4096:
            _wmaps.clear()
        _wmaps[key] = buf
    return buf


def _aligned_rows(t: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """A copy of ``t`` as ``[m, k]`` rows on 16-byte boundaries (a padded
    row stride): what TMA reads when ``t``'s own rows are not."""
    unit = 16 // t.element_size()
    out = torch.empty((m, -(-k // unit) * unit), dtype=t.dtype,
                      device=t.device)[:, :k]
    out.copy_(t.reshape(m, k))
    return out


def int8_weight_matmul(x: torch.Tensor, w: QuantizedWeight,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` for ``x [..., K]`` against an int8 ``[K, N]`` weight with
    its column scales applied in the epilogue: fp32 sums, one rounding to
    ``x.dtype``; with ``bias`` (``[N]``), ``+ bias.to(x.dtype)`` added in
    the same epilogue, bit for bit the separate add. The result
    ``[..., N]``.

    CPU tensors run :func:`int8_weight_matmul_reference`. CUDA tensors
    launch kernel 7 or raise: x in bf16 or fp32 with k contiguous, read in
    place through its strides; the payload in :func:`quantize_weight`'s
    layout (``w.q.t()`` with k contiguous); fp32 scales. The bf16 kernel
    reads both operands with TMA, whose rows start on 16-byte boundaries:
    an operand whose base or row strides do not (K not a multiple of 8 or
    16) is copied once onto such rows first, counted once a call in
    ``launches_int8_relayout``. A small output splits its contraction
    (:func:`_int8_splits`), whose sum is a second kernel
    (``launches_int8_matmul_reduce``)."""
    _check_int8_operands(x, w, bias)
    device, dtype = x.device, x.dtype
    if device.type == "cpu":
        return int8_weight_matmul_reference(x, w, bias)
    if device.type != "cuda":
        raise ValueError(f"the int8 matmul runs on cuda or cpu, not "
                         f"{device.type}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the int8 matmul kernel takes bfloat16 or float32 "
                        f"activations, not {dtype}")
    if w.scales.dtype != SCALE_DTYPE or not w.scales.is_contiguous():
        raise TypeError(f"the int8 matmul kernel takes contiguous {SCALE_DTYPE}"
                        f" scales, got {w.scales.dtype}")
    q = w.q
    k, n = q.shape
    # The payload's storage is [N, K]: row stride q.stride(1), k contiguous.
    if k > 1 and q.stride(0) != 1:
        raise ValueError(
            "the int8 matmul kernel reads the weight as [N, K] with k "
            f"contiguous (quantize_weight's layout); got q strides "
            f"{tuple(q.stride())}")
    if k > 1 and x.stride(-1) != 1:
        raise ValueError(f"the int8 matmul kernel reads x with k contiguous; "
                         f"got strides {tuple(x.stride())}")
    lead = x.shape[:-1]
    m = math.prod(lead)
    if bias is not None:
        if bias.dtype != dtype:
            bias = bias.to(dtype)
        if not bias.is_contiguous():
            bias = bias.contiguous()
    if m == 0 or n == 0 or k == 0:
        out = torch.zeros((*lead, n), dtype=dtype, device=device)
        return out if bias is None else out + bias
    out = torch.empty((*lead, n), dtype=dtype, device=device)
    inner, so, si = (m, 0, k) if x.is_contiguous() else _rows_layout(x)
    x_ptr, w_ptr, ldw = x.data_ptr(), q.data_ptr(), q.stride(1) if n > 1 else k
    bf16 = dtype == torch.bfloat16
    dev = device.index
    splits = per = 1
    w_map = ws = None
    if bf16:
        outer = m // inner
        # A row dim of length 1 is never stepped along; another needs a
        # positive stride of whole 16-byte units.
        x_ok = (x_ptr % 16 == 0
                and (outer == 1 or (so > 0 and so % 8 == 0))
                and (inner == 1 or (si > 0 and si % 8 == 0)))
        w_ok = w_ptr % 16 == 0 and ldw % 16 == 0
        if not (x_ok and w_ok):
            if not x_ok:
                x = _aligned_rows(x, m, k)
                x_ptr, inner, so, si = x.data_ptr(), m, 0, x.stride(0)
            if not w_ok:
                wq = _aligned_rows(q.t(), n, k)
                w_ptr, ldw = wq.data_ptr(), wq.stride(0)
            _count_launch("int8_relayout")
        w_map = _weight_map(w_ptr, n, k, ldw, dev)
        tiles = (m // inner) * -(-inner // 128) * -(-n // 128)
        splits, per = _int8_splits(tiles, k, device)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if splits > 1:
        # A workspace of its own a call: the caching allocator reuses it only
        # after this call's kernels on this stream.
        ws = torch.empty((splits, m, n + n % 2), dtype=torch.float32,
                         device=device)
    rc = _kernel("hvt_int8_matmul")(
        x_ptr, w_ptr, w_map, w.scales.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n,
        k, inner, so, si, ldw, int(bf16), splits, per, dev, stream)
    if rc != 0:
        raise RuntimeError(
            f"int8_matmul kernel launch failed with cudaError_t {rc}")
    _count_launch("int8_matmul")
    if splits > 1:
        _count_launch("int8_matmul_reduce")
    return out


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """Quantization-transparent matmul: ``w`` is a plain ``[K, N]`` tensor
    (``x @ w``) or a :class:`QuantizedWeight` (:func:`int8_weight_matmul`).
    An ``infer_fn`` written against this one call serves under any
    ``ServePool(weight_dtype=...)``."""
    if isinstance(w, QuantizedWeight):
        return int8_weight_matmul(x, w)
    return x @ w
