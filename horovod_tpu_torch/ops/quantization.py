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

The weight half (``QuantizedWeight`` ... ``qmatmul``, kernel 7), the
KV-head half and the fp8-compute helpers (kernel 8) wait for their slices.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import torch

from ..utils import env as _env
from . import _build

__all__ = [
    "FP8",
    "INT8",
    "QuantSpec",
    "SCALE_DTYPE",
    "default_block",
    "dequantize_blockwise",
    "dequantize_blockwise_reference",
    "launches_dequant",
    "launches_quant",
    "quant_spec",
    "quantize_blockwise",
    "quantize_blockwise_reference",
    "quantized_wire_bytes",
    "reset_launches",
    "supports_fp8",
]

KERNEL_SOURCE = "quant_blockwise"
SCALE_DTYPE = torch.float32
# Past this magnitude round-to-nearest-even lands beyond e4m3's largest
# finite value (448), and e4m3 has no infinity: the value becomes NaN.
_E4M3_OVERFLOW = 464.0

# Kernel launches since import (or the last reset_launches()): each wrapper
# adds one where it launches its kernel and nowhere else.
launches_quant = 0
launches_dequant = 0
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


def reset_launches() -> None:
    global launches_quant, launches_dequant
    with _count_lock:
        launches_quant = 0
        launches_dequant = 0


def _count_launch(which: str) -> None:
    global launches_quant, launches_dequant
    with _count_lock:
        if which == "quant":
            launches_quant += 1
        else:
            launches_dequant += 1


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


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(KERNEL_SOURCE), name)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "hvt_quantize_blockwise":
            fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, ctypes.c_float, ptr]
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
