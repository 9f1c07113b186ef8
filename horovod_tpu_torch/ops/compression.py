"""Gradient compression: the wire formats of the fused collectives.

The port of the JAX package's ``ops/compression.py``:

* ``Compression.none`` -- the identity;
* ``Compression.bf16`` -- floats cast to bf16 on the wire (fp32's exponent
  range, so no prescale);
* ``Compression.fp16`` -- floats cast to fp16 with a max-abs prescale:
  values are divided by a scale chosen so both the wire values and their
  world-sum fit fp16's range, and the scale is undone at decompression.
  Inside the fused collectives (:mod:`.fusion`) the scale is made
  replica-uniform with one scalar MAX all-reduce per call (a per-rank
  scale cannot be undone after a sum); a standalone ``compress`` uses the
  local max-abs. The scale stays exactly 1 unless some value threatens the
  wire range.

``Compression.int8`` and ``Compression.fp8`` (the blockwise-quantized wire
with error feedback) are not ported yet: using them raises
``NotImplementedError``.
"""

from __future__ import annotations

import torch

# Largest fp16-safe wire magnitude the prescale targets: half of fp16's
# max finite (65504), headroom for the reduction's partial sums.
FP16_SAFE_MAX = 32752.0

_QUANT_SLICE = (
    "the quantized wire (Compression.int8/fp8 with error feedback) is not "
    "ported yet; it arrives with its own slice (blockwise quantize/"
    "dequantize kernels)"
)


class Compressor:
    """Interface: ``compress(tensor) -> (compressed, ctx)``,
    ``decompress(compressed, ctx) -> tensor``."""

    needs_prescale = False
    is_quantized = False

    @staticmethod
    def compress(tensor, scale=None):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """The identity."""

    @staticmethod
    def compress(tensor, scale=None):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None

    @classmethod
    def compress(cls, tensor, scale=None):
        if not tensor.is_floating_point() or tensor.dtype == cls.wire_dtype:
            return tensor, None
        if cls.needs_prescale:
            if scale is None:
                amax = tensor.float().abs().max()
                scale = torch.clamp_min(amax / FP16_SAFE_MAX, 1.0)
            return (tensor / scale).to(cls.wire_dtype), (tensor.dtype, scale)
        return tensor.to(cls.wire_dtype), tensor.dtype

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is None:
            return tensor
        if isinstance(ctx, tuple):
            dtype, scale = ctx
            return tensor.to(dtype) * scale.to(dtype)
        return tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """fp16 wire cast with the max-abs prescale."""

    wire_dtype = torch.float16
    needs_prescale = True


class BF16Compressor(_CastCompressor):
    """bf16 wire cast (fp32's exponent range: no prescale)."""

    wire_dtype = torch.bfloat16


class QuantCompressor(Compressor):
    """Placeholder for the blockwise-quantized wire formats: every use
    raises ``NotImplementedError``."""

    is_quantized = True

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Compression.{self.name}"

    def compress(self, tensor, scale=None):
        raise NotImplementedError(f"Compression.{self.name}: {_QUANT_SLICE}")

    def decompress(self, tensor, ctx):
        raise NotImplementedError(f"Compression.{self.name}: {_QUANT_SLICE}")


def is_quantized(compression) -> bool:
    return getattr(compression, "is_quantized", False)


def require_unquantized(compression) -> None:
    """Raise ``NotImplementedError`` for the quantized wire formats."""
    if is_quantized(compression):
        raise NotImplementedError(f"{compression!r}: {_QUANT_SLICE}")


class Compression:
    """Namespace matching the reference's ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = QuantCompressor("int8")
    fp8 = QuantCompressor("fp8")
