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
  wire range;
* ``Compression.int8`` / ``Compression.fp8`` -- the blockwise-scaled
  quantized wire (:mod:`.quantization`). Quantized values cannot be summed
  on the wire, so the fused collectives (:mod:`.fusion`) lower these to a
  quantized all-to-all, a local fp32 dequantize-and-sum, and a quantized
  all-gather, with optional error feedback; ``compress``/``decompress``
  here are the plain local round trip.
"""

from __future__ import annotations

import torch

from . import quantization as _quant

# Largest fp16-safe wire magnitude the prescale targets: half of fp16's
# max finite (65504), headroom for the reduction's partial sums.
FP16_SAFE_MAX = 32752.0


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
    """Blockwise-scaled quantized wire format (int8/fp8).

    The fused collectives (:mod:`.fusion`) detect these compressors and
    take the quantized transport; ``compress``/``decompress`` are the local
    round trip. ``block`` is the per-scale granularity (None ->
    ``HVDTPU_QUANT_BLOCK``, default 256); ``with_block`` derives a copy with
    the block pinned (the optimizers pin it at construction, so a later env
    change cannot desync the residual layout)."""

    is_quantized = True

    def __init__(self, spec: _quant.QuantSpec, block=None):
        self.spec = spec
        self.block = block

    def __repr__(self):
        return f"Compression.{self.spec.name}(block={self.block_size()})"

    def block_size(self) -> int:
        return self.block if self.block else _quant.default_block()

    def with_block(self, block: int) -> "QuantCompressor":
        return QuantCompressor(self.spec, block=int(block))

    def compress(self, tensor, scale=None):
        shape, dtype = tensor.shape, tensor.dtype
        q, scales = _quant.quantize_blockwise(
            tensor.reshape(-1).float(), self.block_size(), self.spec
        )
        return q, (scales, shape, dtype)

    def decompress(self, tensor, ctx):
        scales, shape, dtype = ctx
        return _quant.dequantize_blockwise(
            tensor, scales, self.block_size(), out_dtype=dtype
        ).reshape(shape)


def is_quantized(compression) -> bool:
    return getattr(compression, "is_quantized", False)


class Compression:
    """Namespace matching the reference's ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = QuantCompressor(_quant.INT8)
    fp8 = QuantCompressor(_quant.FP8)

    @staticmethod
    def by_name(name: str):
        """Resolve ``HVDTPU_QUANT``-style names (``int8``/``fp8``) and the
        cast formats, checking that torch has the fp8 dtypes."""
        table = {
            "none": Compression.none,
            "fp16": Compression.fp16,
            "bf16": Compression.bf16,
            "int8": Compression.int8,
            "fp8": Compression.fp8,
        }
        if name not in table:
            raise ValueError(f"unknown compression {name!r}")
        if name == "fp8":
            _quant.quant_spec("fp8")  # raises when unsupported
        return table[name]
