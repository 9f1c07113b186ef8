"""Gradient compression for the torch frontend.

The port of the JAX package's ``horovod_tpu/torch/compression.py``
(reference ``horovod/torch/compression.py``): ``Compression.none``,
``Compression.fp16`` and ``Compression.bf16`` (fp32's exponent range, so
no loss scaling).
"""

from __future__ import annotations

import torch


class Compressor:
    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        del ctx
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype.is_floating_point and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Compression:
    """Namespace mirroring ``hvd.Compression`` (reference ``compression.py``)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
