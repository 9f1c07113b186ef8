"""Tensor ops of the port: the CUDA kernels' wrappers and plain versions
(:mod:`.flash_attention`, :mod:`.fused_adamw`, :mod:`.quantization` -- the
blockwise codec, the fused fp8 cast, the fp8 matmul and the int8-weight
matmul -- built by
:mod:`._build`), fp8 training compute (:mod:`.fp8`), collectives, fusion,
compression and request packing (:mod:`.batching`)."""

from .quantization import (  # noqa: F401
    QuantizedWeight,
    dequantize_weight,
    int8_weight_matmul,
    qmatmul,
    quantize_params,
    quantize_weight,
)
