"""Tensor ops of the port: the CUDA kernels' wrappers and plain versions
(:mod:`.flash_attention`, :mod:`.fused_adamw`, :mod:`.quantization` -- the
blockwise codec and the fp8 matmul -- built by :mod:`._build`), fp8
training compute (:mod:`.fp8`), collectives, fusion, compression and
request packing (:mod:`.batching`)."""
