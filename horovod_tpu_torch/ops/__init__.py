"""Tensor ops of the port: the flash-attention kernel
(:mod:`.flash_attention`, built by :mod:`._build`) and request packing
(:mod:`.batching`)."""
