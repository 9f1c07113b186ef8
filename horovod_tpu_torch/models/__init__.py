"""Models of the port."""

from .gpt2 import GPT2Config, GPT2LMModel  # noqa: F401
from .transformer import (  # noqa: F401
    Block,
    MlpBlock,
    MultiHeadAttention,
    Transformer,
    TransformerConfig,
    dot_product_attention,
)
