"""Models of the port: the JAX package's zoo (GPT-2, BERT, ViT, the MLP,
ResNet and the Switch MoE) as ``nn.Module``s."""

from .bert import BertConfig, BertModel  # noqa: F401
from .gpt2 import GPT2Config, GPT2LMModel  # noqa: F401
from .mlp import MLP  # noqa: F401
from .moe import MoEConfig, SwitchTransformerLM  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from .transformer import (  # noqa: F401
    Block,
    MlpBlock,
    MultiHeadAttention,
    Transformer,
    TransformerConfig,
    dot_product_attention,
)
from .vit import ViT, ViTConfig  # noqa: F401
