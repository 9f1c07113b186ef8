"""GPT-2 language model -- the port of the JAX package's
``models/gpt2.py``."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from torch import nn

from ..context import resolve_device
from .transformer import Transformer, TransformerConfig


@dataclasses.dataclass(frozen=True)
class GPT2Config(TransformerConfig):
    causal: bool = True

    @staticmethod
    def small(**kw) -> "GPT2Config":
        return GPT2Config(**kw)  # 124M defaults from TransformerConfig

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        base = dict(
            vocab_size=512, max_len=128, d_model=64, n_heads=4, n_layers=2,
            d_ff=128,
        )
        base.update(kw)
        return GPT2Config(**base)


class GPT2LMModel(nn.Module):
    """Causal LM with the tied head: ``model(tokens)`` gives fp32 logits
    ``[B, S, vocab]``; ``return_hidden=True`` the final hidden states.

    Built on ``device`` (default: this process's card; raises without
    CUDA -- pass ``device="cpu"`` for the CPU). The matmul and embedding
    weights are stored in ``cfg.param_dtype`` (default ``cfg.dtype``; a
    trainer passes ``torch.float32`` for fp32 master weights, see
    ``transformer.py``); ``cfg.compute_dtype="fp8"`` runs the attention and
    MLP projections in fp8 with their state as ``fp8_*`` parameters;
    ``attention_fn`` replaces the attention path."""

    def __init__(self, cfg: GPT2Config, *, device=None,
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        self.transformer = Transformer(
            cfg, attention_fn, lm_head=True, device=resolve_device(device),
        )

    def forward(self, tokens, *, return_hidden=False):
        return self.transformer(tokens, return_hidden=return_hidden)
