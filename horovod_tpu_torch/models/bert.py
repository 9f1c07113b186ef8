"""BERT encoder -- the port of the JAX package's ``models/bert.py``
(parity target: ``BASELINE.json`` config #3, BERT-base)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from .transformer import Dense, LayerNorm, Transformer, TransformerConfig


@dataclasses.dataclass(frozen=True)
class BertConfig(TransformerConfig):
    vocab_size: int = 30522
    max_len: int = 512
    causal: bool = False
    type_vocab_size: int = 2

    @staticmethod
    def base(**kw) -> "BertConfig":
        return BertConfig(**kw)  # 110M defaults

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        base = dict(
            vocab_size=512, max_len=128, d_model=64, n_heads=4, n_layers=2,
            d_ff=128, causal=False, type_vocab_size=2,
        )
        base.update(kw)
        return BertConfig(**base)


class BertModel(nn.Module):
    """Encoder with an MLM head, or with ``num_labels`` a classifier on the
    pooled ``[CLS]`` position.

    ``attention_mask`` (``[batch, seq]`` of 0/1) masks padded keys as
    ``[B, 1, 1, S]``; a masked batch takes plain attention on every device
    (the flash kernel masks causally only), as in the JAX package.

    The MLM head is ``mlm_dense`` (tanh GELU), ``mlm_ln`` and an fp32
    ``mlm_decoder`` (flax ``Dense(dtype=float32)``: an fp32 product; keep
    TF32 off on the card). ``return_hidden=True`` returns the ``mlm_ln``
    activations instead of the logits, for
    :func:`..ops.losses.fused_cross_entropy` against
    ``mlm_decoder.weight.t()`` and ``mlm_decoder.bias``.

    Built on ``device`` (default: this process's card; pass ``"cpu"`` for
    the CPU)."""

    def __init__(self, cfg: BertConfig, num_labels: Optional[int] = None, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.num_labels = num_labels
        self.encoder = Transformer(cfg, device=device)
        kw = dict(device=device, param_dtype=cfg.param_dtype)
        d = cfg.d_model
        if num_labels is not None:
            self.pooler = Dense(d, d, dtype=cfg.dtype, **kw)
            self.classifier = Dense(d, num_labels, dtype=torch.float32,
                                    device=device, param_dtype=torch.float32)
        else:
            self.mlm_dense = Dense(d, d, dtype=cfg.dtype, **kw)
            self.mlm_ln = LayerNorm(d, dtype=cfg.dtype, device=device)
            self.mlm_decoder = Dense(d, cfg.vocab_size, dtype=torch.float32,
                                     device=device,
                                     param_dtype=torch.float32)

    def forward(self, tokens, *, token_types=None, attention_mask=None,
                return_hidden=False):
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].to(torch.bool)
        h = self.encoder(tokens, token_types=token_types, mask=mask)
        if self.num_labels is not None:
            pooled = torch.tanh(self.pooler(h[:, 0]))
            return self.classifier(pooled)
        x = F.gelu(self.mlm_dense(h), approximate="tanh")
        x = self.mlm_ln(x)
        if return_hidden:
            return x
        return self.mlm_decoder(x)
