"""Vision Transformer -- the port of the JAX package's ``models/vit.py``
(parity target: ``BASELINE.json`` config #4, ViT-L).

Images are ``[B, C, H, W]`` (PyTorch's layout; the JAX package takes
``[B, H, W, C]``). The patch embedding is a strided convolution with flax's
``"SAME"`` padding (:func:`..ops.conv.same_padding`: zero when the patch
divides the image, as at 224/16 and 32/8, but computed, not assumed); its
patches are flattened row-major over (h, w), as the JAX package's reshape
of the NHWC output orders them. ``cls`` is zero-initialised,
``pos_embed`` covers the ``cls`` position and every patch, and the fp32
head reads ``x[:, 0]``.

Like the reference, the blocks are plain ``Block``s: ``cfg.remat`` does
not apply to the ViT.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..context import resolve_device
from ..ops import actquant as _actquant
from ..ops.conv import conv2d_same
from .transformer import Block, Dense, LayerNorm, TransformerConfig


@dataclasses.dataclass(frozen=True)
class ViTConfig(TransformerConfig):
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    in_channels: int = 3
    causal: bool = False
    vocab_size: int = 1  # unused
    max_len: int = 1  # unused

    @staticmethod
    def large(**kw) -> "ViTConfig":
        base = dict(d_model=1024, n_heads=16, n_layers=24, d_ff=4096)
        base.update(kw)
        return ViTConfig(**base)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        base = dict(
            image_size=32, patch_size=8, num_classes=10, d_model=64,
            n_heads=4, n_layers=2, d_ff=128,
        )
        base.update(kw)
        return ViTConfig(**base)


class ViT(nn.Module):
    """Patchify (strided conv) -> ``[cls]`` + patches + position embedding
    -> ``n_layers`` pre-LN blocks (non-causal) -> final LN -> fp32 head on
    the ``cls`` position. Built on ``device`` (default: this process's
    card; pass ``"cpu"`` for the CPU)."""

    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        cfg.check_supported()
        device = resolve_device(device)
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.d_model
        wdt = cfg.weight_dtype
        self.patch_weight = nn.Parameter(torch.zeros(
            (d, cfg.in_channels, p, p), device=device, dtype=wdt))
        self.patch_bias = nn.Parameter(torch.zeros(
            (d,), device=device, dtype=wdt))
        n_patches = (-(-cfg.image_size // p)) ** 2
        self.cls = nn.Parameter(torch.zeros((1, 1, d), device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            (1, n_patches + 1, d), device=device))
        self.blocks = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(d, dtype=cfg.dtype, device=device)
        self.head = Dense(d, cfg.num_classes, dtype=torch.float32,
                          device=device, param_dtype=torch.float32)

    def forward(self, images):
        cfg = self.cfg
        dt = cfg.dtype
        x = conv2d_same(images.to(dt), self.patch_weight.to(dt),
                        cfg.patch_size, self.patch_bias.to(dt))
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, d], patches row-major
        cls = self.cls.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for block in self.blocks:
            # An int8 activation-storage segment and boundary (a plain call
            # and the identity unless act-quant is active).
            x = _actquant.boundary(_actquant.segment(block, x))
        x = self.ln_f(x)
        return self.head(x[:, 0])
