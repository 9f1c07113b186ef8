"""flax/XLA ``"SAME"`` padding made explicit, shared by the image models
(``models/vit.py``'s patch embedding, ``models/resnet.py``'s convolutions
and max-pool). ``padding=k//2`` is not SAME: where the total padding is
odd, SAME puts the extra element at the high end."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["same_padding", "conv2d_same", "max_pool_same"]


def same_padding(size: int, kernel: int, stride: int):
    """flax/XLA ``"SAME"`` padding of one spatial dimension as ``(low,
    high)``: the output has ``ceil(size / stride)`` positions, and an odd
    total puts the extra element at the high end (the 7x7/2 ResNet stem at
    224 pads (2, 3), a 3x3/2 conv at 56 (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x, weight, stride: int, bias=None):
    """``F.conv2d`` with flax's ``"SAME"`` padding, made explicit with
    ``F.pad`` (an asymmetric pad where the total is odd)."""
    kh, kw = weight.shape[-2:]
    ph = same_padding(x.shape[-2], kh, stride)
    pw = same_padding(x.shape[-1], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, bias, stride=stride)


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2):
    """flax ``nn.max_pool(padding="SAME")``: -inf padding, asymmetric where
    the total is odd."""
    ph = same_padding(x.shape[-2], kernel, stride)
    pw = same_padding(x.shape[-1], kernel, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)
