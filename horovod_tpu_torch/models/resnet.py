"""ResNet family (v1.5) -- the port of the JAX package's
``models/resnet.py``.

Images are ``[B, C, H, W]`` (PyTorch's layout; the JAX package takes NHWC)
and run in ``torch.channels_last`` memory, cuDNN's fast convolution layout
on the card. The convolutions are ``F.conv2d`` (cuDNN), as the JAX package
computes them outside Pallas. The numerics follow flax:

* ``padding="SAME"`` is made explicit (:func:`..ops.conv.same_padding`,
  asymmetric where the total is odd: the 7x7/2 stem at 224 pads (2, 3),
  each 3x3/2 conv (0, 1), the 3x3/2 max-pool (0, 1) with -inf), never
  ``padding=k//2``;
* :class:`BatchNorm` takes fp32 statistics with the fast variance
  ``E[x^2] - E[x]^2`` (clipped at 0), normalizes in fp32 and casts to
  ``dtype``; in training it updates its running statistics as
  ``ra = 0.9 ra + 0.1 batch`` with the **biased** batch variance (where
  ``torch.nn.BatchNorm2d`` takes the unbiased one);
* ``axis_name`` (any value) makes it cross-replica: one allreduce of
  ``(mean, mean of squares)`` over the world through
  :func:`..ops.collectives.allreduce`, as flax's ``pmean`` does, with the
  same average in the backward.

The batch statistics are buffers (``mean``, ``var`` of every
:class:`BatchNorm`) updated in place by a training-mode forward
(``model.train()``); ``model.eval()`` normalizes with them. A train step
over ``torch.func.functional_call(model, params, ...)`` leaves them on the
module, where the reference threads ``batch_stats`` through ``has_aux``;
to checkpoint them, hand ``dict(model.named_buffers())`` to
``init_state(..., extra=)``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from ..ops import actquant as _actquant
from ..ops.collectives import Average, allreduce
from ..ops.conv import conv2d_same, max_pool_same
from ..ops.remat import is_recomputing
from .transformer import Dense


class _SyncMean(torch.autograd.Function):
    """Average over the world, forward and backward (flax ``pmean``: the
    gradient of a mean over ranks is the mean of the cotangents)."""

    @staticmethod
    def forward(ctx, x):
        return allreduce(x, op=Average)

    @staticmethod
    def backward(ctx, g):
        return allreduce(g.contiguous(), op=Average)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding="SAME", dtype=)``: an fp32
    ``[out, in, kh, kw]`` weight cast to ``dtype`` at the op; ``padding``
    ``((lo, hi), (lo, hi))`` replaces SAME where given."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 *, dtype, device, padding=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.zeros((c_out, c_in, kernel, kernel),
                                               device=device))

    def forward(self, x):
        w = self.weight.to(self.dtype)
        if self.padding is None:
            return conv2d_same(x, w, self.stride)
        (t, b), (l, r) = self.padding
        return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=)`` over the
    channel dimension of ``[B, C, H, W]``; cross-replica with ``sync``.
    ``zero_scale`` marks the scale flax initialises to zero (the last norm
    of each residual branch)."""

    def __init__(self, c: int, *, dtype, device, sync: bool = False,
                 momentum: float = 0.9, eps: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.sync = sync
        self.momentum = momentum
        self.eps = eps
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.ones((c,), device=device))
        self.bias = nn.Parameter(torch.zeros((c,), device=device))
        self.register_buffer("mean", torch.zeros((c,), device=device))
        self.register_buffer("var", torch.ones((c,), device=device))

    def forward(self, x):
        xf = x.float()
        if self.training:
            dims = (0, 2, 3)
            stats = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
            if self.sync:
                stats = _SyncMean.apply(stats)
            mean, mean2 = stats[0], stats[1]
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            if not is_recomputing():  # once a step under remat
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = xf - mean[:, None, None]
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = y * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (the stride, v1.5) -> 1x1 x4, with a projection where
    the shape changes."""

    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int, *, conv, norm):
        super().__init__()
        out = filters * self.expansion
        self.conv0 = conv(c_in, filters, 1)
        self.norm0 = norm(filters)
        self.conv1 = conv(filters, filters, 3, stride)
        self.norm1 = norm(filters)
        self.conv2 = conv(filters, out, 1)
        self.norm2 = norm(out, zero_scale=True)
        self.proj = c_in != out or stride != 1
        if self.proj:
            self.conv_proj = conv(c_in, out, 1, stride)
            self.norm_proj = norm(out)

    def forward(self, x):
        y = torch.relu(self.norm0(self.conv0(x)))
        y = torch.relu(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return torch.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 (the stride) -> 3x3, with a projection where the shape
    changes."""

    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int, *, conv, norm):
        super().__init__()
        self.conv0 = conv(c_in, filters, 3, stride)
        self.norm0 = norm(filters)
        self.conv1 = conv(filters, filters, 3)
        self.norm1 = norm(filters, zero_scale=True)
        self.proj = c_in != filters or stride != 1
        if self.proj:
            self.conv_proj = conv(c_in, filters, 1, stride)
            self.norm_proj = norm(filters)

    def forward(self, x):
        y = torch.relu(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return torch.relu(residual + y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """``[N, C, H, W] -> [N, b*b*C, H/b, W/b]``, each b x b spatial block
    packed into channels in the JAX package's order (row, column, then
    channel within the block)."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(
        n, block * block * c, h // block, w // block)


class ResNet(nn.Module):
    """ResNet v1.5; ``axis_name`` (any value) makes every BatchNorm
    cross-replica over the world. ``conv0_space_to_depth`` replaces the
    7x7/2 stem with the equivalent 4x4/1 conv on the 2x2 space-to-depth
    input (padding (1, 2)). Built on ``device`` (default: this process's
    card; pass ``"cpu"`` for the CPU)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 axis_name: Optional[str] = None,
                 conv0_space_to_depth: bool = False, *, in_channels: int = 3,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.conv0_space_to_depth = conv0_space_to_depth
        conv = functools.partial(Conv, dtype=dtype, device=device)
        norm = functools.partial(BatchNorm, dtype=dtype, device=device,
                                 sync=axis_name is not None)
        if conv0_space_to_depth:
            self.conv_init = conv(4 * in_channels, num_filters, 4, 1,
                                  padding=((1, 2), (1, 2)))
        else:
            self.conv_init = conv(in_channels, num_filters, 7, 2)
        self.bn_init = norm(num_filters)
        blocks = []
        c = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(c, num_filters * 2 ** i, stride,
                                        conv=conv, norm=norm))
                c = num_filters * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(c, num_classes, dtype=torch.float32, device=device,
                          param_dtype=torch.float32)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        if self.conv0_space_to_depth:
            x = space_to_depth(x, 2)
        x = torch.relu(self.bn_init(self.conv_init(x)))
        x = max_pool_same(x)
        for block in self.blocks:
            # An int8 activation-storage segment and boundary (a plain call
            # and the identity unless act-quant is active), quantized in
            # NHWC order as the reference's NHWC activations are.
            x = _actquant.boundary(_actquant.segment(block, x), nhwc=True)
        return self.head(x.mean((2, 3)))


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckBlock)
