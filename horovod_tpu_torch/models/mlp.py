"""Small MLP classifier -- the port of the JAX package's ``models/mlp.py``
(the ``keras_mnist.py`` analog of reference config #1 in
``BASELINE.json``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..context import resolve_device
from ..ops import actquant as _actquant
from .transformer import Dense


class MLP(nn.Module):
    """``features`` hidden ``Dense`` + ReLU layers and a ``num_classes``
    head, all computing in ``dtype`` (flax ``nn.Dense(dtype=)``): the input
    is flattened past its batch dimension and cast to ``dtype``. The
    weights are stored fp32 (flax's parameters) and cast at each op. The
    flattened input size is given at construction (``in_features``), where
    flax infers it at ``init``.

    Built on ``device`` (default: this process's card; pass ``"cpu"`` for
    the CPU)."""

    def __init__(self, features: Sequence[int] = (128, 128),
                 num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 *, in_features: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        widths = [in_features, *features]
        kw = dict(dtype=dtype, device=device, param_dtype=torch.float32)
        self.hidden = nn.ModuleList(
            Dense(a, b, **kw) for a, b in zip(widths[:-1], widths[1:]))
        self.head = Dense(widths[-1], num_classes, **kw)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for dense in self.hidden:
            # An int8 activation-storage segment and boundary (a plain call
            # and the identity unless act-quant is active).
            x = _actquant.boundary(_actquant.segment(
                dense, x, call=lambda t, d=dense: torch.relu(d(t))))
        return self.head(x)
