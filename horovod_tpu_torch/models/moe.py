"""Switch-Transformer MoE language model -- the port of the JAX package's
``models/moe.py``.

The FFN of every ``moe_every``-th block is a top-1-routed mixture of
experts (:func:`..parallel.ep.top1_dispatch`); the experts live on one card
as stacked ``[E, D, F]`` and ``[E, F, D]`` tensors, and each einsum runs
every expert at once as one batched product. Attention is the shared
:class:`.transformer.MultiHeadAttention`, so it takes the flash kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from ..context import resolve_device
from ..ops import actquant as _actquant
from ..ops.remat import remat_module
from ..parallel.ep import top1_dispatch
from .transformer import LayerNorm, MlpBlock, MultiHeadAttention, TransformerConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    num_experts: int = 8
    capacity_factor: float = 1.25
    # every `moe_every`-th block uses the MoE FFN (Switch: every other).
    moe_every: int = 2
    aux_loss_weight: float = 0.01


class SwitchFFN(nn.Module):
    """Top-1 MoE feed-forward: route, run every expert as one stacked
    product, combine. The gate and the experts are fp32 parameters; the
    gate logits are fp32, the experts compute in the input's dtype.
    Returns ``(out, aux_loss)``."""

    def __init__(self, cfg: MoEConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.gate = nn.Parameter(torch.zeros((d, e), device=device))
        self.expert_in = nn.Parameter(torch.zeros((e, d, f), device=device))
        self.expert_out = nn.Parameter(torch.zeros((e, f, d), device=device))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, d = x.shape
        t = b * s
        tokens = x.reshape(t, d)
        capacity = int(math.ceil(t / cfg.num_experts * cfg.capacity_factor))
        gate_logits = tokens.float() @ self.gate
        dispatch, combine, aux = top1_dispatch(gate_logits, capacity)
        dt = x.dtype
        # Bin tokens per expert, run every expert in one batched product.
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), tokens)
        h = torch.relu(torch.einsum("ecd,edf->ecf", expert_in,
                                    self.expert_in.to(dt)))
        expert_out = torch.einsum("ecf,efd->ecd", h, self.expert_out.to(dt))
        out = torch.einsum("tec,ecd->td", combine.to(dt), expert_out)
        return out.reshape(b, s, d), aux


class MoEBlock(nn.Module):
    """Pre-LN block whose FFN is a :class:`SwitchFFN` (``use_moe``) or a
    dense :class:`.transformer.MlpBlock`; returns ``(x, aux_loss)``."""

    def __init__(self, cfg: MoEConfig, use_moe: bool, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.use_moe = use_moe
        self.ln_1 = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.attn = MultiHeadAttention(cfg, device=device)
        self.ln_2 = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        if use_moe:
            self.moe = SwitchFFN(cfg, device=device)
        else:
            self.mlp = MlpBlock(cfg, device=device)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        y = self.ln_2(x)
        if self.use_moe:
            ff, aux = self.moe(y)
        else:
            ff = self.mlp(y)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + ff, aux


class SwitchTransformerLM(nn.Module):
    """Decoder-only LM with MoE FFNs every ``moe_every`` blocks (``moe_every
    = 1``: every block). ``forward`` returns ``(logits, aux_loss)``: fp32
    logits from the tied ``wte`` (an fp32 product) and the summed Switch
    load-balancing loss; add ``cfg.aux_loss_weight * aux_loss`` to the
    training loss. ``cfg.remat`` checkpoints each block. Built on
    ``device`` (default: this process's card; pass ``"cpu"`` for the
    CPU)."""

    def __init__(self, cfg: MoEConfig, *, device=None):
        super().__init__()
        cfg.check_supported()
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Parameter(torch.zeros((cfg.vocab_size, cfg.d_model),
                                            device=device))
        self.wpe = nn.Parameter(torch.zeros((cfg.max_len, cfg.d_model),
                                            device=device))
        block = remat_module(MoEBlock, cfg.remat)
        self.blocks = nn.ModuleList(
            block(cfg, self.uses_moe(cfg, i), device=device)
            for i in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)

    @staticmethod
    def uses_moe(cfg: MoEConfig, i: int) -> bool:
        """Whether block ``i`` takes the MoE FFN (Switch interleaves)."""
        return cfg.moe_every > 0 and i % cfg.moe_every == cfg.moe_every - 1

    def forward(self, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        s = tokens.shape[1]
        x = (self.wte[tokens] + self.wpe[None, :s]).to(self.cfg.dtype)
        total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in self.blocks:
            # An int8 activation-storage segment and boundary (a plain call
            # and the identity unless act-quant is active).
            x, aux = _actquant.segment(block, x)
            x = _actquant.boundary(x)
            total_aux = total_aux + aux
        x = self.ln_f(x)
        logits = x.float() @ self.wte.t()
        return logits, total_aux
