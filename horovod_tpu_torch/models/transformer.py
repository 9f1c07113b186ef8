"""Shared transformer core (GPT-2, BERT, ViT and the Switch MoE build on
it) -- the port of the JAX package's ``models/transformer.py``.

The numerics follow the flax modules the JAX package builds from:

* every op computes in ``cfg.dtype`` (bf16). Flax keeps fp32 parameters
  and casts them to ``dtype`` at each op. Here the matmul and embedding
  weights are stored in ``cfg.param_dtype``, which defaults to
  ``cfg.dtype``: a serving model stores bf16 weights, so
  ``load_state_dict`` casts an fp32 checkpoint once at load -- the same
  rounding as the cast at each op, done once. A trainer builds with
  ``param_dtype=torch.float32`` (fp32 master weights): ``Dense``, the
  embeddings and the tied head then cast the weight to ``cfg.dtype`` at
  each op, as flax's ``param_dtype``/``dtype`` split does, so the
  gradients reach fp32 parameters. LayerNorm parameters stay fp32;
* LayerNorm takes its statistics in fp32 with flax's epsilon 1e-6 and its
  fast variance ``E[x^2] - E[x]^2``, and applies scale and bias in fp32;
* ``nn.gelu`` is the tanh approximation;
* the embeddings come out in bf16, so the residual stream is bf16;
* plain attention does its softmax in fp32 and rounds the probabilities
  to the compute dtype before PV; the flash kernel rounds ``p`` to V's
  dtype;
* the tied head computes ``x @ wte.T`` in bf16 and only then casts the
  logits to fp32.

Attention takes the flash path (:mod:`..ops.flash_attention`) in the
packed ``[B, S, H*D]`` layout: q, k and v are column slices of one fused
QKV projection, which the kernel reads in place through strides.
``use_flash=None`` takes it on a CUDA device, as the JAX package takes its
Pallas kernel on a TPU, and plain attention on the CPU; ``True`` takes it
on either (CPU tensors run its plain version). On the card the kernel
runs or the wrapper raises (it takes bf16 with head dim 64 or 128): plain
attention runs there only for ``use_flash=False``, an ``attention_fn``, or
a dense ``mask`` (BERT's padding mask), which takes plain attention on
every device, as the JAX package routes it.

``cfg.remat`` checkpoints each block (:func:`..ops.remat.remat_module`):
the backward recomputes the block's forward, flash kernel included.

``compute_dtype="fp8"`` (``None`` reads ``HVDTPU_COMPUTE_DTYPE``) runs every
attention and MLP projection through :class:`..ops.fp8.Fp8Linear`, as the
JAX package injects its ``Fp8DotGeneral``: each ``Dense`` carries the fp8
state parameters (:func:`..ops.fp8.add_fp8_state`) and adds its bias in the
compute dtype after the fp8 product. The fused QKV projection runs three
fp8 products on the three row blocks of its weight (contiguous views), each
with its own state under the JAX package's scope name (``qkv.query.fp8_*``,
``qkv.key.fp8_*``, ``qkv.value.fp8_*``), and hands the flash kernel three
outputs. Embeddings, LayerNorms and the tied head stay in ``dtype``.

Int8 serving weights: :func:`..ops.quantization.quantize_params` on a model
replaces each large ``Dense`` weight with an int8 payload and fp32 column
scales (buffers ``weight_q`` ``[out, in]`` and ``weight_scales``; no floating
copy stays) and its forward runs :func:`..ops.quantization.int8_weight_matmul`
(kernel 7 on the card) with the bias, which the kernel adds in its epilogue
bit for bit as a separate add in ``dtype`` would.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.fp8 import add_fp8_state, fp8_linear, resolve_compute_dtype
from ..ops.quantization import (INT8, QuantizedWeight, int8_weight_matmul,
                                quantize_weight)
from ..ops import actquant as _actquant
from ..ops.remat import remat_module, resolve_policy

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    max_len: int = 1024
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    causal: bool = True
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # Storage dtype of the matmul and embedding weights; None = ``dtype``.
    param_dtype: Optional[torch.dtype] = None
    # Per-block rematerialization: False/"none" (off), True/"full", a named
    # policy ("dots_saveable" keeps the matmul outputs and recomputes the
    # elementwise chains) or a custom policy callable -- one knob shared
    # with make_train_step(remat=...) through ops/remat.resolve_policy.
    remat: Any = False
    # Training matmul precision: None (HVDTPU_COMPUTE_DTYPE decides at
    # construction), ""/"off" (``dtype``) or "fp8" (ops/fp8.Fp8Linear in
    # every attention and MLP projection, its state in the parameters).
    compute_dtype: Optional[str] = None
    type_vocab_size: int = 0
    # Flash-attention kernel: None = auto (on for CUDA tensors), True =
    # always, False = plain attention.
    use_flash: Optional[bool] = None

    def check_supported(self) -> None:
        resolve_policy(self.remat)  # a typo raises, as in the JAX package
        resolve_compute_dtype(self.compute_dtype)
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model={self.d_model} is not a multiple of "
                f"n_heads={self.n_heads}"
            )

    @property
    def weight_dtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @property
    def fp8(self) -> bool:
        """Whether the projections compute in fp8 (``compute_dtype``
        resolved now: ``None`` reads ``HVDTPU_COMPUTE_DTYPE``)."""
        return resolve_compute_dtype(self.compute_dtype) == "fp8"


def dot_product_attention(q, k, v, *, causal: bool, mask=None):
    """Plain attention on ``[B, S, H, D]``; softmax in fp32, probabilities
    rounded to the compute dtype before PV (the JAX package's
    ``dot_product_attention``). ``mask`` is a boolean tensor broadcast
    against the ``[B, H, Sq, Sk]`` scores (BERT's padding mask is
    ``[B, 1, 1, Sk]``); a masked score becomes -1e30."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        qlen, klen = scores.shape[-2], scores.shape[-1]
        cmask = torch.ones(
            (qlen, klen), dtype=torch.bool, device=q.device
        ).tril()
        scores = scores.masked_fill(~cmask, -1e30)
    if mask is not None:
        scores = scores.masked_fill(~mask.to(torch.bool), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _factory(device, dtype):
    return {"device": device, "dtype": dtype}


class Dense(nn.Module):
    """``y = x W^T + b`` computed in ``dtype`` (flax ``nn.Dense(dtype=)``);
    ``weight`` is ``[out, in]``, stored in ``param_dtype`` (default
    ``dtype``) and cast to ``dtype`` at the op.

    ``splits`` names the equal row blocks of a fused projection
    (:meth:`parts` returns them). With ``fp8=True`` the product runs through
    :class:`..ops.fp8.Fp8Linear` and the bias is added after it in
    ``dtype``; the fp8 state sits on the module itself, or on one child per
    split (named after it) with one fp8 product per block. After
    :meth:`quantize_` the weight is an int8 payload with column scales and
    the product and the bias run through
    :func:`..ops.quantization.int8_weight_matmul`."""

    def __init__(self, d_in: int, d_out: int, *, dtype, device,
                 param_dtype=None, fp8: bool = False, splits=()):
        super().__init__()
        self.dtype = dtype
        self.fp8 = fp8
        self.splits = tuple(splits)
        self.d_out = d_out
        fac = _factory(device, param_dtype or dtype)
        self.weight = nn.Parameter(torch.zeros((d_out, d_in), **fac))
        self.bias = nn.Parameter(torch.zeros((d_out,), **fac))
        if fp8 and self.splits:
            rows = d_out // len(self.splits)
            for name in self.splits:
                state = nn.Module()
                add_fp8_state(state, (rows, d_in), device=device)
                self.add_module(name, state)
        elif fp8:
            add_fp8_state(self, (d_out, d_in), device=device)

    @property
    def quantized(self) -> bool:
        return "weight_q" in self._buffers

    def quantize_(self, spec=INT8) -> None:
        """Replace the floating weight with its int8 payload (``weight_q``,
        ``[out, in]``) and fp32 column scales (``weight_scales``), quantized
        from the weight as stored (:func:`..ops.quantization.
        quantize_weight`); buffers, so ``.to()``, ``deepcopy`` and
        ``state_dict`` carry them."""
        qw = quantize_weight(self.weight.detach().t(), spec)
        self.weight_dtype_name = qw.dtype_name
        del self.weight
        self.register_buffer("weight_q", qw.q.t())
        self.register_buffer("weight_scales", qw.scales)

    def quantized_weight(self) -> QuantizedWeight:
        return QuantizedWeight(self.weight_q.t(), self.weight_scales,
                               self.weight_dtype_name)

    def forward(self, x):
        if self.fp8 and self.splits:
            return torch.cat(self.parts(x), dim=-1)
        x, b = x.to(self.dtype), self.bias.to(self.dtype)
        if self.quantized:  # the bias rides kernel 7's epilogue
            return int8_weight_matmul(x, self.quantized_weight(), b)
        w = self.weight.to(self.dtype)
        if self.fp8:
            return fp8_linear(x, w, self) + b
        return F.linear(x, w, b)

    def parts(self, x):
        """The output's row blocks of ``splits``: column views of one product,
        or with fp8 one product per block, each on its own state."""
        if not self.fp8:
            return self(x).split(self.d_out // len(self.splits), dim=-1)
        x, w, b = x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(
            self.dtype)
        rows = w.shape[0] // len(self.splits)
        return [
            fp8_linear(x, w[i * rows:(i + 1) * rows], getattr(self, name))
            + b[i * rows:(i + 1) * rows]
            for i, name in enumerate(self.splits)
        ]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=)``: fp32 statistics (fast variance),
    epsilon 1e-6, fp32 scale and bias, output in ``dtype``."""

    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones((d,), device=device))
        self.bias = nn.Parameter(torch.zeros((d,), device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.scale.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


def _replicated(t, mesh):
    """``t`` as a DTensor replicated over ``mesh`` (None and DTensors pass)."""
    from torch.distributed.tensor import DTensor, Replicate

    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig,
                 attention_fn: Optional[Callable] = None, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.attention_fn = attention_fn
        kw = dict(dtype=cfg.dtype, device=resolve_device(device),
                  param_dtype=cfg.param_dtype, fp8=cfg.fp8)
        # Fused query/key/value projection: rows [0, D) are the query,
        # [D, 2D) the key, [2D, 3D) the value (convert.py builds it from
        # the three flax DenseGeneral kernels).
        self.qkv = Dense(cfg.d_model, 3 * cfg.d_model,
                         splits=("query", "key", "value"), **kw)
        self.out = Dense(cfg.d_model, cfg.d_model, **kw)

    def forward(self, x, mask=None):
        if not self.qkv.quantized and self.qkv.weight.dim() == 3:
            return self._forward_local_heads(x, mask)
        # Column slices of the fused output (strided [B, S, H*dh] views), or
        # with fp8 three outputs of their own.
        q, k, v = self.qkv.parts(x)
        return self.out(self._attend(q, k, v, self.cfg.n_heads, mask))

    def _attend(self, q, k, v, h, mask):
        """Attention over the ``h`` heads of ``[B, S, h*dh]`` q, k and v;
        returns ``[B, S, h*dh]``."""
        cfg = self.cfg
        b, s, width = q.shape
        dh = width // h
        attn = self.attention_fn
        if attn is None:
            use_flash = cfg.use_flash
            if use_flash is None:
                use_flash = q.device.type == "cuda"
            # A dense mask takes plain attention on every device: the
            # kernel masks causally only (the JAX package routes the same).
            if use_flash and mask is None:
                return flash_attention(
                    q, k, v, causal=cfg.causal, layout="bsm", n_heads=h
                )
            attn = dot_product_attention
        y = attn(
            q.unflatten(-1, (h, dh)), k.unflatten(-1, (h, dh)),
            v.unflatten(-1, (h, dh)), causal=cfg.causal, mask=mask,
        )
        return y.reshape(b, s, width)

    def _forward_local_heads(self, x, mask):
        """The forward with the fused projection sharded on heads as a
        DTensor (``parallel.gspmd.shard_params``: weight ``[3, H*dh, D]``,
        bias ``[3, H*dh]``, both sharded on dim 1) and ``x`` a replicated
        DTensor. DTensor has no rule for the attention kernels, so each
        rank runs the projection and the attention on its local heads,
        re-enters with ``Shard(-1)``, and the row-parallel ``out`` leaves a
        ``Partial`` that DTensor all-reduces. ``x``'s gradient is partial
        over the mesh dimensions that shard the heads (Megatron's identity
        forward, all-reduce backward)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.distributed.tensor import Shard

        if self.cfg.fp8:
            raise NotImplementedError(
                "head-sharded attention runs the bf16/fp32 projections only")
        w, b = self.qkv.weight, self.qkv.bias
        heads_sharded = [isinstance(p, Shard) for p in w.placements]
        x_loc = x.to_local(grad_placements=[
            Partial() if hs else Replicate() for hs in heads_sharded])
        w_loc, b_loc = w.to_local(), b.to_local()
        rows = w_loc.shape[1]
        dt = self.qkv.dtype
        qkv = F.linear(x_loc.to(dt), w_loc.reshape(3 * rows, -1).to(dt),
                       b_loc.reshape(-1).to(dt))
        q, k, v = qkv.split(rows, dim=-1)
        h = rows // (self.cfg.d_model // self.cfg.n_heads)
        y = self._attend(q, k, v, h, mask)
        y = DTensor.from_local(
            y, w.device_mesh,
            [Shard(y.dim() - 1) if hs else Replicate()
             for hs in heads_sharded])
        return self.out(y)


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=resolve_device(device),
                  param_dtype=cfg.param_dtype, fp8=cfg.fp8)
        self.fc = Dense(cfg.d_model, cfg.d_ff, **kw)
        self.proj = Dense(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x):
        return self.proj(F.gelu(self.fc(x), approximate="tanh"))


class Block(nn.Module):
    """Pre-LN transformer block (GPT-2 style)."""

    def __init__(self, cfg: TransformerConfig,
                 attention_fn: Optional[Callable] = None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.ln_1 = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.attn = MultiHeadAttention(cfg, attention_fn, device=device)
        self.ln_2 = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.mlp = MlpBlock(cfg, device=device)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """Token + position embeddings -> N blocks -> final LN; returns hidden
    states ``[batch, seq, d_model]``, or with ``lm_head`` fp32 logits from
    the tied head (``x @ wte.T`` in the compute dtype)."""

    def __init__(self, cfg: TransformerConfig,
                 attention_fn: Optional[Callable] = None,
                 lm_head: bool = False, *, device=None):
        super().__init__()
        cfg.check_supported()
        device = resolve_device(device)
        self.cfg = cfg
        self.lm_head = lm_head
        fac = _factory(device, cfg.weight_dtype)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, **fac)
        self.wpe = nn.Embedding(cfg.max_len, cfg.d_model, **fac)
        self.wtt = (
            nn.Embedding(cfg.type_vocab_size, cfg.d_model, **fac)
            if cfg.type_vocab_size else None
        )
        block = remat_module(Block, cfg.remat)
        self.blocks = nn.ModuleList(
            block(cfg, attention_fn, device=device)
            for _ in range(cfg.n_layers)
        )
        self.ln_f = LayerNorm(cfg.d_model, dtype=cfg.dtype, device=device)

    def forward(self, tokens, *, token_types=None, mask=None,
                return_hidden=False):
        dt = self.cfg.dtype
        wte = self.wte.weight.to(dt)  # one cast, shared with the tied head
        pos = torch.arange(tokens.shape[-1], device=tokens.device)
        if hasattr(wte, "device_mesh"):
            # Parameters placed as DTensors (parallel.gspmd): the indices
            # join them replicated.
            tokens, pos, token_types = (
                _replicated(t, wte.device_mesh)
                for t in (tokens, pos, token_types))
        x = F.embedding(tokens, wte)
        x = x + F.embedding(pos, self.wpe.weight.to(dt))
        if self.wtt is not None and token_types is not None:
            x = x + F.embedding(token_types, self.wtt.weight.to(dt))
        for block in self.blocks:
            # An int8 activation-storage segment and boundary (a plain call
            # and the identity unless act-quant is active; ops/actquant.py).
            x = _actquant.boundary(_actquant.segment(block, x, mask))
        x = self.ln_f(x)
        if self.lm_head and not return_hidden:
            return F.linear(x, wte).float()
        return x
