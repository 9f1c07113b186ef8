"""Paged-attention LM for the token-level decode engine.

The port of the JAX package's ``serve/model.py``. :class:`CacheLM` is the
model the decode engine, its tests and ``chip_smoke.py`` drive: a
multi-head-attention LM whose one forward function, :meth:`CacheLM.extend`,
covers the engine's three shapes by window width alone:

* **prefill** -- window = the prompt bucket, empty cache (``seq_lens=0``);
* **decode** -- window = 1, the cache behind it;
* **verify** -- window = ``spec_k + 1``, the speculative window scored in
  one pass (causal within the window, full over the cache).

The cache is read through the paged pool (:func:`.kvcache.gather_kv`:
block-table indirection, fixed shapes), and the window's K/V go back to the
caller, who scatters them into the pool. The attention is plain torch, as
it is plain jnp in the JAX package. Parameters are a dict of tensors
(``emb``, ``pos``, ``layers``: a list of ``wq``/``wk``/``wv``/``wo``
dicts); :meth:`CacheLM.init_params` draws the JAX package's numpy stream,
so the same seed gives the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..context import resolve_device
from ..ops.batching import tree_map
from .kvcache import gather_kv

__all__ = ["CacheLM", "CacheLMConfig", "perturbed_params"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class CacheLMConfig:
    vocab: int = 64
    n_layers: int = 2
    n_heads: int = 2
    head_dim: int = 8
    max_positions: int = 512

    @property
    def d_model(self) -> int:
        return self.n_heads * self.head_dim


class CacheLM:
    """Embedding, ``n_layers`` residual attention blocks (RMS-normalized
    residual stream) and a tied output head: minimal, but real multi-head
    causal attention over a paged cache, the part the engine exercises."""

    def __init__(self, cfg: CacheLMConfig, block_size: int):
        self.cfg = cfg
        self.block_size = block_size

    @property
    def n_layers(self) -> int:
        return self.cfg.n_layers

    @property
    def n_heads(self) -> int:
        return self.cfg.n_heads

    @property
    def head_dim(self) -> int:
        return self.cfg.head_dim

    def init_params(self, seed: int = 0, device=None):
        """fp32 parameters from ``np.random.RandomState(seed)``, drawn in
        the JAX package's order, on ``device`` (default: this process's
        card)."""
        cfg = self.cfg
        device = resolve_device(device)
        rng = np.random.RandomState(seed)
        d = cfg.d_model

        def mat(*shape, scale):
            return torch.as_tensor(
                (rng.randn(*shape) * scale).astype(np.float32), device=device)

        return {
            # Position embeddings twice as loud as the token embeddings:
            # generated sequences then switch tokens at position-dependent
            # points, so an off-by-one in the cache bookkeeping changes the
            # output instead of hiding inside a fixed point.
            "emb": mat(cfg.vocab, d, scale=1.0),
            "pos": mat(cfg.max_positions, d, scale=2.0),
            "layers": [
                {
                    "wq": mat(d, d, scale=d ** -0.5),
                    "wk": mat(d, d, scale=d ** -0.5),
                    "wv": mat(d, d, scale=d ** -0.5),
                    "wo": mat(d, d, scale=d ** -0.5),
                }
                for _ in range(cfg.n_layers)
            ],
        }

    def extend(
        self,
        params,
        toks: torch.Tensor,        # [R, W] window tokens
        pos0: torch.Tensor,        # [R] cache length = window start
        block_rows: torch.Tensor,  # [R, M] block tables
        seq_lens: torch.Tensor,    # [R] valid cached tokens
        k,                         # the pool's tensors (device_args())
        v,
        k_scales=None,
        v_scales=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Advance every row's sequence by its ``W`` window tokens.

        Returns ``(logits [R, W, vocab], k_new [R, W, L, H, dh], v_new)``:
        ``logits[:, i]`` predicts the token after window token ``i``; the
        caller scatters ``k_new``/``v_new`` into the pool at the slots of
        ``pos0 .. pos0 + W - 1`` (or scratch, for masked rows). Masked rows
        (``seq_lens=0``, scratch tables) are numerically safe: the window's
        self-attention keeps every softmax row non-empty."""
        cfg = self.cfg
        r, w = toks.shape
        h, dh = cfg.n_heads, cfg.head_dim
        dev = toks.device
        ar_w = torch.arange(w, device=dev)
        pos_idx = torch.clamp(pos0.long()[:, None] + ar_w, 0,
                              cfg.max_positions - 1)
        x = params["emb"][toks.long()] + params["pos"][pos_idx]  # [R, W, D]
        kc, vc = gather_kv(k, v, k_scales, v_scales, block_rows,
                           self.block_size)  # [L, R, S, H, dh]
        s = kc.shape[2]
        cache_mask = (torch.arange(s, device=dev)[None, :]
                      < seq_lens.long()[:, None])  # [R, S]
        causal = ar_w[:, None] >= ar_w[None, :]  # [W(q), W(kv)]
        scale = dh ** -0.5
        k_out, v_out = [], []
        for li, layer in enumerate(params["layers"]):
            q = (x @ layer["wq"]).reshape(r, w, h, dh)
            kw = (x @ layer["wk"]).reshape(r, w, h, dh)
            vw = (x @ layer["wv"]).reshape(r, w, h, dh)
            k_out.append(kw)
            v_out.append(vw)
            qh = q.transpose(1, 2)                   # [R, H, W, dh]
            kch = kc[li].transpose(1, 2)             # [R, H, S, dh]
            vch = vc[li].transpose(1, 2)
            kwh = kw.transpose(1, 2)                 # [R, H, W, dh]
            vwh = vw.transpose(1, 2)
            sc = torch.einsum("rhqd,rhkd->rhqk", qh, kch) * scale
            sw = torch.einsum("rhqd,rhkd->rhqk", qh, kwh) * scale
            sc = torch.where(cache_mask[:, None, None, :], sc, NEG_INF)
            sw = torch.where(causal[None, None, :, :], sw, NEG_INF)
            attn = torch.softmax(torch.cat([sc, sw], dim=-1), dim=-1)
            out = torch.einsum("rhqk,rhkd->rhqd", attn,
                               torch.cat([vch, vwh], dim=2))
            out = out.transpose(1, 2).reshape(r, w, cfg.d_model)
            x = x + out @ layer["wo"]
            # RMS-normalize the residual stream: without it the stream
            # saturates and every prompt collapses onto one fixed-point
            # token, which exercises nothing of the cache.
            x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6)
        logits = x @ params["emb"].T * cfg.d_model ** -0.5
        k_new = torch.stack(k_out, dim=2)  # [R, W, L, H, dh]
        v_new = torch.stack(v_out, dim=2)
        return logits, k_new, v_new


def perturbed_params(params, scale: float = 0.02, seed: int = 1):
    """A cheap draft tier: the target's weights plus seeded noise (the JAX
    package's numpy stream, leaf by leaf in its order), which agrees with
    the target often but not always: the interesting speculative
    regime."""
    rng = np.random.RandomState(seed)
    return tree_map(
        lambda x: x + torch.as_tensor(rng.randn(*x.shape) * scale,
                                      dtype=x.dtype, device=x.device),
        params,
    )
