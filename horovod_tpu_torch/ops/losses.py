"""Chunked cross-entropy for large-vocabulary heads -- the port of the JAX
package's ``ops/losses.py``.

:func:`fused_cross_entropy` computes softmax cross-entropy against a
decoder matrix **without materializing the full ``[N, V]`` logits**: rows
run in chunks of ``chunk_rows``, and each chunk's body is checkpointed
(``torch.utils.checkpoint``, non-reentrant), so the backward recomputes
that chunk's ``[chunk, V]`` logits instead of keeping every chunk's. The
live transient is one chunk's logits and their gradient, not the whole
batch's: 2.0 GB of fp32 logits at BERT-base's 32 x 512 and 1.65 GB at
GPT-2 small's 8 x 1024, each with a gradient as large.

The logits are ``h @ w`` accumulated in fp32, as the reference's
``jnp.dot(..., preferred_element_type=float32)`` gives them: the operands
are taken to fp32 before the product (a bf16 operand converts exactly),
so the products are exact and only the sums round, in fp32. They are not a
bf16 product cast afterwards. On the card the product runs on cuBLAS in
fp32; the callers keep TF32 off, as the JAX package's fp32 ``Dense`` is a
full-precision product.

Rows are padded up to a multiple of the chunk (padded rows get weight 0),
and only the all-masked case is guarded: fractional weight sums in (0, 1)
divide as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["fused_cross_entropy", "cross_entropy_logits_reference"]


def _logits(h, w, bias):
    logits = h.float() @ w.float()
    if bias is not None:
        logits = logits + bias.float()
    return logits


def _per_row(logits, targets):
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long().unsqueeze(-1)).squeeze(-1)
    return lse - tgt


def _chunk_sum(h_c, t_c, w_c, w, bias):
    """Weighted CE sum over one row chunk."""
    return torch.sum(_per_row(_logits(h_c, w, bias), t_c) * w_c)


def _guarded_mean(total, weight_sum):
    return total / torch.where(weight_sum > 0, weight_sum,
                               torch.ones_like(weight_sum))


def fused_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor, *,
                        bias: Optional[torch.Tensor] = None,
                        weights: Optional[torch.Tensor] = None,
                        chunk_rows: int = 2048) -> torch.Tensor:
    """Mean softmax cross-entropy of ``h @ w (+bias)`` against ``targets``
    without a full logits tensor.

    Args:
      h: ``[..., M]`` final hidden states (any leading shape; flattened).
      w: ``[M, V]`` decoder matrix (for a tied embedding pass ``wte.T``; for
        a ``Dense`` decoder, ``dense.weight.t()``).
      targets: integer ``[...]`` matching ``h``'s leading shape.
      bias: optional ``[V]`` decoder bias.
      weights: optional ``[...]`` per-position weights (0 masks a position;
        the mean is over the weight sum) -- the MLM masked-positions idiom.
      chunk_rows: rows per chunk; the live transient is ``chunk_rows x V``
        fp32 (at least 8 rows, at most all of them).

    Returns the scalar mean loss (fp32)."""
    m = h.shape[-1]
    h2 = h.reshape(-1, m)
    t2 = targets.reshape(-1)
    n = h2.shape[0]
    w_rows = (torch.ones((n,), dtype=torch.float32, device=h.device)
              if weights is None else weights.reshape(-1).float())
    chunk_rows = max(8, min(chunk_rows, n))
    pad = (-n) % chunk_rows
    if pad:
        h2 = torch.cat([h2, h2.new_zeros((pad, m))])
        t2 = torch.cat([t2, t2.new_zeros((pad,))])
        w_rows = torch.cat([w_rows, w_rows.new_zeros((pad,))])
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, h2.shape[0], chunk_rows):
        rows = slice(start, start + chunk_rows)
        args = (h2[rows], t2[rows], w_rows[rows], w, bias)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_sum, *args, use_reentrant=False)
        else:
            total = total + _chunk_sum(*args)
    return _guarded_mean(total, w_rows.sum())


def cross_entropy_logits_reference(h: torch.Tensor, w: torch.Tensor,
                                   targets: torch.Tensor, *,
                                   bias: Optional[torch.Tensor] = None,
                                   weights: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """The unchunked version (materializes the full fp32 logits): the
    numerics :func:`fused_cross_entropy` is held against."""
    per = _per_row(_logits(h, w, bias), targets)
    if weights is None:
        return per.mean()
    wts = weights.float()
    return _guarded_mean(torch.sum(per * wts), wts.sum())
