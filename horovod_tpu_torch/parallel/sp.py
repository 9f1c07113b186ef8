"""Sequence parallelism: ring attention and Ulysses attention -- the port
of the JAX package's ``parallel/sp.py``.

* :func:`ring_attention`: the sequence is sharded over a mesh axis; each
  rank keeps its query block while the key and value blocks travel one hop
  a step around the ring (:func:`..ops.diff_collectives.ppermute`), and the
  partial results merge exactly. The dense form keeps fp32 scores and an
  online-softmax update; the flash form (``use_flash=True``) runs each hop
  through :func:`..ops.flash_attention.flash_attention_with_lse` at the
  hop's global offsets (kernel 1 forward, kernels 2 and 3 with the ``lse``
  cotangent backward on a CUDA tensor; the plain versions on a CPU tensor)
  and merges with :func:`..ops.flash_attention.combine_blocks`.
* :func:`ulysses_attention`: an all-to-all moves the sharding from the
  sequence to the heads, attention runs on the whole sequence with a share
  of the heads, and a second all-to-all moves it back.

Both are differentiable: every exchange is an autograd Function whose
backward runs the inverse exchange on every rank of the axis.
"""

from __future__ import annotations

import math

import torch

from ..ops import collectives as _coll
from ..ops.diff_collectives import all_to_all, ppermute
from ..ops.flash_attention import combine_blocks, flash_attention_with_lse

__all__ = ["ring_attention", "ulysses_attention"]


def _online_update(o, m, l, scores, v):
    """One online-softmax accumulation step: ``o`` ``[B, S, H, D]`` the
    running numerator, ``m``/``l`` ``[B, H, S]`` the running max and
    denominator, ``scores`` ``[B, H, S, Skv]`` fp32, ``v`` ``[B, Skv, H,
    D]``; ``p`` is rounded to V's dtype before the PV product."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def _flash_hop(q, k_blk, v_blk, *, q_offset: int, kv_offset: int,
               causal: bool):
    """One hop of the flash ring: ``(o_i, lse_i)`` of ``q`` ``[B, S, H,
    D]`` against one key/value block, at global offsets. A head dim that
    is a multiple of 64 runs in the packed ``[B, S, H*D]`` layout, whose
    reshapes are free."""
    b, s, h, d = q.shape
    if d % 64 == 0:
        o_i, lse_i = flash_attention_with_lse(
            q.reshape(b, s, h * d), k_blk.reshape(b, -1, h * d),
            v_blk.reshape(b, -1, h * d), causal=causal, q_offset=q_offset,
            kv_offset=kv_offset, layout="bsm", n_heads=h)
        return o_i.reshape(b, s, h, d), lse_i
    return flash_attention_with_lse(q, k_blk, v_blk, causal=causal,
                                    q_offset=q_offset, kv_offset=kv_offset)


def flash_ring(q, kv_block, *, n: int, r: int, causal: bool):
    """Rank ``r`` of an ``n``-rank flash ring: its query block ``q`` ``[B,
    S, H, D]`` (global positions ``r*S ..``) against every key/value block
    in the ring's order -- its own first, then ``r - 1``, ``r - 2``, ... --
    each hop one :func:`_flash_hop` at its global offsets, merged by
    :func:`combine_blocks`. ``kv_block(step, kv_rank) -> (k_blk, v_blk)``
    brings the step's block, called once a step in step order:
    :func:`ring_attention` passes one that ``ppermute``s the blocks a hop
    along the ring, and a single process can slice a whole sequence's
    keys to run ``n`` virtual ranks. Returns the fp32 output, the merged
    ``lse`` and each hop's ``(kv_rank, o_i, lse_i)``."""
    b, s, h, d = q.shape
    o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s), float("-inf"), dtype=torch.float32,
                     device=q.device)
    hops = []
    for step in range(n):
        kv_rank = (r - step) % n
        k_blk, v_blk = kv_block(step, kv_rank)
        o_i, lse_i = _flash_hop(q, k_blk, v_blk, q_offset=r * s,
                                kv_offset=kv_rank * s, causal=causal)
        hops.append((kv_rank, o_i, lse_i))
        o, lse = combine_blocks(o, lse, o_i.float(), lse_i)
    return o, lse, hops


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis, causal: bool = False, use_flash: bool = False,
                   block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Exact attention over a sequence sharded along mesh axis ``axis``.

    q/k/v ``[batch, seq_shard, heads, head_dim]``: this rank's block of the
    sequence, group rank ``r`` holding global positions ``r*S ..
    (r+1)*S-1``. Returns the output in the same layout and dtype.

    ``use_flash=True`` computes each hop with the flash kernels and merges
    the hops' ``(out, lse)`` by log-sum-exp (:func:`combine_blocks`), so no
    ``S x S`` score matrix is stored. ``block_q`` and ``block_k`` are
    accepted for the JAX package's signature and ignored: the CUDA kernels
    choose their own tiles."""
    del block_q, block_k
    g = _coll.group(axis)
    n, r = g.size, g.index
    if use_flash:
        blocks = [k, v]

        def passed_on(step, kv_rank):
            if step:
                blocks[:] = [ppermute(x, _ring_perm(n), axis=axis)
                             for x in blocks]
            return blocks

        o, _, _ = flash_ring(q, passed_on, n=n, r=r, causal=causal)
        return o.to(q.dtype)
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    q_pos = r * s + torch.arange(s, device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        kv_rank = (r - step) % n
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
        if causal:
            kv_pos = kv_rank * s + torch.arange(s, device=q.device)
            cmask = q_pos[:, None] >= kv_pos[None, :]
            scores = scores.masked_fill(~cmask, float("-inf"))
        o, m, l = _online_update(o, m, l, scores, v_blk)
        if step != n - 1:
            k_blk = ppermute(k_blk, _ring_perm(n), axis=axis)
            v_blk = ppermute(v_blk, _ring_perm(n), axis=axis)
    # Rows without a key (causal with an empty block only) have l == 0.
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    out = o / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis, causal: bool = False,
                      attention_fn=None) -> torch.Tensor:
    """Ulysses sequence parallelism: all-to-all sequence -> heads,
    attention over the whole sequence with ``heads / n`` heads, heads ->
    sequence. q/k/v ``[batch, seq_shard, heads, head_dim]``; the heads must
    divide by the axis size. ``attention_fn(q, k, v, causal=)`` defaults to
    :func:`..models.transformer.dot_product_attention`."""
    n = _coll.world_size(axis)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"heads {h} not divisible by sp axis size {n}")
    if attention_fn is None:
        from ..models.transformer import dot_product_attention

        attention_fn = dot_product_attention

    def seq_to_heads(x):  # [B, S/n, H, D] -> [B, S, H/n, D]
        return all_to_all(x, 2, 1, axis=axis)

    out = attention_fn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                       causal=causal)
    return all_to_all(out, 1, 2, axis=axis)
