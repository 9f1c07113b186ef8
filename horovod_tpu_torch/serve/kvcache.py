"""Paged KV-cache pool: fixed-size blocks in a preallocated device pool.

The port of the JAX package's ``serve/kvcache.py``, the token-level decode
engine's memory plane (vLLM-style paging): the pool preallocates
``n_blocks`` blocks of ``block_size`` tokens once, and every sequence holds
an ordered **block table** that grows a block at a time as it decodes.
Attention reads the cache through the table (a fixed-shape gather), and a
finished sequence's blocks return to the free list at once, so admission is
bounded by the tokens actually held, not by the worst-case length.

Device layout: block ``b``, in-block slot ``s`` live at flat slot ``b *
block_size + s`` of ``[n_layers, (n_blocks + 1) * block_size, n_heads,
head_dim]`` tensors (keys and values apart). The extra block at index
``n_blocks`` is the **scratch block**: masked decode rows and padded table
tails write and read there, so every row of the fixed decode batch has a
legal slot without branching.

``kv_dtype="int8"`` stores the payload int8 with one fp32 max-abs scale per
(token, head) in a parallel scale pool: :func:`~..ops.quantization.
quantize_kv_heads` on every :meth:`KVBlockPool.write` and
:func:`~..ops.quantization.dequantize_kv_heads` in :func:`gather_kv`, which
on the card are kernels 4 and 5 at ``block = head_dim``: one quantize each
for k and v a write, one dequantize each a gather.

Threading: a pool is confined to one decode worker thread, which
allocates, writes and defragments it; other threads read only
:meth:`~KVBlockPool.stats`, which copies plain ints. The JAX package's
``serve.*`` KV gauges wait for the observability plane.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..context import resolve_device
from ..obs import registry as _obs
from ..obs import serve as _sobs
from ..ops.quantization import (
    INT8,
    SCALE_DTYPE,
    dequantize_kv_heads,
    quantize_kv_heads,
)
from ..utils import env as _env

__all__ = ["BlockTable", "KVBlockPool", "OutOfBlocks", "gather_kv"]


class OutOfBlocks(RuntimeError):
    """The pool cannot grow a block table now: the caller queues
    (admission backpressure) or preempts, never crashes."""


@dataclasses.dataclass
class BlockTable:
    """One sequence's view of the pool: an ordered block list and the
    token count actually stored. :meth:`truncate` is the speculative
    rollback: rejected tokens only shrink ``length`` (their slots are
    overwritten later), and whole blocks past the new tail are freed."""

    pool: "KVBlockPool"
    blocks: List[int] = dataclasses.field(default_factory=list)
    length: int = 0

    @property
    def capacity(self) -> int:
        return len(self.blocks) * self.pool.block_size

    def ensure(self, n_tokens: int) -> None:
        """Grow the table to hold ``n_tokens``, all or nothing: raises
        :class:`OutOfBlocks` without allocating a partial set."""
        bs = self.pool.block_size
        need = max(0, -(-n_tokens // bs) - len(self.blocks))
        if need:
            self.blocks.extend(self.pool._alloc(need))

    def truncate(self, n_tokens: int) -> None:
        """Roll the stored-token count back to ``n_tokens`` and free whole
        blocks past the new tail."""
        if n_tokens > self.capacity:
            raise ValueError(
                f"truncate({n_tokens}) beyond capacity {self.capacity}"
            )
        keep = -(-n_tokens // self.pool.block_size)
        if keep < len(self.blocks):
            self.pool._free(self.blocks[keep:])
            del self.blocks[keep:]
        self.length = n_tokens

    def release(self) -> None:
        self.pool._free(self.blocks)
        self.blocks = []
        self.length = 0
        self.pool._by_id.pop(id(self), None)

    def flat_slots(self, start: int, count: int) -> np.ndarray:
        """Flat slots of token positions ``start .. start + count - 1``;
        positions beyond the capacity map to the scratch block (callers pad
        fixed-shape writes with them)."""
        bs = self.pool.block_size
        out = np.full((count,), self.pool.scratch_slot, np.int64)
        for i in range(count):
            t = start + i
            if 0 <= t < self.capacity:
                out[i] = self.blocks[t // bs] * bs + t % bs
        return out

    def padded_blocks(self, max_blocks: int) -> np.ndarray:
        """The table as a fixed-width row for the gather, padded with the
        scratch block's id."""
        if len(self.blocks) > max_blocks:
            raise ValueError(
                f"table holds {len(self.blocks)} blocks, row width is "
                f"{max_blocks}"
            )
        row = np.full((max_blocks,), self.pool.n_blocks, np.int64)
        row[:len(self.blocks)] = self.blocks
        return row


class KVBlockPool:
    """Preallocated paged KV storage for one decode worker, on ``device``
    (default: this process's card; raises without CUDA unless
    ``device="cpu"``)."""

    def __init__(
        self,
        n_blocks: Optional[int] = None,
        block_size: Optional[int] = None,
        *,
        n_layers: int,
        n_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.float32,
        kv_dtype: Optional[str] = None,
        device=None,
    ):
        self.n_blocks = (n_blocks if n_blocks is not None
                         else _env.serve_kv_blocks())
        self.block_size = (block_size if block_size is not None
                           else _env.serve_kv_block_size())
        if self.n_blocks < 1 or self.block_size < 1:
            raise ValueError("pool needs >= 1 block of >= 1 token")
        if kv_dtype is None:
            kv_dtype = _env.serve_kv_dtype()
        else:
            kv_dtype = str(kv_dtype).strip().lower()
            if kv_dtype in ("off", "none", "0", "false", "no"):
                kv_dtype = ""
        if kv_dtype not in ("", "int8"):
            raise ValueError(f"kv_dtype must be off|int8, got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        self.dtype = dtype
        self.n_layers, self.n_heads = n_layers, n_heads
        self.head_dim = head_dim
        slots = (self.n_blocks + 1) * self.block_size  # +1: scratch block
        self.scratch_slot = self.n_blocks * self.block_size
        payload = torch.int8 if kv_dtype == "int8" else dtype
        shape = (n_layers, slots, n_heads, head_dim)
        self.k = torch.zeros(shape, dtype=payload, device=self.device)
        self.v = torch.zeros(shape, dtype=payload, device=self.device)
        self.k_scales = self.v_scales = None
        if kv_dtype == "int8":
            self.k_scales = torch.ones(shape[:-1], dtype=SCALE_DTYPE,
                                       device=self.device)
            self.v_scales = torch.ones(shape[:-1], dtype=SCALE_DTYPE,
                                       device=self.device)
        self._free_list: List[int] = list(range(self.n_blocks))
        self._by_id: Dict[int, BlockTable] = {}
        self.n_allocs = 0
        self.n_frees = 0
        self.n_defrags = 0

    # -- host accounting ---------------------------------------------------

    def new_table(self) -> BlockTable:
        t = BlockTable(self)
        self._by_id[id(t)] = t
        return t

    def _alloc(self, n: int) -> List[int]:
        if n > len(self._free_list):
            raise OutOfBlocks(
                f"need {n} blocks, {len(self._free_list)} free of "
                f"{self.n_blocks}"
            )
        # Lowest ids first: deterministic layouts for tests and replays.
        self._free_list.sort()
        out, self._free_list = self._free_list[:n], self._free_list[n:]
        self.n_allocs += n
        self._publish_gauges()
        return out

    def _free(self, blocks: Sequence[int]) -> None:
        self._free_list.extend(blocks)
        self.n_frees += len(blocks)
        self._publish_gauges()

    @property
    def n_free(self) -> int:
        return len(self._free_list)

    def can_fit(self, n_tokens: int) -> bool:
        return -(-n_tokens // self.block_size) <= self.n_free

    def bytes_per_token(self) -> float:
        """Device bytes the pool spends on one cached token: k and v over
        every layer and head, with the int8 pool's scales."""
        per = self.n_layers * self.n_heads * self.head_dim * 2
        if self.kv_dtype == "int8":
            return per * (1 + SCALE_DTYPE.itemsize / self.head_dim)
        return per * self.dtype.itemsize

    def stats(self) -> dict:
        used = self.n_blocks - len(self._free_list)
        tokens = sum(t.length for t in self._by_id.values())
        cap = used * self.block_size
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "used_blocks": used,
            "free_blocks": len(self._free_list),
            "used_tokens": tokens,
            # Fraction of the pool's blocks in use.
            "occupancy": used / self.n_blocks,
            # Internal fragmentation: allocated slots holding no token
            # (partial tail blocks, speculative rollback slack).
            "fragmentation": 1.0 - tokens / cap if cap else 0.0,
            "allocs": self.n_allocs,
            "frees": self.n_frees,
            "defrags": self.n_defrags,
        }

    def _publish_gauges(self) -> None:
        """The ``serve.decode.kv_*`` gauges (skipped, stats and all, with
        the metrics plane off)."""
        if not _obs.enabled():
            return
        s = self.stats()
        _sobs.set_kv_blocks(s["used_blocks"], s["occupancy"],
                            s["fragmentation"])

    def defrag(self) -> int:
        """Compact live blocks to the lowest indices (one device gather a
        pool tensor), rewriting every table in place; returns how many
        blocks moved. Paged allocation never needs contiguity: this hands
        back a dense tail region and keeps long-lived tables
        cache-friendly."""
        live: List[int] = []
        for t in sorted(self._by_id.values(), key=lambda t: t.blocks[:1]):
            live.extend(t.blocks)
        mapping = {old: new for new, old in enumerate(live)}
        moved = sum(1 for old, new in mapping.items() if old != new)
        if not moved:
            return 0
        # perm[new slot] = old slot over the whole slot space (free blocks
        # fill the tail in index order; the scratch block stays put).
        rest = [b for b in range(self.n_blocks) if b not in mapping]
        bs = self.block_size
        perm = torch.as_tensor(np.concatenate(
            [np.arange(o * bs, (o + 1) * bs)
             for o in live + rest + [self.n_blocks]]), device=self.device)
        self.k = self.k[:, perm]
        self.v = self.v[:, perm]
        if self.k_scales is not None:
            self.k_scales = self.k_scales[:, perm]
            self.v_scales = self.v_scales[:, perm]
        for t in self._by_id.values():
            t.blocks = [mapping[b] for b in t.blocks]
        self._free_list = list(range(len(live), self.n_blocks))
        self.n_defrags += 1
        _sobs.record_kv_defrag()
        return moved

    # -- device writes -----------------------------------------------------

    def write(self, flat_idx, k_vals: torch.Tensor,
              v_vals: torch.Tensor) -> None:
        """Scatter new K/V into the pool, in place. ``flat_idx`` is an
        int array of any shape ``[...]`` of flat slots (the scratch slot
        for masked lanes); ``k_vals``/``v_vals`` are ``[..., n_layers,
        n_heads, head_dim]`` with the same leading shape. An int8 pool
        quantizes k and v per head first."""
        flat = np.asarray(flat_idx).reshape(-1)
        idx = torch.as_tensor(flat.astype(np.int64), device=self.device)
        shape = (flat.size or 1, self.n_layers, self.n_heads, self.head_dim)
        k_vals, v_vals = k_vals.reshape(shape), v_vals.reshape(shape)
        with torch.no_grad():
            if self.kv_dtype == "int8":
                for pool, scales, vals in ((self.k, self.k_scales, k_vals),
                                           (self.v, self.v_scales, v_vals)):
                    q, s = quantize_kv_heads(vals, INT8)
                    pool[:, idx] = q.transpose(0, 1)
                    scales[:, idx] = s.transpose(0, 1)
            else:
                self.k[:, idx] = k_vals.transpose(0, 1).to(self.k.dtype)
                self.v[:, idx] = v_vals.transpose(0, 1).to(self.v.dtype)

    def device_args(self) -> tuple:
        """The pool tensors in the order :func:`gather_kv` takes them."""
        return (self.k, self.v, self.k_scales, self.v_scales)


def gather_kv(
    k: torch.Tensor,
    v: torch.Tensor,
    k_scales: Optional[torch.Tensor],
    v_scales: Optional[torch.Tensor],
    block_rows: torch.Tensor,
    block_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape cache read for a decode step: ``block_rows [R, M]``
    block tables -> ``(k_cache, v_cache)`` of ``[n_layers, R, M *
    block_size, n_heads, head_dim]`` in float (an int8 pool's gathered
    slots dequantized). Slots past a sequence's length hold scratch or
    stale data; the attention mask (by ``seq_lens``) makes them harmless,
    as pad rows are in the request batcher."""
    r = block_rows.shape[0]
    offs = torch.arange(block_size, device=block_rows.device)
    idx = (block_rows.long()[..., None] * block_size + offs).reshape(r, -1)
    kc, vc = k[:, idx], v[:, idx]
    if k_scales is not None:
        kc = dequantize_kv_heads(kc, k_scales[:, idx])
        vc = dequantize_kv_heads(vc, v_scales[:, idx])
    return kc, vc
