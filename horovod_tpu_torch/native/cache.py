"""The response cache: an LRU of negotiated responses, and its bit vectors.

The port of ``csrc/response_cache.cc:8-105`` (reference
``horovod/common/response_cache.h:45-160``). Steady-state training repeats
the same named collectives every step; once a name is negotiated, a rank
announces it again by its cache slot's bit instead of its full descriptor,
and the coordinator answers a globally ready slot with its bit. Every rank
keeps an identical slot table: every rank inserts the same negotiated
responses in the same (broadcast) order, and touches hits in the same
(bit) order.
"""

from __future__ import annotations

import collections
import enum
from typing import Dict, List

from .messages import Request, Response


class CacheState(enum.Enum):
    MISS = 0
    HIT = 1
    INVALID = 2


def _same_params(c: Request, req: Request) -> bool:
    return (c.type == req.type and c.dtype == req.dtype
            and tuple(c.shape) == tuple(req.shape)
            and c.reduce_op == req.reduce_op and c.prescale == req.prescale
            and c.postscale == req.postscale and c.root_rank == req.root_rank
            and tuple(c.splits) == tuple(req.splits)
            and c.device == req.device)


class ResponseCache:
    """Slot table of negotiated single-tensor responses, least recently
    used evicted at ``capacity`` (``HVDTPU_CACHE_CAPACITY``, 0 = off)."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(0, int(capacity))
        self._entries: Dict[int, tuple] = {}  # bit -> (request, response)
        self._name_to_bit: Dict[str, int] = {}
        # Most recent last; move_to_end is the touch.
        self._lru: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict())
        self._free_bits: List[int] = []
        self._next_bit = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, req: Request) -> CacheState:
        """HIT when ``req`` matches a cached response (the same name AND
        the same dtype, shape, op, scales, root, splits and device); a name
        with other parameters is INVALID and renegotiates."""
        bit = self._name_to_bit.get(req.name)
        if bit is None:
            return CacheState.MISS
        cached = self._entries[bit][0]
        return CacheState.HIT if _same_params(cached, req) \
            else CacheState.INVALID

    def put(self, req: Request, resp: Response) -> None:
        """Insert or refresh a fully negotiated single-tensor response."""
        if self.capacity == 0:
            return
        bit = self._name_to_bit.get(req.name)
        if bit is not None:
            self._entries[bit] = (req, resp)
            self.touch(bit)
            return
        if len(self._entries) >= self.capacity:
            victim, _ = self._lru.popitem(last=False)
            del self._name_to_bit[self._entries.pop(victim)[0].name]
            self._free_bits.append(victim)
        if self._free_bits:
            bit = self._free_bits.pop()
        else:
            bit = self._next_bit
            self._next_bit += 1
        self._lru[bit] = None
        self._entries[bit] = (req, resp)
        self._name_to_bit[req.name] = bit

    def bit_of(self, name: str) -> int:
        """The slot of ``name``, -1 when absent."""
        return self._name_to_bit.get(name, -1)

    def has_bit(self, bit: int) -> bool:
        return bit in self._entries

    def request_at(self, bit: int) -> Request:
        return self._entries[bit][0]

    def response_at(self, bit: int) -> Response:
        return self._entries[bit][1]

    def touch(self, bit: int) -> None:
        """LRU bump; every rank calls it in the same order."""
        self._lru.move_to_end(bit)

    def evict_by_name(self, name: str) -> None:
        bit = self._name_to_bit.pop(name, None)
        if bit is None:
            return
        del self._entries[bit]
        del self._lru[bit]
        self._free_bits.append(bit)

    def make_bitvector(self, bits) -> List[int]:
        """Words of 64 bits over the slots, bit ``b`` set for each of
        ``bits``: what a rank sends in place of full descriptors."""
        vec = [0] * ((self._next_bit + 63) // 64)
        for b in bits:
            if b >= 0:
                vec[b // 64] |= 1 << (b % 64)
        return vec

    @staticmethod
    def bits_from_vector(vec) -> List[int]:
        """The set bits of a vector, in ascending order."""
        out = []
        for w, word in enumerate(vec):
            while word:
                low = word & -word
                out.append(w * 64 + low.bit_length() - 1)
                word ^= low
        return out
