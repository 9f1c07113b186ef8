"""Adasum: the scale-invariant adaptive-sum reduction.

The port of the JAX package's ``ops/adasum.py`` (the reference's
``horovod/common/ops/adasum/adasum.h``). The pairwise rule, for partners'
vectors ``a`` (lower rank) and ``b``::

    adasum(a, b) = (1 - a.b / (2 |a|^2)) a + (1 - a.b / (2 |b|^2)) b

with the dots in fp32, a zero norm leaving its side's coefficient at 1,
and the result cast back to ``a``'s dtype after every combine (so a bf16
leaf rounds to bf16 each round, as in the reference). Parallel vectors
average, orthogonal ones add.

The tree is the reference's VHDD schedule for any world size
(:func:`schedule`): with ``p`` the largest power of two <= n and ``r = n -
p``, the pairs ``(2i, 2i+1)`` for ``i < r`` pre-combine into their even
rank, the ``p`` active ranks run distance-doubling rounds with partner
``v ^ level`` on virtual ranks ``v``, and each even rank of a pair hands
the result back to its odd rank.

The port's own transport: the leaves of a gradient are packed by dtype
into flat buffers, each leaf padded to whole rows of :data:`ROW` elements
(:class:`FlatLayout`), and every round is one ``batch_isend_irecv``
carrying all the buffers. Each leaf keeps its own dots: a combine takes
the three products' row sums and adds the rows of each leaf together
(one ``index_add_``), so its launches do not grow with the leaf count.
:func:`adasum_stacked` drives the same schedule and the same combine over
virtual ranks in one process (the tests and ``chip_smoke.py`` hold it
against the fp64 :func:`adasum_fold`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..exceptions import HorovodTpuError
from .batching import tree_flatten, tree_unflatten
from .collectives import group, p2p_ready

__all__ = [
    "FlatLayout",
    "ROW",
    "Schedule",
    "adasum_allreduce",
    "adasum_allreduce_tree",
    "adasum_fold",
    "adasum_stacked",
    "combine",
    "schedule",
]

# Elements of one row of the flat layout: each leaf is padded to whole rows,
# whose partial dots are summed per leaf.
ROW = 1024


def _pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One Adasum combine of two tensors, as the reference's ``_pairwise``:
    fp32 dots, the zero-norm guard, the result in ``a``'s dtype."""
    af, bf = a.float(), b.float()
    dot = torch.dot(af.reshape(-1), bf.reshape(-1))
    na = torch.dot(af.reshape(-1), af.reshape(-1))
    nb = torch.dot(bf.reshape(-1), bf.reshape(-1))
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * na), 1.0)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * nb), 1.0)
    return (ca * af + cb * bf).to(a.dtype)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The VHDD exchange of a world of ``n``: ``pre`` the ``(even, odd)``
    pairs that pre-combine into ``even``; ``rounds`` each round's ``(lo,
    hi)`` pairs of active ranks (``lo`` the lower virtual rank), both
    partners holding ``adasum(x_lo, x_hi)`` after it; ``post`` the ``(even,
    odd)`` hand-backs."""

    n: int
    pre: Tuple[Tuple[int, int], ...]
    rounds: Tuple[Tuple[Tuple[int, int], ...], ...]
    post: Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=None)
def schedule(n: int) -> Schedule:
    """The reference's VHDD schedule (``adasum.py:56-124`` of the JAX
    package) for a world of ``n``, in physical ranks."""
    if n < 1:
        raise ValueError(f"a world of {n}")
    p = 1 << (n.bit_length() - 1)  # largest power of two <= n
    r = n - p

    def phys(v: int) -> int:  # folded pairs keep their even member
        return 2 * v if v < r else v + r

    pairs = tuple((2 * i, 2 * i + 1) for i in range(r))
    rounds = []
    level = 1
    while level < p:
        rounds.append(tuple((phys(v), phys(v ^ level)) for v in range(p)
                            if v < v ^ level))
        level <<= 1
    return Schedule(n, pairs, tuple(rounds), pairs)


class FlatLayout:
    """Leaves packed by dtype into flat ``[rows, ROW]`` buffers, each leaf
    padded to whole rows: ``groups`` holds, per dtype, the leaf indices,
    their row offsets and the row -> leaf map ``seg`` (on the leaves'
    device) the per-leaf dot sums use."""

    def __init__(self, leaves: Sequence[torch.Tensor]):
        self.n_leaves = len(leaves)
        self.shapes = [tuple(t.shape) for t in leaves]
        by_dtype: dict = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(i)
        self.groups = []
        for dtype, idx in by_dtype.items():
            rows = [-(-leaves[i].numel() // ROW) for i in idx]
            offsets = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
            seg = torch.repeat_interleave(
                torch.arange(len(idx)), torch.tensor(rows, dtype=torch.int64))
            self.groups.append((dtype, idx, offsets, seg.to(
                leaves[idx[0]].device)))

    def pack(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One ``[rows, ROW]`` buffer per dtype (one ``cat`` each)."""
        out = []
        for _, idx, offsets, _ in self.groups:
            parts = []
            for j, i in enumerate(idx):
                flat = leaves[i].reshape(-1)
                parts.append(flat)
                pad = int(offsets[j + 1] - offsets[j]) * ROW - flat.numel()
                if pad:
                    parts.append(flat.new_zeros((pad,)))
            out.append(torch.cat(parts).reshape(int(offsets[-1]), ROW))
        return out

    def unpack(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The leaves (views of ``bufs``), in their original order."""
        leaves: List[torch.Tensor] = [None] * self.n_leaves
        for buf, (_, idx, offsets, _) in zip(bufs, self.groups):
            flat = buf.reshape(-1)
            for j, i in enumerate(idx):
                n = int(np.prod(self.shapes[i], dtype=np.int64))
                start = int(offsets[j]) * ROW
                leaves[i] = flat[start:start + n].view(self.shapes[i])
        return leaves

    def segments(self) -> List[Tuple[torch.Tensor, int]]:
        return [(seg, len(idx)) for _, idx, _, seg in self.groups]


def combine(a: torch.Tensor, b: torch.Tensor, seg: torch.Tensor,
            n_seg: int) -> torch.Tensor:
    """:func:`_pairwise` of every leaf of two ``[rows, ROW]`` buffers of one
    dtype (``seg`` maps each row to its leaf): the three products' row
    sums in fp32, added per leaf in fp64, the coefficients in fp32, the
    result in ``a``'s dtype. Its launches do not depend on the number of
    leaves; the pads are zeros in both and stay zeros."""
    af, bf = a.float(), b.float()
    dots = torch.stack([(af * bf).sum(1), (af * af).sum(1), (bf * bf).sum(1)])
    sums = torch.zeros((3, n_seg), dtype=torch.float64, device=a.device)
    sums.index_add_(1, seg, dots.double())
    dot, na, nb = sums
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * na), 1.0).float()
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * nb), 1.0).float()
    out = ca[seg].unsqueeze(1) * af + cb[seg].unsqueeze(1) * bf
    return out.to(a.dtype)


def _combine_all(lo, hi, layout: FlatLayout):
    return [combine(a, b, seg, n)
            for a, b, (seg, n) in zip(lo, hi, layout.segments())]


def _exchange(bufs, send_to, recv_from, g) -> List[torch.Tensor]:
    """One ``batch_isend_irecv``: every buffer to ``send_to`` and a buffer
    of each from ``recv_from`` (group ranks; either may be None)."""
    got = [torch.empty_like(b) for b in bufs] if recv_from is not None else []
    ops = []
    for b in bufs:
        if send_to is not None:
            ops.append(dist.P2POp(dist.isend, b, g.global_rank(send_to),
                                  g.group))
    for b in got:
        ops.append(dist.P2POp(dist.irecv, b, g.global_rank(recv_from),
                              g.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got


def _run_distributed(bufs, layout: FlatLayout, sched: Schedule, g):
    me = g.index
    for even, odd in sched.pre:
        if me == odd:
            _exchange(bufs, even, None, g)
        elif me == even:
            bufs = _combine_all(bufs, _exchange(bufs, None, odd, g), layout)
    for pairs in sched.rounds:
        for lo, hi in pairs:
            if me in (lo, hi):
                other = _exchange(bufs, hi if me == lo else lo,
                                  hi if me == lo else lo, g)
                pair = (bufs, other) if me == lo else (other, bufs)
                bufs = _combine_all(*pair, layout)
    for even, odd in sched.post:
        if me == even:
            _exchange(bufs, odd, None, g)
        elif me == odd:
            bufs = _exchange(bufs, None, even, g)
    return bufs


def adasum_allreduce_tree(tree, axis=None):
    """Adasum over the group along ``axis`` of a whole nest of tensors,
    each leaf its own dots (the reference applies it per leaf); returns
    new tensors in the nest's structure. A group of one returns copies."""
    leaves, treedef = tree_flatten(tree)
    g = group(axis)
    if g.size == 1 or not leaves:
        return tree_unflatten(treedef, [t.clone() for t in leaves])
    layout = FlatLayout(leaves)
    bufs = layout.pack(leaves)
    p2p_ready(g, leaves[0].device)
    bufs = _run_distributed(bufs, layout, schedule(g.size), g)
    return tree_unflatten(treedef, layout.unpack(bufs))


def adasum_allreduce(tensor: torch.Tensor, axis=None) -> torch.Tensor:
    """Adasum-allreduce one tensor over the group along ``axis``."""
    return adasum_allreduce_tree([tensor], axis=axis)[0]


def adasum_stacked(trees: Sequence) -> object:
    """The distributed schedule over virtual ranks in one process: ``trees``
    holds each virtual rank's nest (alike in structure, shapes and dtypes);
    runs :func:`schedule` of ``len(trees)`` with :func:`combine` on the
    packed buffers, and returns the nest every rank ends with."""
    if not trees:
        raise HorovodTpuError("adasum_stacked needs at least one rank")
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    layout = FlatLayout(flat[0][0])
    x = [layout.pack(leaves) for leaves, _ in flat]
    sched = schedule(len(trees))
    for even, odd in sched.pre:
        x[even] = _combine_all(x[even], x[odd], layout)
    for pairs in sched.rounds:
        for lo, hi in pairs:
            x[lo] = x[hi] = _combine_all(x[lo], x[hi], layout)
    for even, odd in sched.post:
        x[odd] = x[even]
    return tree_unflatten(treedef, layout.unpack(x[0]))


def adasum_fold(stacked: torch.Tensor) -> torch.Tensor:
    """The JAX package's process-path Adasum (``ops/eager.py``
    ``_adasum_fold``): a binary fold over ``stacked`` ``[n, ...]``
    contributions in fp64, pairing neighbours level by level and carrying
    an odd one up. It pairs as the VHDD schedule does for some world sizes
    (2-4, 6-8, 12, 14-16) and not for others (5, 9-11, 13): at n = 5 it
    folds ((0,1),(2,3)),4 where VHDD pre-combines (0,1) and pairs
    (01,2),(3,4). Returns fp64."""
    vecs = [v.double().reshape(-1) for v in stacked]
    shape = stacked.shape[1:]
    while len(vecs) > 1:
        nxt = []
        for i in range(0, len(vecs), 2):
            if i + 1 == len(vecs):
                nxt.append(vecs[i])
                continue
            a, b = vecs[i], vecs[i + 1]
            dot, na, nb = a @ b, a @ a, b @ b
            ca = torch.where(na > 0, 1.0 - dot / (2 * na), 1.0)
            cb = torch.where(nb > 0, 1.0 - dot / (2 * nb), 1.0)
            nxt.append(ca * a + cb * b)
        vecs = nxt
    return vecs[0].reshape(shape)
