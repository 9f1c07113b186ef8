"""Per-rank data sharding with mid-epoch elastic resume, and the input leg
of the pipeline -- the port of the JAX package's ``data.py``.

:class:`ShardedIndexSampler` and :class:`ShardedBatches` are numpy logic
and follow the reference line for line: deterministic per-epoch shuffles,
world-size sharding with cycling padding, processed-index tracking for
state-preserving restarts, and a ``state_dict``. The sampler reads the live
world from the port's :mod:`.context` (a world of one before ``init``).
:func:`prefetch_to_device` stages batches onto the card ahead of the
training loop: each array is copied into pinned host memory and sent on a
copy stream of its own, and the consumer's stream waits on that copy's
event before the batch is handed out. With the telemetry planes on, it
sets the ``prefetch.*`` gauges, records ``prefetch.fill`` spans and books
an empty-buffer fill as ``input_stall`` in the goodput ledger, as the
reference does.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .context import rank as _ctx_rank, resolve_device, size as _ctx_size
from .exceptions import NotInitializedError
from .obs import goodput as _goodput
from .obs import registry as _obs
from .obs import trace as _trace
from .ops.batching import tree_map
from .utils import env as _env

__all__ = ["ShardedBatches", "ShardedIndexSampler", "prefetch_to_device"]


def _world() -> tuple:
    try:
        return _ctx_rank(), _ctx_size()
    except NotInitializedError:
        # No world yet (unit tests, single-process scripts): shard as a
        # world of one. Any other context failure propagates -- silently
        # degrading to world-of-1 would duplicate training data.
        return 0, 1


class ShardedIndexSampler:
    """Rank-sharded index stream with mid-epoch resume.

    Each epoch is a seeded permutation; already-processed indices are
    excluded on ``reset()`` (after an elastic restart or a checkpoint
    restore); the remaining indices are padded by cycling so every rank
    yields the same count."""

    def __init__(self, num_items: int, *, shuffle: bool = True,
                 seed: int = 0, rank: Optional[int] = None,
                 world_size: Optional[int] = None):
        self.num_items = num_items
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed: set = set()
        self._rank_override = rank
        self._world_override = world_size
        self.reset()

    # -- world/epoch management -------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed = set()
        self.reset()

    def record(self, indices: Sequence[int]) -> None:
        self.processed.update(int(i) for i in indices)

    def reset(self) -> None:
        rank, world = _world()
        self.rank = self._rank_override if self._rank_override is not None else rank
        self.world_size = (self._world_override
                           if self._world_override is not None else world)
        order = np.arange(self.num_items)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(order)
        if self.processed:
            done = np.fromiter(self.processed, np.int64, len(self.processed))
            remaining = order[~np.isin(order, done)].tolist()
        else:
            remaining = order.tolist()
        self.num_samples = math.ceil(len(remaining) / self.world_size)
        total = self.num_samples * self.world_size
        if remaining:
            pad = total - len(remaining)
            reps = -(-pad // len(remaining)) if pad > 0 else 0
            remaining = remaining + (remaining * reps)[:pad]
        self._indices = remaining

    # -- iteration ---------------------------------------------------
    def __iter__(self) -> Iterator[int]:
        return iter(self._indices[self.rank:: self.world_size])

    def __len__(self) -> int:
        return self.num_samples

    # -- persistence -------------------------------------------------
    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "processed": sorted(self.processed),
                "seed": self.seed}

    def load_state_dict(self, state: Dict) -> None:
        self.epoch = int(state["epoch"])
        self.seed = int(state.get("seed", self.seed))
        self.processed = set(state["processed"])
        self.reset()


class ShardedBatches:
    """Batched numpy iterator over a :class:`ShardedIndexSampler`.

    Yields ``(batch_arrays..., indices)`` so callers can ``record()`` what
    they consumed before committing elastic state. Every rank yields the
    same number of batches: the sampler pads ``num_items % world`` by
    cycling, and the ragged final batch is dropped on every rank
    (``drop_remainder=True``, whose real indices stay unrecorded, so a
    mid-epoch restore serves them again) or padded by cycling this rank's
    own index stream (``drop_remainder=False``: static shapes, and every
    real sample is consumed every epoch)."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 sampler: Optional[ShardedIndexSampler] = None,
                 drop_remainder: bool = True, **kw):
        lengths = {len(a) for a in arrays}
        if len(lengths) != 1:
            raise ValueError(f"arrays disagree on length: {lengths}")
        self.arrays = list(arrays)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        # `is not None`, not truthiness: a sampler with an empty shard is
        # falsy but must be kept.
        self.sampler = (sampler if sampler is not None
                        else ShardedIndexSampler(lengths.pop(), **kw))

    def __iter__(self):
        idx: List[int] = []
        # The pad source of the drop_remainder=False tail: only the first
        # batch_size indices of this rank's stream can ever be read.
        seen: List[int] = []
        for i in self.sampler:
            idx.append(i)
            if not self.drop_remainder and len(seen) < self.batch_size:
                seen.append(i)
            if len(idx) == self.batch_size:
                sel = np.asarray(idx)
                yield tuple(a[sel] for a in self.arrays) + (sel,)
                idx = []
        if idx and not self.drop_remainder and seen:
            k = 0
            while len(idx) < self.batch_size:
                idx.append(seen[k % len(seen)])
                k += 1
            sel = np.asarray(idx)
            yield tuple(a[sel] for a in self.arrays) + (sel,)

    def __len__(self) -> int:
        n, rem = divmod(len(self.sampler), self.batch_size)
        if rem and not self.drop_remainder:
            return n + 1
        return n


def _host_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.ascontiguousarray(leaf))


def prefetch_to_device(iterator, depth: Optional[int] = None, *,
                       device=None) -> Iterator:
    """Stage each element of ``iterator`` (a nest of numpy arrays or
    tensors, e.g. a :class:`ShardedBatches` batch) on ``device`` up to
    ``depth`` elements before the training loop asks for it (default
    ``HVDTPU_PREFETCH_DEPTH``, 2).

    On the card each leaf is copied into pinned host memory and sent with
    ``non_blocking=True`` on a copy stream of this generator's own; the
    copy's event is recorded there, and when the element is handed out the
    consumer's current stream waits on that event (and the tensors are
    recorded on it, so the allocator does not reuse their memory early).
    The H2D copy of batch ``n+1`` thus overlaps step ``n``. On the CPU
    (``device="cpu"``) the leaves become tensors in place. Order is kept
    and the wrapper is exactly as long as its input. ``device`` defaults
    to this process's card."""
    if depth is None:
        depth = _env.prefetch_depth()
    if depth < 1:
        # Validated here, not in the generator: the error fires at wrap
        # time instead of at the first (possibly much later) next().
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    dev = resolve_device(device)

    def gen():
        queue: collections.deque = collections.deque()
        it = iter(iterator)
        copy_stream = (torch.cuda.Stream(device=dev)
                       if dev.type == "cuda" else None)

        def put(item):
            host = tree_map(_host_tensor, item)
            if copy_stream is None:
                return host, None
            with torch.cuda.stream(copy_stream):
                staged = tree_map(
                    lambda t: t.pin_memory().to(dev, non_blocking=True), host)
                event = torch.cuda.Event()
                event.record(copy_stream)
            return staged, event

        def take():
            staged, event = queue.popleft()
            if event is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(event)
                tree_map(lambda t: t.record_stream(consumer), staged)
            return staged

        while True:
            was_empty = not queue
            timed = _trace.enabled() or _goodput.enabled()
            t0 = time.perf_counter() if timed else 0.0
            w0 = time.time() if timed else 0.0
            filled = 0
            while len(queue) < depth:
                try:
                    queue.append(put(next(it)))
                    filled += 1
                except StopIteration:
                    break
            if filled and was_empty and _goodput.enabled():
                # An empty buffer at entry: this fill ran on the
                # consumer's critical path.
                _goodput.record_input_stall(w0, time.perf_counter() - t0)
            if filled and _trace.enabled():
                # The fetch and H2D-enqueue slice; "stalled" tells a fill
                # the step waited for from background work.
                _trace.complete(
                    "prefetch.fill", "data", w0, time.perf_counter() - t0,
                    args={"filled": filled, "stalled": was_empty,
                          "occupancy": len(queue), "depth": depth},
                )
            if not queue:
                return
            if _obs.enabled():
                reg = _obs.metrics()
                reg.gauge("prefetch.depth").set(depth)
                reg.gauge("prefetch.occupancy").set(len(queue))
                reg.counter("prefetch.batches").inc()
            yield take()

    return gen()
