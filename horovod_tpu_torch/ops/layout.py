"""The bucket scheduler: when each gradient bucket reaches the wire.

The port's counterpart of the JAX package's ``ops/layout.py``. There, the
fused buckets are one compiled program, and XLA options decide when each
bucket's collective runs: the all-reduce combiner's threshold keeps the
buckets apart, and the latency-hiding scheduler interleaves them with the
backward. ``overlap_compiler_options`` and ``collective_compiler_options``
are XLA compile options and have no counterpart in an eager torch step, so
they are not ported. Here the step runs eagerly, and :class:`
BucketScheduler` makes the same decision at run time:

* **Hooks.** A ``Tensor.register_hook`` on every parameter leaf, armed for
  the last microbatch's backward only. It fires under
  ``torch.autograd.grad`` (``register_post_accumulate_grad_hook`` never
  does, and ``register_multi_grad_hook`` on leaves raises there), once per
  leaf with its whole gradient (a tied leaf, used twice, fires once with
  the sum). A per-bucket countdown makes a bucket ready when its last leaf
  arrives.
* **Issue order.** Every rank issues the buckets in one order, and a
  bucket ready before the buckets ahead of it waits for them: NCCL needs
  one order on every rank, and readiness alone can differ between ranks
  (MoE routing, a leaf unused on one rank). A plan's first step issues in
  pack order, as the reference's chained dispatch does. Pack order walks
  the leaves' sorted names backwards (:func:`~.batching._bucketize`), and
  where the last names are the input side's -- GPT-2's tied ``wte``,
  ViT's ``pos_embed``, ResNet's ``conv_init`` -- bucket 0 is whole only
  when the backward ends and nothing goes out before it. So the first
  step also records the order its buckets became whole, and rank 0's
  (:meth:`BucketScheduler.agree_order`, one broadcast) is every rank's
  issue order from the next step on. A bucket's reduction does not depend
  on when it runs, so the order changes no result.
* **Streams.** A bucket's work -- :func:`~.fusion.reduce_bucket`: pack,
  cast or quantize (kernel 4), the collective, dequantize (kernel 5) and
  unpack, the residual -- runs on a side stream of the parameters' card,
  which first waits for an event recorded on the stream the backward made
  the gradients on. ``stagger=True`` puts every bucket on one side stream,
  so each bucket's work follows the previous bucket's; ``stagger=False``
  gives each bucket a stream of its own, chained to nothing but the
  backward. Either way the host issues the collectives in the agreed
  order, and NCCL runs one communicator's collectives in the order they
  were issued.
  Gradients and residuals read on a side stream are marked used there
  (``record_stream``), and the results used back on the compute stream
  are marked used there, so the caching allocator reuses no block a
  stream still reads.
* **Leaves without a gradient.** A leaf the loss does not reach (BERT's
  token-type table without token types) fires no hook; its bucket is
  issued with zeros for it after the backward returns, as the step without
  overlap fills them in.
* **The update.** :meth:`BucketScheduler.wait` makes the compute stream
  wait for every bucket's last event and hands the assembled result to the
  optimizer's update phase (:class:`~..optimizer.Reduction`).

On the CPU (gloo) there are no streams: a bucket's work runs in the hook,
and its collectives block there, so the CPU tests drive the same code.

:func:`autotune_threshold` is the JAX package's tuning loop for a fusion
threshold, driven by the runtime's :class:`~..native.autotune.GpTuner1D`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..analysis import record as _record
from .collectives import broadcast
from .fusion import BucketPlan

__all__ = ["BucketScheduler", "autotune_threshold"]

# Side streams by (device index, slot): slot 0 is the chained stream, and
# without stagger bucket b takes slot b.
_STREAMS: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device, slot: int) -> "torch.cuda.Stream":
    """The side stream ``slot`` of ``device`` (made on first use)."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), slot)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=torch.device("cuda", key[0]))
    return _STREAMS[key]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


class BucketScheduler:
    """Issues one step's bucket reductions (``plan``, a
    :class:`~.fusion.BucketPlan` over the parameters) as their gradients
    arrive, from the hooks :meth:`armed` puts on the leaves, in ``order``
    (bucket ids; default pack order), which every rank must share.

    ``finish(i, g)`` turns leaf ``i``'s gradient into what is reduced (the
    microbatch mean; the identity by default), on the stream that made
    it. A plan whose wire needs every leaf before its first bucket (the
    fp16 wire's prescale) cannot go out early: it stays with
    :meth:`~.fusion.BucketPlan.run`."""

    def __init__(self, plan: BucketPlan, *, stagger: bool = True,
                 order: Optional[Sequence[int]] = None,
                 finish: Optional[Callable[[int, torch.Tensor],
                                           torch.Tensor]] = None):
        if plan.needs_all_leaves:
            raise ValueError("this wire needs every leaf before its first "
                             "bucket; reduce it with plan.run()")
        self.plan = plan
        self.leaves = plan.leaves
        self.stagger = stagger
        self.finish = finish
        self._bucket = plan.bucket_of()
        n = plan.n_buckets
        self.order = list(range(n)) if order is None else list(order)
        if sorted(self.order) != list(range(n)):
            raise ValueError(f"issue order {self.order} is not an order of "
                             f"the plan's {n} buckets")
        self.ready_order: List[int] = []
        self._pending = [len(slots) for slots in plan.spec.buckets]
        self._ready = [False] * n
        self._grads: List[Optional[torch.Tensor]] = [None] * len(self.leaves)
        self._results: List = [None] * n
        self._done: List = [None] * n
        self._next = 0
        self._hooks: List = []
        self.device = self.leaves[0].device
        # A record of the step (analysis/record.py) runs no stream work:
        # its buckets go out inline, as on the CPU.
        self._cuda = self.device.type == "cuda" and not _record.active()

    # -- arrival -------------------------------------------------------------

    @contextlib.contextmanager
    def armed(self):
        """Hooks on every leaf for the extent of one backward."""
        self._hooks = [
            leaf.register_hook(self._hook(i))
            for i, leaf in enumerate(self.leaves)
        ]
        try:
            yield self
        finally:
            for h in self._hooks:
                h.remove()
            self._hooks = []

    def _hook(self, i: int):
        def hook(g):
            with torch.no_grad():
                self._take(i, g)
            return None
        return hook

    def _take(self, i: int, g: torch.Tensor) -> None:
        if self._grads[i] is not None:
            raise RuntimeError(f"leaf {i}'s gradient arrived twice in a step")
        if self.finish is not None:
            g = self.finish(i, g)
        self._grads[i] = g
        b = self._bucket[i]
        self._pending[b] -= 1
        if self._pending[b] == 0:
            self._ready[b] = True
            self.ready_order.append(b)
            self._issue_ready()

    def _issue_ready(self) -> None:
        while (self._next < len(self.order)
               and self._ready[self.order[self._next]]):
            self._issue(self.order[self._next])
            self._next += 1

    # -- issue ---------------------------------------------------------------

    def _issue(self, b: int) -> None:
        leaves = self.plan.bucket_leaves(b, self._grads)
        if not self._cuda:
            self._results[b] = self.plan.reduce(b, leaves)
            return
        compute = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device, 0 if self.stagger else b)
        ready = torch.cuda.Event()
        ready.record(compute)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            for t in leaves:
                t.record_stream(side)
            if self.plan.res_bufs is not None:
                self.plan.res_bufs[b].record_stream(side)
            self._results[b] = self.plan.reduce(b, leaves)
            done = torch.cuda.Event()
            done.record(side)
        self._done[b] = done

    def flush(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """After the backward: every leaf whose hook did not fire takes its
        gradient from ``grads`` (autograd's result in plan order; zeros for
        None), and every bucket not yet issued goes out, in order."""
        with torch.no_grad():
            for i, g in enumerate(grads):
                if self._grads[i] is None:
                    self._take(i, torch.zeros_like(self.leaves[i])
                               if g is None else g)
        if self._next != len(self._ready):
            raise RuntimeError("a bucket was never issued")

    @property
    def grads(self) -> List[Optional[torch.Tensor]]:
        """After :meth:`flush`: every leaf's gradient as reduced (the
        microbatch mean), in the plan's leaf order -- what the gradient
        guard screens."""
        return list(self._grads)

    def agree_order(self) -> List[int]:
        """After :meth:`flush`: the order rank 0's buckets became whole
        this step, on every rank of the plan's group (one broadcast; every
        rank calls it at the same point of the same step)."""
        mine = torch.tensor(self.ready_order, dtype=torch.int64,
                            device=self.device)
        return broadcast(mine, 0, axis=self.plan.axis).tolist()

    def wait(self):
        """The compute stream waits for every bucket; returns the plan's
        assembled ``(out, new residuals)``."""
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            for done in self._done:
                compute.wait_event(done)
            for t in _tensors(self._results):
                t.record_stream(compute)
        return self.plan.assemble(self._results)


def autotune_threshold(measure_fn: Callable[[int], float], *,
                       lo_bytes: int = 1 << 20, hi_bytes: int = 512 << 20,
                       max_samples: int = 12) -> int:
    """Tune a fusion threshold (the JAX package's ``ops/layout.py:157``,
    after the reference's ``ParameterManager`` loop): propose a threshold,
    score it with ``measure_fn(threshold_bytes)`` (higher is better, e.g.
    steps a second of the step built with ``HVDTPU_FUSION_THRESHOLD`` at
    it), record the score, ``max_samples`` times. Proposals come from
    :class:`~..native.autotune.GpTuner1D`, the runtime's GP and
    expected-improvement search, which is always present here: there is no
    log-sweep fallback. Returns the best threshold scored (bytes)."""
    from ..native.autotune import GpTuner1D

    tuner = GpTuner1D(float(lo_bytes), float(hi_bytes))
    best_t, best_score = None, -float("inf")
    for _ in range(max_samples):
        t = int(tuner.propose())
        score = float(measure_fn(t))
        tuner.record(float(t), score)
        if score > best_score:
            best_t, best_score = t, score
    return int(best_t)
