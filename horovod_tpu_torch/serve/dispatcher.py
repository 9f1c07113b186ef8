"""Continuous-batching dispatcher: the serving pool's request plane.

The port of the JAX package's ``serve/dispatcher.py``. The dispatcher
owns the only mutable books of the serving subsystem:

* a FIFO **queue** of accepted requests (``submit`` -> :class:`ServeFuture`);
* the **in-flight ledger** of leased batches (:class:`BatchLease`), so a
  worker death, dispatch error or lease timeout re-queues exactly the
  requests that were on that worker -- never dropped, at worst delayed.

A worker asking for work (:meth:`Dispatcher.lease`) gets the first queued
request immediately and then collects up to ``batch_size`` within a
``batch_timeout_ms`` window. Batches are packed into the ONE fixed shape
with :func:`~horovod_tpu_torch.ops.batching.pack_requests`; the
``BatchSpec`` routes response rows back to futures.

Exactly-once resolution: a request's future resolves the first time any
worker answers it. A lease presumed lost re-queues its unanswered
requests; if the original worker answers late, the late answer wins and
the re-queued duplicate is skipped at its next lease.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import chaos as _chaos
from ..ops.batching import BatchSpec, pack_requests, unpack_responses
from ..utils import env as _env


class ServeError(RuntimeError):
    """Base class for serving-plane failures surfaced to clients."""


class ServeRequestDropped(ServeError):
    """The request was rejected at ingress (a closed dispatcher) -- the
    client should retry."""


class ServeRequestFailed(ServeError):
    """The request exhausted its re-queue budget without an answer."""


class ServeFuture:
    """Client handle for one submitted request. Settling is atomic: of a
    late answer and a rejection racing, exactly one wins."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"serve request {self.request_id} unanswered after "
                f"{timeout}s"
            )
        if self._exc is not None:
            raise self._exc
        return self._value

    def _settle(self, value: Any, exc: Optional[BaseException],
                on_settle: Optional[Callable[[], None]] = None) -> bool:
        """Settle once; ``on_settle`` runs only for the settle that wins,
        before any waiter can wake."""
        with self._lock:
            if self._event.is_set():
                return False
            self._value = value
            self._exc = exc
            if on_settle is not None:
                on_settle()
            self._event.set()
            return True

    def _resolve(self, value: Any,
                 on_settle: Optional[Callable[[], None]] = None) -> bool:
        return self._settle(value, None, on_settle)

    def _reject(self, exc: BaseException) -> bool:
        return self._settle(None, exc)


class _Request:
    __slots__ = ("id", "payload", "future", "submit_t", "attempts")

    def __init__(self, req_id: int, payload: Any):
        self.id = req_id
        self.payload = payload
        self.future = ServeFuture(req_id)
        self.submit_t = time.time()
        self.attempts = 0


class BatchLease:
    """One packed batch handed to one worker, tracked until every request
    in it is answered (or the lease is failed/reaped)."""

    __slots__ = ("lease_id", "worker", "requests", "batch", "spec", "t")

    def __init__(self, lease_id: int, worker: str,
                 requests: Tuple[_Request, ...], batch: Any,
                 spec: BatchSpec):
        self.lease_id = lease_id
        self.worker = worker
        self.requests = requests
        self.batch = batch
        self.spec = spec
        self.t = time.time()


class Dispatcher:
    """Thread-safe continuous-batching request queue + in-flight ledger.

    ``max_attempts`` bounds how many times one request may be re-queued
    before its future is rejected with :class:`ServeRequestFailed`.
    """

    def __init__(
        self,
        batch_size: Optional[int] = None,
        batch_timeout_ms: Optional[float] = None,
        request_timeout_secs: Optional[float] = None,
        max_attempts: int = 5,
    ):
        self.batch_size = (
            batch_size if batch_size is not None else _env.serve_batch_size()
        )
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_timeout_ms = (
            batch_timeout_ms if batch_timeout_ms is not None
            else _env.serve_batch_timeout_ms()
        )
        self.request_timeout_secs = (
            request_timeout_secs if request_timeout_secs is not None
            else _env.serve_request_timeout_secs()
        )
        self.max_attempts = max_attempts
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._leases: Dict[int, BatchLease] = {}
        self._req_ids = itertools.count()
        self._lease_ids = itertools.count()
        self._closed = False
        self.n_submitted = 0
        self.n_resolved = 0
        self.n_requeued = 0
        self.n_batches = 0
        # Submit-to-answer seconds of the most recent resolved requests,
        # in order of resolution.
        self.latencies: deque = deque(maxlen=1 << 16)

    # -- ingress -----------------------------------------------------------

    def submit(self, payload: Any) -> ServeFuture:
        """Accept one single-example request; returns its future.

        Chaos site ``serve.request``: ``drop`` rejects here (the flaky
        ingress a client retries), ``delay`` stalls the enqueue."""
        if _chaos.enabled():
            fault = _chaos.act("serve.request")
            if fault is not None and fault.kind == "drop":
                raise ServeRequestDropped(
                    "chaos: injected serve request drop"
                )
        with self._cond:
            if self._closed:
                raise ServeRequestDropped("dispatcher is shut down")
            req = _Request(next(self._req_ids), payload)
            self._queue.append(req)
            self.n_submitted += 1
            self._cond.notify()
        return req.future

    # -- worker side -------------------------------------------------------

    def lease(self, worker: str, timeout: float = 0.2) -> Optional[BatchLease]:
        """Next batch for ``worker``, or None when nothing arrives within
        ``timeout``. The first request dispatches after at most
        ``batch_timeout_ms`` even if the batch is not full."""
        deadline = time.time() + timeout
        with self._cond:
            first = self._pop_live_locked()
            while first is None:
                remaining = deadline - time.time()
                if remaining <= 0 or self._closed:
                    return None
                self._cond.wait(remaining)
                first = self._pop_live_locked()
            taken = [first]
            fill_deadline = time.time() + self.batch_timeout_ms / 1e3
            while len(taken) < self.batch_size:
                nxt = self._pop_live_locked()
                if nxt is not None:
                    taken.append(nxt)
                    continue
                remaining = fill_deadline - time.time()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            for r in taken:
                r.attempts += 1
        # Pack outside the lock: staging scales with batch bytes and must
        # not serialize submits or other workers' leases behind it. Only
        # this thread holds the taken requests meanwhile.
        batch, spec = pack_requests(
            [r.payload for r in taken], self.batch_size
        )
        lease = BatchLease(
            next(self._lease_ids), worker, tuple(taken), batch, spec
        )
        with self._cond:
            self._leases[lease.lease_id] = lease
            self.n_batches += 1
        return lease

    def complete(self, lease: BatchLease, outputs: Any) -> int:
        """Resolve a whole lease from the batched model output; returns
        how many futures this call resolved."""
        responses = unpack_responses(outputs, lease.spec)
        resolved = 0
        for req, resp in zip(lease.requests, responses):
            if self._resolve_request(req, resp):
                resolved += 1
        with self._cond:
            self._leases.pop(lease.lease_id, None)
        return resolved

    def resolve(self, request_id: int, value: Any) -> bool:
        """Resolve ONE in-flight request by id -- the partial-completion
        path remote transports use (per-request responses arriving out of
        batch order, :mod:`.kv`). Retires the owning lease once every
        request in it is answered."""
        with self._cond:
            req = None
            owner: Optional[BatchLease] = None
            for lease in self._leases.values():
                for r in lease.requests:
                    if r.id == request_id:
                        req, owner = r, lease
                        break
                if req is not None:
                    break
            if req is None:
                # Re-queued copy still waiting? Answer it where it sits.
                for r in self._queue:
                    if r.id == request_id:
                        req = r
                        break
            if req is None:
                return False
        hit = self._resolve_request(req, value)
        if owner is not None and all(
            r.future.done() for r in owner.requests
        ):
            with self._cond:
                self._leases.pop(owner.lease_id, None)
        return hit

    def active_lease_ids(self) -> List[int]:
        with self._cond:
            return list(self._leases)

    def fail(self, lease: BatchLease, exc: Optional[BaseException] = None,
             requeue: bool = True) -> int:
        """A lease went bad: re-queue its unanswered requests at the FRONT
        of the queue. Requests over ``max_attempts`` are rejected instead.
        Returns how many were re-queued."""
        with self._cond:
            if self._leases.pop(lease.lease_id, None) is None:
                return 0  # already completed/reaped by someone else
            requeued = []
            for r in lease.requests:
                if r.future.done():
                    continue
                if not requeue or r.attempts >= self.max_attempts:
                    r.future._reject(
                        exc or ServeRequestFailed(
                            f"request {r.id} failed after {r.attempts} "
                            "attempts"
                        )
                    )
                    continue
                requeued.append(r)
            self._queue.extendleft(reversed(requeued))
            self.n_requeued += len(requeued)
            self._cond.notify_all()
        return len(requeued)

    def requeue_worker(self, worker: str) -> int:
        """Worker died: every lease it held goes back on the queue."""
        with self._cond:
            dead = [l for l in self._leases.values() if l.worker == worker]
        return sum(self.fail(lease) for lease in dead)

    def reap_expired(self, now: Optional[float] = None) -> int:
        """Re-queue leases older than ``request_timeout_secs`` (the worker
        is presumed hung or dead)."""
        now = time.time() if now is None else now
        with self._cond:
            expired = [
                l for l in self._leases.values()
                if now - l.t > self.request_timeout_secs
            ]
        return sum(self.fail(lease) for lease in expired)

    # -- books -------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def in_flight(self) -> int:
        with self._cond:
            return sum(
                sum(1 for r in l.requests if not r.future.done())
                for l in self._leases.values()
            )

    def in_flight_by_worker(self) -> Dict[str, int]:
        with self._cond:
            out: Dict[str, int] = {}
            for l in self._leases.values():
                out[l.worker] = out.get(l.worker, 0) + sum(
                    1 for r in l.requests if not r.future.done()
                )
            return out

    def close(self, reject_pending: bool = True) -> None:
        with self._cond:
            self._closed = True
            pending: List[_Request] = []
            leases: List[BatchLease] = []
            if reject_pending:
                pending = list(self._queue)
                self._queue.clear()
                leases = list(self._leases.values())
                self._leases.clear()
            self._cond.notify_all()
        for r in pending:
            r.future._reject(ServeRequestDropped("dispatcher shut down"))
        for lease in leases:
            for r in lease.requests:
                r.future._reject(ServeRequestDropped("dispatcher shut down"))

    # -- internals ---------------------------------------------------------

    def _pop_live_locked(self) -> Optional[_Request]:
        """Pop the next request whose future is still open (skipping
        re-queued duplicates that a late answer already resolved)."""
        while self._queue:
            r = self._queue.popleft()
            if not r.future.done():
                return r
        return None

    def _resolve_request(self, req: _Request, value: Any) -> bool:
        # A resolution is counted under the dispatcher's lock, by the settle
        # that wins and before it wakes the waiter, so a client that reads
        # the count after its result() returns sees it final.
        def count() -> None:
            self.n_resolved += 1
            self.latencies.append(time.time() - req.submit_t)

        with self._cond:
            return req.future._resolve(value, count)
