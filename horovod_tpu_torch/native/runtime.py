"""The dynamic-enqueue runtime: tensor queue, handles, background loop.

The port of the JAX package's native engine (``csrc/operations.cc``:
``BackgroundThreadLoop`` and ``RunLoopOnce`` at ``:1042-1200``,
``PerformOperation`` at ``:984``; ``csrc/tensor_queue.cc``,
``csrc/handle_manager.cc``, ``csrc/fusion_buffer.cc:7-18``) as a Python
thread on ``torch.distributed`` process groups of its own:

* any thread enqueues a named tensor (:meth:`Runtime.enqueue`) and gets an
  int handle (:class:`HandleManager`: allocate, mark done, poll, wait with
  a timeout, status, release); a name already in flight is refused;
* each cycle the background thread pops the new requests, looks each up in
  the response cache (a hit travels as a bit), negotiates once with the
  coordinator (:mod:`.controller`), fuses the agreed responses alike on
  every rank and performs them; busy cycles run back to back, an idle one
  sleeps ``HVDTPU_CYCLE_TIME`` milliseconds;
* the data plane is the runtime's gloo group for CPU tensors and its NCCL
  group for CUDA tensors (the tensor's device decides). Allreduces pack
  into one buffer a (device, dtype), kept and grown; prescale and
  postscale are applied as ``ScaleBuffer`` (``cpu_ops.cc:216``) does --
  in double, then rounded once to the dtype (integers truncated); an
  integer Average is a floor division. Adasum gathers every participant's
  buffer and folds them in fp64 in the native runtime's own tree (pairs
  (0, 1), (2, 3), ..., an odd last carried; one coefficient pair a packed
  tensor), which is not the VHDD of :mod:`..ops.adasum`;
* a rank that joined has no entries and still takes part in every
  collective of the ranks that did not: with the op's identity (zeros for
  a sum), zero rows for a gather, nothing for an alltoall;
* CUDA work runs on the runtime's own stream: it waits on the event the
  enqueueing thread recorded on its current stream, every tensor it touches
  gets ``record_stream``, and a completion event is recorded for
  :func:`~horovod_tpu_torch.native.synchronize`, which makes the caller's
  stream wait on it (never ``torch.cuda.synchronize``).

Under ``HVDTPU_AUTOTUNE`` (or ``HVT_AUTOTUNE``) rank 0 feeds each cycle's
negotiated bytes to its :class:`~.autotune.ParameterManager`
(``operations.cc:1140-1147``); when a sample window closes, the manager's
knobs go to the controller and ride the next response list to every rank.

Counters (``metrics_counters()``, process-cumulative like the reference's
``csrc/metrics.h``): cycles, fused tensors and batches, cache hits and
misses, ``shm_bytes`` (always 0: there is no shared-memory plane) and the
bytes the exchanges sent and received.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from . import messages as msg
from .autotune import ParameterManager
from .cache import CacheState, ResponseCache
from .controller import (
    Coordinator, GlooController, LocalController, aligned_size,
    fuse_responses, participants_of,
)
from .messages import (
    ADASUM, AVERAGE, MAX, MIN, PRODUCT, SUM, Request, RequestList,
    RequestType, Response, ResponseType,
)
from ..utils import env as _env

log = logging.getLogger("horovod_tpu_torch.native")

# Status classes (csrc/common.h StatusType).
OK, UNKNOWN_ERROR, PRECONDITION_ERROR, ABORTED, INVALID_ARGUMENT, \
    IN_PROGRESS = range(6)


@dataclasses.dataclass
class Status:
    type: int = OK
    reason: str = ""

    @property
    def ok(self) -> bool:
        return self.type == OK


class Counters:
    """Process-cumulative counters of the runtime (they outlive a
    shutdown and a re-init, as the reference's do)."""

    NAMES = ("cycles", "fused_tensors", "fused_batches", "cache_hits",
             "cache_misses", "shm_bytes", "bytes_sent", "bytes_received")

    def __init__(self):
        for n in self.NAMES:
            setattr(self, n, 0)

    def snapshot(self) -> Dict[str, int]:
        return {n: int(getattr(self, n)) for n in self.NAMES}


COUNTERS = Counters()


@dataclasses.dataclass
class Entry:
    """One named in-flight tensor (``TensorTableEntry``)."""

    name: str
    type: RequestType
    input: Optional[torch.Tensor] = None
    output: Optional[torch.Tensor] = None
    handle: int = -1
    # CUDA: the event recorded on the enqueueing thread's current stream,
    # and the completion event on the runtime's stream.
    ready: Any = None
    ready_stream: int = 0  # the raw stream the ready event was recorded on
    seq: int = 0  # enqueue order (events of one stream complete in it)
    done: Any = None
    result: Any = None  # allgather / alltoall output; join's last rank
    recv_splits: Optional[List[int]] = None
    owned: bool = False  # result allocated by the runtime


class HandleManager:
    """``csrc/handle_manager.cc``: poll/wait-based async handles."""

    def __init__(self):
        self._cv = threading.Condition()
        self._records: Dict[int, list] = {}  # handle -> [done, status, entry]
        self._next = 0

    def allocate(self) -> int:
        with self._cv:
            h = self._next
            self._next += 1
            self._records[h] = [False, Status(), None]
            return h

    def mark_done(self, handle: int, status: Status,
                  entry: Optional[Entry] = None) -> None:
        with self._cv:
            rec = self._records.get(handle)
            if rec is None:
                return
            rec[0], rec[1] = True, status
            if entry is not None:
                rec[2] = entry
            self._cv.notify_all()

    def mark_done_many(self, entries: List[Entry], status: Status) -> None:
        """Complete a batch's entries under one lock and one wake-up."""
        with self._cv:
            for e in entries:
                rec = self._records.get(e.handle)
                if rec is not None:
                    rec[0], rec[1], rec[2] = True, status, e
            self._cv.notify_all()

    def poll(self, handle: int) -> bool:
        with self._cv:
            rec = self._records.get(handle)
            return rec is None or rec[0]

    def wait(self, handle: int, timeout: float = -1.0) -> bool:
        """False on timeout (a negative timeout waits for ever)."""
        def done():
            rec = self._records.get(handle)
            return rec is None or rec[0]

        with self._cv:
            return self._cv.wait_for(
                done, None if timeout is None or timeout < 0 else timeout)

    def status(self, handle: int) -> Status:
        with self._cv:
            rec = self._records.get(handle)
            if rec is None:
                return Status(INVALID_ARGUMENT, "unknown handle")
            return rec[1] if rec[0] else Status(IN_PROGRESS)

    def entry(self, handle: int) -> Optional[Entry]:
        with self._cv:
            rec = self._records.get(handle)
            return rec[2] if rec is not None and rec[0] else None

    def release(self, handle: int) -> None:
        with self._cv:
            self._records.pop(handle, None)


class TensorQueue:
    """``csrc/tensor_queue.cc``: the in-flight table and the requests
    pending since the last cycle."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[str, Entry] = {}
        self._pending: List[Request] = []

    def add(self, entry: Entry, request: Request) -> Status:
        with self._lock:
            if entry.name in self._table:
                return Status(
                    INVALID_ARGUMENT,
                    f'Requested to collective-process tensor name '
                    f'"{entry.name}" which is already in flight; multiple '
                    f'concurrent uses of one name are not allowed')
            self._pending.append(request)
            self._table[entry.name] = entry
            return Status()

    def pop_requests(self) -> List[Request]:
        with self._lock:
            out, self._pending = self._pending, []
            return out

    def take(self, names: List[str]) -> List[Entry]:
        """The entries of ``names`` this rank holds, out of the table."""
        with self._lock:
            taken = [self._table.pop(n, None) for n in names]
        return [e for e in taken if e is not None]

    def abort_all(self) -> List[Entry]:
        with self._lock:
            victims = list(self._table.values())
            self._table.clear()
            self._pending.clear()
            return victims


class FusionBuffers:
    """One persistent staging buffer a (device, dtype), grown on demand
    (``csrc/fusion_buffer.cc:7-18``)."""

    def __init__(self):
        self._bufs: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}

    def get(self, device: torch.device, dtype: torch.dtype,
            numel: int) -> torch.Tensor:
        key = (str(device), dtype)
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < numel:
            buf = torch.empty(numel, dtype=dtype, device=device)
            self._bufs[key] = buf
        return buf[:numel]


@dataclasses.dataclass
class Knobs:
    """The runtime's knobs (``csrc/env_parser.cc`` ParseKnobs), each read
    as ``HVT_<NAME>``, ``HVDTPU_<NAME>`` or ``HOROVOD_<NAME>``."""

    fusion_threshold: int = _env.DEFAULT_FUSION_THRESHOLD
    cycle_time_us: int = int(_env.DEFAULT_CYCLE_TIME_MS * 1000)
    cache_capacity: int = _env.DEFAULT_CACHE_CAPACITY
    stall_warning_secs: float = _env.DEFAULT_STALL_WARNING_SECS
    stall_shutdown_secs: float = 0.0
    timeline: str = ""
    timeline_mark_cycles: bool = False
    disable_group_fusion: bool = False
    autotune: bool = False
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10

    @classmethod
    def from_env(cls) -> "Knobs":
        import os

        def num(name, default, kind):
            val = _env.native_knob(name)
            try:
                return kind(val) if val is not None else default
            except ValueError:
                return default

        def flag(name):
            val = _env.native_knob(name)
            return bool(val) and val[0] in "1tTyY"

        k = cls()
        k.fusion_threshold = num(_env.FUSION_THRESHOLD, k.fusion_threshold,
                                 int)
        # HVT_CYCLE_TIME_MS is the native runtime's older spelling.
        cycle_ms = num(_env.CYCLE_TIME, k.cycle_time_us / 1000.0, float)
        if not os.environ.get("HVT_CYCLE_TIME") and \
                os.environ.get("HVT_CYCLE_TIME_MS"):
            try:
                cycle_ms = float(os.environ["HVT_CYCLE_TIME_MS"])
            except ValueError:
                pass
        k.cycle_time_us = int(cycle_ms * 1000.0)
        k.cache_capacity = num(_env.CACHE_CAPACITY, k.cache_capacity, int)
        k.stall_warning_secs = num(_env.STALL_CHECK_TIME_SECONDS,
                                   k.stall_warning_secs, float)
        if flag(_env.STALL_CHECK_DISABLE):
            k.stall_warning_secs = 0.0
        k.stall_shutdown_secs = num(_env.STALL_SHUTDOWN_TIME_SECONDS, 0.0,
                                    float)
        k.timeline = _env.native_knob(_env.TIMELINE) or ""
        k.timeline_mark_cycles = flag(_env.TIMELINE_MARK_CYCLES)
        k.disable_group_fusion = flag(_env.DISABLE_GROUP_FUSION)
        k.autotune = flag(_env.AUTOTUNE)
        k.autotune_log = _env.native_knob(_env.AUTOTUNE_LOG) or ""
        k.autotune_warmup_samples = num("AUTOTUNE_WARMUP_SAMPLES",
                                        k.autotune_warmup_samples, int)
        k.autotune_steps_per_sample = num("AUTOTUNE_STEPS_PER_SAMPLE",
                                          k.autotune_steps_per_sample, int)
        return k


_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
# Dtypes neither gloo nor NCCL reduces: reduced widened (sums wrap alike).
_WIDEN = {torch.int16: torch.int32}
if hasattr(torch, "uint16"):
    _WIDEN[torch.uint16] = torch.int32


def scale_buffer(buf: torch.Tensor, scale: float) -> None:
    """``ScaleBuffer`` (``cpu_ops.cc:216``): each element times ``scale``
    in double, rounded once to its dtype (half types through fp32, as the
    reference narrows; integers truncated toward zero); bools unchanged."""
    if scale == 1.0 or buf.dtype == torch.bool:
        return
    if buf.dtype == torch.float64:
        buf.mul_(scale)
        return
    wide = buf.double() * scale
    if buf.dtype in (torch.float16, torch.bfloat16):
        wide = wide.float()
    elif not buf.dtype.is_floating_point:
        wide = wide.trunc()
    buf.copy_(wide)


def identity(op: int, dtype: torch.dtype):
    """The value a joined rank contributes to a reduction."""
    if dtype == torch.bool:
        return op in (MIN, PRODUCT)
    if op == MIN:
        return float("inf") if dtype in _FLOATS else torch.iinfo(dtype).max
    if op == MAX:
        return float("-inf") if dtype in _FLOATS else torch.iinfo(dtype).min
    return 1 if op == PRODUCT else 0


def _dist_op(op: int, dtype: torch.dtype):
    if dtype == torch.bool:  # logical: or for sums and max, and otherwise
        return dist.ReduceOp.MAX if op in (SUM, AVERAGE, MAX) \
            else dist.ReduceOp.MIN
    return {SUM: dist.ReduceOp.SUM, AVERAGE: dist.ReduceOp.SUM,
            MIN: dist.ReduceOp.MIN, MAX: dist.ReduceOp.MAX,
            PRODUCT: dist.ReduceOp.PRODUCT}[op]


def adasum_fold(vecs: List[torch.Tensor], starts: List[int]) -> torch.Tensor:
    """The native runtime's Adasum tree in fp64: adjacent pairs fold as
    ``ca * a + cb * b`` with ``ca = 1 - a.b / (2 |a|^2)`` (1 where
    ``|a| = 0``), ``cb`` alike, one coefficient pair a segment (a packed
    tensor, from its element offset in ``starts`` to the next); an odd
    last vector is carried to the next level."""
    n = vecs[0].numel()
    bounds = list(starts) + [n]
    lens = torch.tensor([b - a for a, b in zip(bounds, bounds[1:])],
                        device=vecs[0].device)
    seg = torch.repeat_interleave(
        torch.arange(len(starts), device=vecs[0].device), lens)

    def seg_sum(x):
        return torch.zeros(len(starts), dtype=torch.float64,
                           device=x.device).index_add_(0, seg, x)

    def pair(a, b):
        dot, na, nb = seg_sum(a * b), seg_sum(a * a), seg_sum(b * b)
        ca = torch.where(na > 0, 1.0 - dot / (2 * na), torch.ones_like(na))
        cb = torch.where(nb > 0, 1.0 - dot / (2 * nb), torch.ones_like(nb))
        return ca[seg] * a + cb[seg] * b

    while len(vecs) > 1:
        nxt = [pair(vecs[i], vecs[i + 1]) for i in range(0, len(vecs) - 1, 2)]
        if len(vecs) % 2:
            nxt.append(vecs[-1])
        vecs = nxt
    return vecs[0]


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view (a copy only when ``t`` is not contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _prod(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


class Runtime:
    """One process's runtime: its groups, queue, handles and thread."""

    def __init__(self, rank: int, size: int, gloo_pg, nccl_pg,
                 device: torch.device, knobs: Optional[Knobs] = None):
        from ..utils.timeline import Timeline

        self.rank, self.size = rank, size
        self.gloo, self.nccl = gloo_pg, nccl_pg
        self.device = device  # torch.device("cpu") or the card
        self.knobs = knobs or Knobs.from_env()
        self.queue = TensorQueue()
        self.handles = HandleManager()
        self.record_lock = threading.Lock()
        self.record_seq = itertools.count()
        self.fusion = FusionBuffers()
        self.cache = ResponseCache(self.knobs.cache_capacity)
        self.in_flight: Dict[str, Request] = {}
        coord = None
        if rank == 0:
            coord = Coordinator(
                size, self.cache, self.knobs.stall_warning_secs or None,
                self.knobs.stall_shutdown_secs)
        self.controller = (LocalController(coord) if size == 1 else
                           GlooController(gloo_pg, rank, size, coord))
        self.controller.set_knobs(self.knobs.fusion_threshold,
                                  self.knobs.cycle_time_us)
        # Every rank holds a manager (autotune_best answers everywhere, as
        # the reference's does); rank 0 alone updates it and writes its log.
        self.autotune = ParameterManager()
        if self.knobs.autotune:
            self.autotune.initialize(
                self.knobs.fusion_threshold, self.knobs.cycle_time_us,
                self.knobs.autotune_log if rank == 0 else "",
                self.knobs.autotune_warmup_samples,
                self.knobs.autotune_steps_per_sample)
        # (negotiation, fusion threshold, cycle us) at each change of the
        # knobs the coordinator's lists carried, from the first on.
        self.applied_knobs: List[Tuple[int, int, int]] = []
        self.negotiations = 0
        path = self.knobs.timeline
        if path and size > 1:
            path += f".{rank}"
        self.timeline = Timeline(path or None,
                                 mark_cycles=self.knobs.timeline_mark_cycles)
        if path:
            self.timeline.start()
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
        self._shutdown = threading.Event()
        self.alive = False
        self.error: Optional[str] = None
        self._thread = threading.Thread(
            target=self._loop, name="hvt-runtime", daemon=True)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self.alive = True
        self._thread.start()

    def shutdown(self) -> None:
        """Request shutdown (every rank must) and wait for the loop."""
        self._shutdown.set()
        if self._thread.is_alive():
            self._thread.join()
        self.timeline.stop()
        self.autotune.close()
        # The communicators go with the runtime; after a failure a peer may
        # be gone, and only an abort cannot wait for it.
        end = "abort" if self.error else "shutdown"
        for pg in (self.nccl, self.gloo):
            if pg is not None and hasattr(pg, end):
                getattr(pg, end)()

    def _loop(self) -> None:
        torch.set_grad_enabled(False)  # thread-local: the loop's copies
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            # The thread's current stream, once: every CUDA op of the
            # loop runs on the runtime's own stream.
            torch.cuda.set_stream(self.stream)
        try:
            while self._cycle():
                pass
            reason = "Horovod-TPU runtime shut down"
        except Exception as exc:  # the runtime is dead: fail every handle
            log.exception("runtime cycle failed")
            reason = f"collective negotiation or data plane failed: {exc}"
            self.error = reason
        self.alive = False
        self._abort(Status(ABORTED, reason))

    def _abort(self, status: Status) -> None:
        for e in self.queue.abort_all():
            self.handles.mark_done(e.handle, status)
        self.in_flight.clear()

    # -- enqueue ---------------------------------------------------------
    def enqueue(self, entry: Entry, request: Request) -> int:
        handle = self.handles.allocate()
        entry.handle = handle
        request.rank = self.rank
        self.timeline.start_activity(entry.name, "NEGOTIATE")
        status = self.queue.add(entry, request)
        if not status.ok:
            self.handles.mark_done(handle, status)
        return handle

    # -- one cycle (RunLoopOnce) -----------------------------------------
    def _cycle(self) -> bool:
        start = time.perf_counter()
        COUNTERS.cycles += 1
        popped = self.queue.pop_requests()
        mine = RequestList()
        bits = []
        for req in popped:
            if req.type == RequestType.JOIN:
                mine.requests.append(req)
                continue
            state = self.cache.lookup(req)
            self.in_flight[req.name] = req
            if state == CacheState.HIT:
                COUNTERS.cache_hits += 1
                bits.append(self.cache.bit_of(req.name))
            else:
                COUNTERS.cache_misses += 1
                mine.requests.append(req)
        mine.cache_bits = self.cache.make_bitvector(bits)
        mine.shutdown = self._shutdown.is_set()
        if (self.size == 1 and not popped and not mine.shutdown
                and not self.controller.coordinator.pending):
            # A world of one with nothing new and nothing pending: the
            # coordinator's answer is empty, so an idle cycle only pauses.
            self.timeline.mark_cycle()
            self._pause(start, self.controller.cycle_time_us
                        or self.knobs.cycle_time_us)
            return True
        sent0 = self.controller.bytes_sent
        recv0 = self.controller.bytes_received
        lst = self.controller.negotiate(mine)
        self.negotiations += 1
        knobs = (lst.fusion_threshold_bytes, lst.cycle_time_us)
        if not self.applied_knobs or self.applied_knobs[-1][1:] != knobs:
            self.applied_knobs.append((self.negotiations,) + knobs)
        COUNTERS.bytes_sent += self.controller.bytes_sent - sent0
        COUNTERS.bytes_received += self.controller.bytes_received - recv0

        # Cache hits expand from the local cache (identical on every rank);
        # fresh negotiations enter it in broadcast order.
        responses: List[Response] = []
        for bit in self.cache.bits_from_vector(lst.cache_hit_bits):
            responses.append(self.cache.response_at(bit))
            self.cache.touch(bit)
        for r in lst.responses:
            responses.append(r)
            cacheable = (not r.error_message and len(r.names) == 1
                         and not r.participants
                         and r.type not in (ResponseType.JOIN,
                                            ResponseType.BARRIER))
            if cacheable and r.names[0] in self.in_flight:
                self.cache.put(self.in_flight[r.names[0]], r)
        nbytes: Dict[str, int] = {}
        groups: Dict[str, str] = {}
        for r in responses:
            for name in r.names:
                nbytes[name] = r.fusion_bytes
                if r.group_name:
                    groups[name] = r.group_name
        threshold = (lst.fusion_threshold_bytes
                     or self.knobs.fusion_threshold)
        fused = fuse_responses(responses, threshold,
                               self.knobs.disable_group_fusion, nbytes,
                               groups)
        for r in fused:
            if r.names:
                COUNTERS.fused_batches += 1
                COUNTERS.fused_tensors += len(r.names)
            self._perform(r, nbytes)
        # Autotune on the coordinator: the tuned knobs ride the next
        # cycle's response list to every rank.
        if self.rank == 0 and self.autotune.active and not self.autotune.done:
            if self.autotune.update(sum(nbytes.values())):
                self.controller.set_knobs(*self.autotune.current)
        self.timeline.mark_cycle()
        if lst.shutdown:
            return False
        # Busy cycles run back to back; only an idle one pauses.
        if not popped and not fused:
            self._pause(start, lst.cycle_time_us or self.knobs.cycle_time_us)
        return True

    @staticmethod
    def _pause(start: float, cycle_us: int) -> None:
        left = start + cycle_us / 1e6 - time.perf_counter()
        if left > 0:
            time.sleep(left)

    # -- PerformOperation ------------------------------------------------
    def _complete(self, e: Entry, status: Status) -> None:
        self.timeline.end_activity(e.name, e.type.name)
        self.in_flight.pop(e.name, None)
        self.handles.mark_done(e.handle, status, e)

    def _perform(self, resp: Response, nbytes: Dict[str, int]) -> None:
        for name in resp.names:
            self.timeline.end_activity(name, "NEGOTIATE")
        entries = self.queue.take(resp.names)
        for e in entries:
            self.timeline.start_activity(e.name, e.type.name)
        if resp.type == ResponseType.ERROR:
            for e in entries:
                self._complete(e, Status(PRECONDITION_ERROR,
                                         resp.error_message))
            return
        if resp.type in (ResponseType.JOIN, ResponseType.BARRIER):
            for e in entries:
                e.result = resp.last_joined_rank
                self._complete(e, Status())
            return
        parts = participants_of(resp, self.size)
        run = {
            ResponseType.ALLREDUCE: self._allreduce,
            ResponseType.ALLGATHER: self._allgather,
            ResponseType.BROADCAST: self._broadcast,
            ResponseType.ALLTOALL: self._alltoall,
            ResponseType.REDUCESCATTER: self._reducescatter,
        }[resp.type]
        if resp.device == "cuda":
            s = self.stream  # the loop thread's current stream
            # Events of one stream complete in the order they were
            # recorded: waiting on each stream's last one covers the rest.
            last = {}
            for e in entries:
                if e.ready is not None and (
                        e.ready_stream not in last
                        or e.seq > last[e.ready_stream].seq):
                    last[e.ready_stream] = e
            for e in last.values():
                s.wait_event(e.ready)
            for e in entries:
                e.input.record_stream(s)
                if (e.output is not None
                        and e.output.data_ptr() != e.input.data_ptr()):
                    e.output.record_stream(s)
            run(resp, entries, parts, nbytes)
            done = torch.cuda.Event()
            done.record(s)
            for e in entries:
                e.done = done
        else:
            run(resp, entries, parts, nbytes)
        for e in entries:
            self.timeline.end_activity(e.name, e.type.name)
            self.in_flight.pop(e.name, None)
        self.handles.mark_done_many(entries, Status())

    def _dev(self, resp: Response) -> torch.device:
        return self.device if resp.device == "cuda" else torch.device("cpu")

    def _pg(self, resp: Response):
        return self.nccl if resp.device == "cuda" else self.gloo

    def _count(self, sent: int, received: int) -> None:
        if self.size > 1:
            COUNTERS.bytes_sent += sent
            COUNTERS.bytes_received += received

    def _reduce(self, pg, buf: torch.Tensor, op: int) -> None:
        t = buf.view(torch.uint8) if buf.dtype == torch.bool else buf
        wide = _WIDEN.get(buf.dtype)
        if wide is not None:
            t = buf.to(wide)
        opts = dist.AllreduceOptions()
        opts.reduceOp = _dist_op(op, buf.dtype)
        pg.allreduce([t], opts).wait()
        if wide is not None:
            buf.copy_(t)
        n = buf.numel() * buf.element_size()
        self._count(n, n)

    def _gather_bytes(self, pg, data: torch.Tensor) -> List[torch.Tensor]:
        outs = [torch.empty_like(data) for _ in range(self.size)]
        pg.allgather([outs], [data]).wait()
        self._count(data.numel(), data.numel() * (self.size - 1))
        return outs

    def _finish_average(self, buf: torch.Tensor, op: int, post: float,
                        n: int) -> None:
        if op == AVERAGE:
            if buf.dtype.is_floating_point:
                post = post / n
            elif buf.dtype != torch.bool:
                buf.copy_(torch.div(buf, n, rounding_mode="floor"))
        scale_buffer(buf, post)

    def _allreduce(self, resp, entries, parts, nbytes) -> None:
        dtype = msg.DTYPES[resp.dtype]
        op = resp.reduce_op
        pg = self._pg(resp)
        item = msg.element_size(resp.dtype)
        if len(resp.names) == 1 and op != ADASUM:
            # One tensor, unpadded on every rank: reduced in its own output
            # when that is contiguous (the same elementwise arithmetic as
            # packed), a joined rank's identity in the fusion buffer.
            n = nbytes[resp.names[0]] // item
            e = entries[0] if entries else None
            if e is not None and e.output.is_contiguous():
                out = e.output.view(-1)
            else:
                out = self.fusion.get(self._dev(resp), dtype, n)
            if e is None:
                out.fill_(identity(op, dtype))
                self._reduce(pg, out, op)
                return
            if out.data_ptr() != e.input.data_ptr():
                out.copy_(e.input.reshape(-1))
            scale_buffer(out, resp.prescale)
            self._reduce(pg, out, op)
            self._finish_average(out, op, resp.postscale, len(parts))
            if out.data_ptr() != e.output.data_ptr():
                e.output.copy_(out.view(e.output.shape))
            return
        offs, counts, total = [], [], 0
        for name in resp.names:
            offs.append(total)
            counts.append(nbytes[name] // item)
            total += aligned_size(nbytes[name]) // item
        buf = self.fusion.get(self._dev(resp), dtype, total)
        slots = [buf[o:o + n] for o, n in zip(offs, counts)]
        by_name = {e.name: e for e in entries}
        if self.rank in parts:
            if op == ADASUM:
                buf.zero_()  # the padding enters the dot products
            many = len(entries) > 1
            if many:
                self.timeline.start_activity(entries[0].name,
                                             "MEMCPY_IN_FUSION_BUFFER")
            torch._foreach_copy_(slots, [by_name[name].input.reshape(-1)
                                         for name in resp.names])
            if many:
                self.timeline.end_activity(entries[0].name,
                                           "MEMCPY_IN_FUSION_BUFFER")
            scale_buffer(buf, resp.prescale)
        else:
            buf.fill_(identity(op, dtype))
        if op == ADASUM:
            rows = self._gather_bytes(pg, buf.view(torch.uint8))
            folded = adasum_fold(
                [rows[r].view(dtype).double() for r in parts], offs)
            if dtype in (torch.float16, torch.bfloat16):
                folded = folded.float()
            buf.copy_(folded)
        else:
            self._reduce(pg, buf, op)
        if not entries:
            return
        self._finish_average(buf, op, resp.postscale, len(parts))
        outs = [by_name[name].output for name in resp.names]
        if all(o.is_contiguous() for o in outs):
            torch._foreach_copy_([o.view(-1) for o in outs], slots)
        else:
            for o, slot in zip(outs, slots):
                o.copy_(slot.view(o.shape))

    def _allgather(self, resp, entries, parts, nbytes) -> None:
        e = entries[0] if entries else None
        row = _prod(resp.shape[1:]) * msg.element_size(resp.dtype)
        sizes = list(resp.sizes)
        send = torch.zeros(max(sizes) * row, dtype=torch.uint8,
                           device=self._dev(resp))
        if e is not None:
            data = _bytes_of(e.input)
            send[:data.numel()].copy_(data)
        rows = self._gather_bytes(self._pg(resp), send)
        if e is None:
            return
        out = torch.cat([rows[r][:n * row] for r, n in zip(parts, sizes)])
        e.result = out.view(msg.DTYPES[resp.dtype]).view(
            (sum(sizes),) + tuple(resp.shape[1:]))
        e.owned = True

    def _broadcast(self, resp, entries, parts, nbytes) -> None:
        e = entries[0] if entries else None
        if e is not None and e.output.is_contiguous():
            data = e.output.view(-1).view(torch.uint8)
            if self.rank == resp.root_rank and e.input is not e.output:
                data.copy_(_bytes_of(e.input))
        else:
            data = torch.empty(resp.fusion_bytes, dtype=torch.uint8,
                               device=self._dev(resp))
            if e is not None and self.rank == resp.root_rank:
                data.copy_(_bytes_of(e.input))
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = resp.root_rank, 0
        self._pg(resp).broadcast([data], opts).wait()
        n = data.numel()
        self._count(n if self.rank == resp.root_rank else 0,
                    0 if self.rank == resp.root_rank else n)
        if e is not None and data.data_ptr() != e.output.data_ptr():
            e.output.copy_(data.view(e.output.dtype).view(e.output.shape))

    def _alltoall(self, resp, entries, parts, nbytes) -> None:
        e = entries[0] if entries else None
        n = len(parts)
        m = parts.index(self.rank) if self.rank in parts else -1
        sizes = list(resp.sizes)
        row = _prod(resp.shape[1:]) * msg.element_size(resp.dtype)
        send = [0] * self.size
        recv = [0] * self.size
        if m >= 0:
            for j, p in enumerate(parts):
                send[p] = sizes[m * n + j] * row
                recv[p] = sizes[j * n + m] * row
        dev = self._dev(resp)
        inp = _bytes_of(e.input) if e is not None else torch.empty(
            0, dtype=torch.uint8, device=dev)
        out = torch.empty(sum(recv), dtype=torch.uint8, device=dev)
        self._pg(resp).alltoall_base(out, inp, recv, send,
                                     dist.AllToAllOptions()).wait()
        self._count(sum(send) - (send[self.rank] if m >= 0 else 0),
                    sum(recv) - (recv[self.rank] if m >= 0 else 0))
        if e is None:
            return
        rows = [sizes[j * n + m] for j in range(n)]
        e.result = out.view(msg.DTYPES[resp.dtype]).view(
            (sum(rows),) + tuple(resp.shape[1:]))
        e.recv_splits = rows
        e.owned = True

    def _reducescatter(self, resp, entries, parts, nbytes) -> None:
        e = entries[0] if entries else None
        dtype = msg.DTYPES[resp.dtype]
        dim0 = resp.sizes[0]
        row = _prod(resp.shape[1:])
        per = dim0 // self.size
        buf = self.fusion.get(self._dev(resp), dtype, dim0 * row)
        op = resp.reduce_op
        if e is not None:
            buf.copy_(e.input.reshape(-1))
            scale_buffer(buf, resp.prescale)
        else:
            buf.fill_(identity(op, dtype))
        self._reduce(self._pg(resp), buf, op)
        if e is None:
            return
        shard = buf[self.rank * per * row:(self.rank + 1) * per * row]
        self._finish_average(shard, op, resp.postscale, len(parts))
        e.output.copy_(shard.view(e.output.shape))
