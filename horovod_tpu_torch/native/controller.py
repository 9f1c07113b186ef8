"""Negotiation: which named tensors are globally ready this cycle?

The port of the JAX package's native controller (``csrc/controller.cc``,
declared at ``controller.h:44-80``; reference ``horovod/common/
controller.cc`` ComputeResponseList / ConstructResponse / FuseResponses):

* :class:`Coordinator` (rank 0) accumulates readiness across cycles -- a
  rank sends a request once, not once a cycle -- from full descriptors and
  from response-cache bits, checks that every rank asked for the same
  collective (the reference's error text: ``Mismatched ...``), holds an
  explicit group until all its members are ready (:class:`GroupTable`),
  keeps Join's participant lists, and emits the ready tensors in name
  order: cache hits as bits, the rest as :class:`~.messages.Response`.
* :func:`fuse_responses` is the deterministic fusion pass every rank runs
  alike on the agreed list: allreduces of one dtype, op, scales,
  participants and device merge up to the fusion threshold; an explicit
  group always merges, and with ``HVDTPU_DISABLE_GROUP_FUSION`` never with
  outsiders.
* :class:`LocalController` serves a world of one (``operations.cc:1189``).
* :class:`GlooController` takes the place of ``TcpController::Negotiate``
  (``:724``): one exchange a cycle on the runtime's own gloo group -- every
  rank's request list in one ``allgather`` of fixed slots, rank 0's answer
  (the response list and the knobs it synced) in one ``broadcast``; a list
  longer than its slot takes one more exchange of the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set

import torch

from . import messages as msg
from .cache import ResponseCache
from .messages import (
    Request, RequestList, RequestType, Response, ResponseList, ResponseType,
)

FUSION_ALIGN = 64  # bytes: every packed tensor starts 64-byte aligned


def aligned_size(nbytes: int) -> int:
    return (nbytes + FUSION_ALIGN - 1) // FUSION_ALIGN * FUSION_ALIGN


class GroupTable:
    """Explicit grouped collectives (``csrc/group_table.cc``): tensors
    enqueued under one group name are all globally ready before any of
    them runs, and fuse into one data-plane call."""

    def __init__(self):
        self._groups: Dict[str, List[str]] = {}
        self._member_to_group: Dict[str, str] = {}

    def register(self, group: str, members: Sequence[str]) -> None:
        lst = self._groups.setdefault(group, [])
        for m in members:
            if m not in self._member_to_group:
                self._member_to_group[m] = group
                lst.append(m)

    def members(self, group: str) -> List[str]:
        return list(self._groups.get(group, ()))

    def all_members_ready(self, group: str, ready: Set[str]) -> bool:
        members = self._groups.get(group)
        return members is not None and all(m in ready for m in members)

    def erase(self, group: str) -> None:
        for m in self._groups.pop(group, ()):
            self._member_to_group.pop(m, None)


@dataclasses.dataclass
class _Pending:
    first: Request
    ranks: Set[int] = dataclasses.field(default_factory=set)
    from_cache: bool = False
    error: str = ""  # non-empty: the ranks asked for different collectives
    rank_dim0: Dict[int, int] = dataclasses.field(default_factory=dict)
    rank_splits: Dict[int, tuple] = dataclasses.field(default_factory=dict)


_RESPONSE_OF = {
    RequestType.ALLREDUCE: ResponseType.ALLREDUCE,
    RequestType.ALLGATHER: ResponseType.ALLGATHER,
    RequestType.BROADCAST: ResponseType.BROADCAST,
    RequestType.ALLTOALL: ResponseType.ALLTOALL,
    RequestType.REDUCESCATTER: ResponseType.REDUCESCATTER,
    RequestType.BARRIER: ResponseType.BARRIER,
    RequestType.JOIN: ResponseType.JOIN,
}


class Coordinator:
    """Rank 0's bookkeeping (``controller.cc:33-270``). ``stall_warning``
    seconds arm the stall inspector (None: off); a stall past
    ``stall_shutdown`` seconds (0: never) shuts the runtime down."""

    def __init__(self, world_size: int, cache: ResponseCache,
                 stall_warning: Optional[float] = None,
                 stall_shutdown: float = 0.0):
        self.size = world_size
        self.cache = cache
        self.stall = None
        if stall_warning:
            from ..utils.stall import StallInspector

            self.stall = StallInspector(
                warning_time=stall_warning, shutdown_time=stall_shutdown,
                on_shutdown=self._stalled)
            self.stall.enabled = True  # the runtime's knobs decided
        self.pending: Dict[str, _Pending] = {}
        self.joined: Set[int] = set()
        self.last_joined_rank = -1
        self.shutdown_ranks: Set[int] = set()
        self.groups = GroupTable()
        self.stall_shutdown = False

    def _stalled(self, names) -> None:
        self.stall_shutdown = True

    def all_ranks_requested_shutdown(self) -> bool:
        return len(self.shutdown_ranks) == self.size

    def check_match(self, p: _Pending, req: Request, rank: int) -> None:
        f = p.first
        name = req.name
        err = ""
        if req.type != f.type:
            err = (f"Mismatched collective operations: rank {f.rank} "
                   f"requested {f.type.name} but rank {rank} requested "
                   f"{req.type.name} for tensor {name}.")
        elif req.dtype != f.dtype:
            err = (f"Mismatched data types: rank {f.rank} has "
                   f"{msg.DTYPE_NAMES[f.dtype]} but rank {rank} has "
                   f"{msg.DTYPE_NAMES[req.dtype]} for tensor {name}.")
        elif req.device != f.device:
            err = (f"Mismatched devices: rank {f.rank} has {f.device} but "
                   f"rank {rank} has {req.device} for tensor {name}.")
        elif req.type in (RequestType.ALLREDUCE, RequestType.BROADCAST,
                          RequestType.REDUCESCATTER):
            if tuple(req.shape) != tuple(f.shape):
                err = (f"Mismatched {req.type.name} tensor shapes: rank "
                       f"{f.rank} has {msg.shape_string(f.shape)} but rank "
                       f"{rank} has {msg.shape_string(req.shape)} for "
                       f"tensor {name}.")
            elif req.type == RequestType.ALLREDUCE and (
                    req.reduce_op != f.reduce_op
                    or req.prescale != f.prescale
                    or req.postscale != f.postscale):
                err = ("Mismatched reduce op or scale factors across ranks "
                       f"for tensor {name}.")
            elif (req.type == RequestType.BROADCAST
                  and req.root_rank != f.root_rank):
                err = (f"Mismatched broadcast root ranks: rank {f.rank} has "
                       f"root {f.root_rank} but rank {rank} has root "
                       f"{req.root_rank} for tensor {name}.")
        elif req.type in (RequestType.ALLGATHER, RequestType.ALLTOALL):
            # The first dimension may differ; the rest must match.
            if (len(req.shape) != len(f.shape) or not req.shape
                    or tuple(req.shape[1:]) != tuple(f.shape[1:])):
                err = (f"Mismatched {req.type.name} tensor shapes beyond "
                       f"the first dimension: rank {f.rank} has "
                       f"{msg.shape_string(f.shape)} but rank {rank} has "
                       f"{msg.shape_string(req.shape)} for tensor {name}.")
        if err and not p.error:
            p.error = err

    def _note(self, p: _Pending, req: Request, rank: int) -> None:
        p.ranks.add(rank)
        p.rank_dim0[rank] = req.shape[0] if req.shape else 1
        if req.splits:
            p.rank_splits[rank] = tuple(req.splits)
        if req.group_name and req.group_size > 0:
            self.groups.register(req.group_name, [req.name])
        if self.stall is not None:
            self.stall.record_uncached_tensor(req.name, rank)

    def ingest(self, lst: RequestList, rank: int) -> None:
        """Record one rank's newly pending requests; cache bits translate
        to descriptors through this rank's own cache, which equals the
        sender's (every cache change happens after a cycle's ingest)."""
        if lst.shutdown:
            self.shutdown_ranks.add(rank)
        for bit in self.cache.bits_from_vector(lst.cache_bits):
            if not self.cache.has_bit(bit):
                continue  # a stale slot: the sender renegotiates
            req = self.cache.request_at(bit)
            if req.rank != rank:
                req = dataclasses.replace(req, rank=rank)
            p = self.pending.get(req.name)
            if p is None:
                p = self.pending[req.name] = _Pending(req, from_cache=True)
            self._note(p, req, rank)
        for req in lst.requests:
            if req.type == RequestType.JOIN:
                self.joined.add(rank)
                self.last_joined_rank = rank
                continue
            p = self.pending.get(req.name)
            if p is None:
                p = self.pending[req.name] = _Pending(
                    dataclasses.replace(req, rank=rank))
            elif p.ranks:
                self.check_match(p, req, rank)
                p.from_cache = False  # a renegotiating rank: a full response
            self._note(p, req, rank)

    def ready(self, p: _Pending) -> bool:
        return all(r in p.ranks for r in range(self.size)
                   if r not in self.joined)

    def build_response(self, name: str, p: _Pending) -> Response:
        if p.error:
            return Response(type=ResponseType.ERROR, names=[name],
                            error_message=p.error)
        f = p.first
        if f.type == RequestType.BROADCAST and f.root_rank in self.joined:
            # A broadcast whose root joined is an error, not a hang.
            return Response(
                type=ResponseType.ERROR, names=[name],
                error_message=f"broadcast root rank {f.root_rank} has joined")
        resp = Response(
            type=_RESPONSE_OF[f.type], names=[name], dtype=f.dtype,
            reduce_op=f.reduce_op, prescale=f.prescale,
            postscale=f.postscale, root_rank=f.root_rank,
            fusion_bytes=f.byte_size(), group_name=f.group_name,
            device=f.device, shape=tuple(f.shape))
        ranks = sorted(p.ranks)
        if len(ranks) != self.size:
            resp.participants = ranks
        if f.type == RequestType.ALLGATHER:
            resp.sizes = [p.rank_dim0[r] for r in ranks]
        elif f.type == RequestType.ALLTOALL:
            n = len(ranks)
            for r in ranks:
                row = p.rank_splits.get(r)
                resp.sizes.extend(row if row is not None
                                  else [p.rank_dim0[r] // n] * n)
        elif f.type == RequestType.REDUCESCATTER:
            resp.sizes = [f.shape[0] if f.shape else 1]
        return resp

    def compute(self, fusion_threshold: int, cycle_time_us: int
                ) -> ResponseList:
        out = ResponseList(fusion_threshold_bytes=fusion_threshold,
                           cycle_time_us=cycle_time_us,
                           active_ranks=self.size - len(self.joined))
        ready = {n for n, p in self.pending.items() if self.ready(p)}
        for name in list(ready):
            f = self.pending[name].first
            if not f.group_name or f.group_size <= 0:
                continue
            whole = (len(self.groups.members(f.group_name)) >= f.group_size
                     and self.groups.all_members_ready(f.group_name, ready))
            if not whole:
                ready.discard(name)
        hit_bits = []
        for name in sorted(ready):
            p = self.pending.pop(name)
            bit = self.cache.bit_of(name)
            # Hit bits need the cached full-world response: once a rank
            # joined, every rank must see the explicit participants.
            if p.from_cache and not p.error and bit >= 0 and not self.joined:
                hit_bits.append(bit)
            else:
                out.responses.append(self.build_response(name, p))
            if self.stall is not None:
                self.stall.remove_tensor(name)
            if p.first.group_name:
                self.groups.erase(p.first.group_name)
        out.cache_hit_bits = self.cache.make_bitvector(sorted(hit_bits))
        if len(self.joined) == self.size:
            out.responses.append(Response(
                type=ResponseType.JOIN, names=[msg.JOIN_NAME],
                last_joined_rank=self.last_joined_rank))
            self.joined.clear()
            self.last_joined_rank = -1
        if self.stall is not None:
            self.stall.check(self.size)
        return out


def fuse_responses(responses: Sequence[Response], threshold: int,
                   disable_group_fusion: bool, nbytes: Dict[str, int],
                   groups: Dict[str, str]) -> List[Response]:
    """``FuseResponses`` (``controller.cc:272``): run alike on every rank."""

    def key(r):
        return (r.dtype, r.reduce_op, r.prescale, r.postscale,
                tuple(r.participants), r.device)

    buckets: List[list] = []  # [response, total bytes, group]
    out: List[Response] = []
    for r in responses:
        if (r.type != ResponseType.ALLREDUCE or r.error_message
                or len(r.names) != 1):
            out.append(r)  # emitted in place, keeping the order
            continue
        g = groups.get(r.names[0], "")
        sz = aligned_size(nbytes.get(r.names[0], 0))
        target = None
        for b in buckets:
            if key(b[0]) != key(r):
                continue
            if g or b[2]:
                # Group members always fuse; with group fusion disabled
                # they never share a bucket with outsiders.
                if b[2] == g or (not disable_group_fusion
                                 and b[1] + sz <= threshold):
                    target = b
                    break
                continue
            if b[1] + sz <= threshold:
                target = b
                break
        if target is not None:
            target[0].names.append(r.names[0])
            target[1] += sz
            if not target[2]:
                target[2] = g
        else:
            buckets.append([dataclasses.replace(r, names=list(r.names)),
                            sz, g])
    out.extend(b[0] for b in buckets)
    return out


class LocalController:
    """A world of one: everything this rank has is ready; no exchange."""

    rank, size = 0, 1

    def __init__(self, coordinator: Optional[Coordinator]):
        self.coordinator = coordinator
        self.fusion_threshold = 0
        self.cycle_time_us = 0
        self.bytes_sent = self.bytes_received = 0

    def set_knobs(self, fusion_threshold: int, cycle_time_us: int) -> None:
        self.fusion_threshold = fusion_threshold
        self.cycle_time_us = cycle_time_us

    def _answer(self) -> ResponseList:
        c = self.coordinator
        out = c.compute(self.fusion_threshold, self.cycle_time_us)
        if c.all_ranks_requested_shutdown() or c.stall_shutdown:
            out.shutdown = True
        return out

    def negotiate(self, mine: RequestList) -> ResponseList:
        self.coordinator.ingest(mine, 0)
        return self._answer()


class GlooController(LocalController):
    """A world of several processes: one exchange a cycle on ``pg``, the
    runtime's own gloo group (its control plane and its CPU data plane).
    Only rank 0 holds a coordinator."""

    SLOT = 4096  # bytes a rank's list takes in the common case

    def __init__(self, pg, rank: int, size: int,
                 coordinator: Optional[Coordinator]):
        super().__init__(coordinator)
        self.pg, self.rank, self.size = pg, rank, size

    def _slot(self, data: bytes) -> torch.Tensor:
        buf = torch.zeros(self.SLOT, dtype=torch.uint8)
        buf[:8] = torch.tensor([len(data)], dtype=torch.int64).view(
            torch.uint8)
        body = data[: self.SLOT - 8]
        if body:
            buf[8:8 + len(body)] = torch.frombuffer(bytearray(body),
                                                    dtype=torch.uint8)
        return buf

    @staticmethod
    def _length(slot: torch.Tensor) -> int:
        return int(slot[:8].view(torch.int64)[0])

    def _allgather(self, t: torch.Tensor) -> List[torch.Tensor]:
        outs = [torch.empty_like(t) for _ in range(self.size)]
        self.pg.allgather([outs], [t]).wait()
        return outs

    def _broadcast(self, t: torch.Tensor) -> None:
        opts = torch.distributed.BroadcastOptions()
        opts.rootRank, opts.rootTensor = 0, 0
        self.pg.broadcast([t], opts).wait()

    def _tail(self, data: bytes, n: int) -> torch.Tensor:
        rest = torch.zeros(n, dtype=torch.uint8)
        tail = data[self.SLOT - 8:]
        if tail:
            rest[:len(tail)] = torch.frombuffer(bytearray(tail),
                                                dtype=torch.uint8)
        return rest

    def negotiate(self, mine: RequestList) -> ResponseList:
        body = self.SLOT - 8
        data = msg.encode(mine)
        slots = self._allgather(self._slot(data))
        lens = [self._length(s) for s in slots]
        over = max(lens) - body
        rests = self._allgather(self._tail(data, over)) if over > 0 else None
        self.bytes_sent += self.SLOT + max(over, 0)
        self.bytes_received += (self.SLOT + max(over, 0)) * (self.size - 1)
        reply = b""
        if self.rank == 0:
            for r, (s, n) in enumerate(zip(slots, lens)):
                raw = bytes(s[8:8 + min(n, body)].numpy())
                if n > body:
                    raw += bytes(rests[r][:n - body].numpy())
                self.coordinator.ingest(msg.decode(raw), r)
            out = self._answer()
            reply = msg.encode(out)
            head = self._slot(reply)
        else:
            head = torch.empty(self.SLOT, dtype=torch.uint8)
        self._broadcast(head)
        n = self._length(head)
        if n > body:
            rest = self._tail(reply, n - body)
            self._broadcast(rest)
        if self.rank == 0:
            self.bytes_sent += n + 8
            return out
        self.bytes_received += n + 8
        raw = bytes(head[8:8 + min(n, body)].numpy())
        if n > body:
            raw += bytes(rest.numpy())
        out = msg.decode(raw)
        # The coordinator's knobs: every rank fuses alike.
        self.fusion_threshold = out.fusion_threshold_bytes
        self.cycle_time_us = out.cycle_time_us
        return out


def participants_of(resp: Response, size: int) -> List[int]:
    return list(resp.participants) if resp.participants else list(range(size))
