"""A fake-tensor record of one train step: the port's counterpart of
``jax.make_jaxpr`` and ``horovod_tpu/analysis/jaxpr_walk.py``.

The port's step is eager Python: gradient hooks that issue bucket
collectives on side streams, ``torch.distributed`` calls that all pass
through one choke point (``ops.collectives._comm``), and CUDA kernels that
are ``hvt::*`` custom ops with fake implementations. Neither ``torch.fx``
nor ``torch.export`` captures that whole, so :func:`record` runs the built
step ONCE:

* under ``FakeTensorMode``: every tensor has a shape, a dtype and a
  device and no data, so nothing is computed, no kernel launches and no
  device memory is allocated (a kernel's fake gives its outputs' shapes);
* inside a simulated world of ``world`` ranks: ``context.rank()``,
  ``size()`` and every collective's group answer for a mesh of that size,
  so no process group of that size is needed, as the reference traces 8
  devices without running them;
* with ``_comm`` turned into a recorder that communicates nothing: each
  ``torch.distributed`` call becomes a :class:`CollectiveSite` named as
  the reference names its primitives (``psum``, ``reduce_scatter``,
  ``all_gather``, ``all_to_all``, ``ppermute``), with the axes of its
  group and the shapes and dtypes it moves;
* under a ``TorchDispatchMode`` that logs each op's outputs, their
  storages and the in-place targets. Each fake storage is live from the op
  that makes it until its last reference dies (a weakref finalizer on the
  storage), so autograd's saved tensors, checkpoint recomputes and
  in-place updates come out as the caching allocator sees them; the
  memory planner (:mod:`.memory`) sweeps these lifetimes.

Frames come from context managers the port's own loops enter
(:func:`frame`): the microbatch loop of ``accumulate_gradients`` and the
local passes of ``backward_passes_per_step`` enter ``scan``, the guard's
commit-or-skip and Adasum's pairing enter ``cond``. A collective is
**rank-dependent** where the records of rank 0 and of rank ``world - 1``
diverge: the eager counterpart of the reference's ``axis_index`` taint.
A host read inside the step (``.item()``) does not stop the record: it is
logged (the ``host-read-in-step`` finding) and reads as zero.

The record runs no kernel and reads no value: the parameters, the RNG
state, the launch counters and the caching allocator are as they were.
"""

from __future__ import annotations

import contextlib
import dataclasses
import difflib
import os
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "Aval",
    "CollectiveSite",
    "ControlFrame",
    "LoopCarry",
    "Record",
    "WalkResult",
    "active",
    "aval_nbytes",
    "frame",
    "is_low_precision",
    "mark",
    "record",
    "simulated_world",
]

# Collectives that reduce (by the reference's primitive names): where a
# low-precision wire dtype rounds.
REDUCING_COLLECTIVE_PRIMS = frozenset({"psum", "reduce_scatter", "pmax",
                                       "pmin"})

_LOW_PRECISION = ("bfloat16", "float16")


class DType(str):
    """A dtype by the reference's name (``"float32"``), with its size."""

    itemsize: int

    def __new__(cls, name: str, itemsize: int):
        self = super().__new__(cls, name)
        self.itemsize = int(itemsize)
        return self


def dtype_of(dt: torch.dtype) -> DType:
    return DType(str(dt).replace("torch.", ""), dt.itemsize)


@dataclasses.dataclass(frozen=True)
class Aval:
    """Shape and dtype of one tensor; ``str`` is the reference's cert
    spelling (``float32[108032]``, ``float32[]``)."""

    shape: Tuple[int, ...]
    dtype: DType

    def __str__(self) -> str:
        return f"{self.dtype}[{','.join(str(d) for d in self.shape)}]"

    @classmethod
    def of(cls, t: torch.Tensor) -> "Aval":
        return cls(tuple(int(d) for d in t.shape), dtype_of(t.dtype))


def is_low_precision(aval) -> bool:
    return getattr(aval, "dtype", None) is not None and str(
        aval.dtype) in _LOW_PRECISION


def aval_nbytes(aval) -> int:
    """Payload bytes of one aval (shape/dtype metadata only)."""
    size = 1
    for d in getattr(aval, "shape", ()):
        size *= int(d)
    return size * aval.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class ControlFrame:
    """One enclosing loop or branch on a collective's path."""

    kind: str  # cond | while | scan
    rank_dependent: bool  # the ranks' records diverge here


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    kind: str
    axes: Tuple[str, ...]
    order: int  # op position in the record
    path: str  # frame path, e.g. "scan/psum[#12]"
    in_avals: Tuple[Any, ...]
    out_avals: Tuple[Any, ...]
    control_flow: Tuple[ControlFrame, ...]

    @property
    def in_bytes(self) -> int:
        return sum(aval_nbytes(a) for a in self.in_avals)

    @property
    def out_bytes(self) -> int:
        return sum(aval_nbytes(a) for a in self.out_avals)

    def signature(self) -> Tuple:
        """Order-comparison key: what must match for two programs to
        co-execute this collective without deadlocking."""
        return (self.kind, self.axes,
                tuple(sorted(str(a) for a in self.in_avals)))


@dataclasses.dataclass(frozen=True)
class LoopCarry:
    """A tensor a loop frame updates in place that was made before the
    loop: the eager form of a loop carry (precision pass input)."""

    loop_kind: str  # while | scan
    position: int
    aval: Any
    path: str
    # True when the loop touches the carry only through the add that
    # updates it (c += x): a pure accumulator.
    is_pure_add_accumulator: bool = False


@dataclasses.dataclass
class WalkResult:
    collectives: List[CollectiveSite]
    loop_carries: List[LoopCarry]
    n_eqns: int = 0


@dataclasses.dataclass
class Buffer:
    """One fake storage: its bytes, the op that made it (-1: an input),
    the op at which its last reference died (None: alive at the end), its
    category and a label."""

    nbytes: int
    born: int
    freed: Optional[int]
    cls: str
    label: str = ""


@dataclasses.dataclass
class Record(WalkResult):
    """One recorded step: the walk (``collectives``, ``loop_carries``,
    ``n_eqns`` = ops dispatched) plus what the other passes read."""

    world: int = 1
    rank: int = 0
    wall_s: float = 0.0
    host_reads: List[str] = dataclasses.field(default_factory=list)
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    fp8_ops: List[Tuple[str, List[str]]] = dataclasses.field(
        default_factory=list)
    markers: Dict[str, int] = dataclasses.field(default_factory=dict)
    buffers: List[Buffer] = dataclasses.field(default_factory=list)
    # Input state leaves the step replaced with a new tensor of the same
    # shape and dtype instead of updating them in place.
    replaced: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    input_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    global_state_bytes: int = 0


# -- the simulated world ---------------------------------------------------


class _SimGroup:
    """Stands for a process group of the simulated mesh: its axes."""

    def __init__(self, axes: Tuple[str, ...]):
        self.axes = tuple(axes)


def _sim_mesh(shape: Dict[str, int], rank: int):
    from ..parallel.mesh import AxisGroup, Mesh

    class SimMesh(Mesh):
        """A mesh whose every group is live and communicates nothing."""

        def _build(self, axes):
            ranks = self.group_ranks(axes)
            self._groups[axes] = AxisGroup(_SimGroup(axes), ranks,
                                           ranks.index(self.rank), True)

        def group(self, axis):
            axes = self._normalize(axis)
            if axes not in self._groups:
                self._build(axes)
            return self._groups[axes]

    import numpy as np

    size = int(np.prod(list(shape.values()))) if shape else 1
    ranks = np.arange(size).reshape([shape[a] for a in shape])
    return SimMesh(ranks, tuple(shape), rank)


def _world_shape(world: Optional[int], mesh) -> Tuple[Dict[str, int],
                                                        Tuple[str, ...]]:
    """The simulated mesh's axis sizes and world axes: ``mesh`` when given;
    else the live context's mesh when its size is ``world``; else one flat
    world axis of ``world`` ranks."""
    from .. import context as _ctx

    c = _ctx._context
    if mesh is not None:
        shape = dict(getattr(mesh, "shape", mesh))
        return shape, tuple(shape)
    if c is not None and (world is None or world == c.size):
        return dict(c.mesh.shape), tuple(c.world_axes)
    return {_ctx.WORLD_AXIS: int(world or 1)}, (_ctx.WORLD_AXIS,)


_active: Optional["_Recorder"] = None
_sim_lock = threading.RLock()


def active() -> bool:
    """True while a step is being recorded or a simulated world is up."""
    return _active is not None


@contextlib.contextmanager
def simulated_world(world: Optional[int] = None, rank: int = 0, *,
                    mesh=None, world_axes: Optional[Sequence[str]] = None,
                    device=None, _recorder: Optional["_Recorder"] = None):
    """Run the enclosed code as rank ``rank`` of a simulated world of
    ``world`` ranks (default: the live context's): the context answers
    for that mesh, every group is live, and collectives are logged by the
    current record (or dropped outside one), never communicated. Build a
    step and its state here to record them at a world size this process
    does not have (the reference's 8 virtual devices)."""
    global _active
    from .. import context as _ctx
    from ..ops import collectives as _coll

    shape, axes = _world_shape(world, mesh)
    if world_axes is not None:
        axes = tuple(world_axes)
    with _sim_lock:
        saved = (_ctx._context, _coll._recorder, _active)
        c = saved[0]
        sim = _sim_mesh(shape, rank)
        dev = torch.device(device) if device is not None else (
            c.device if c is not None else torch.device("cpu"))
        _ctx._context = _ctx.TorchContext(
            rank, sim.size, rank, dev, sim.size,
            c.backend if c is not None else None, sim, axes)
        rec = _recorder or _active or _Recorder(sim.size, rank)
        _active = rec
        _coll._recorder = rec.collective
        try:
            yield rec
        finally:
            _ctx._context, _coll._recorder, _active = saved


# -- frames and markers ----------------------------------------------------


@contextlib.contextmanager
def frame(kind: str):
    """The port's loops and branches enter this: ``scan`` for a loop whose
    trip count every rank shares, ``cond`` for a branch. A no-op unless a
    record runs."""
    rec = _active
    if rec is None or not rec.recording:
        yield
        return
    rec.enter(kind)
    try:
        yield
    finally:
        rec.exit()


def mark(name: str) -> None:
    """Note a named point of the program in the current record (the int8
    activation boundary's ``Q_NAME``, say); a no-op unless a record
    runs."""
    rec = _active
    if rec is not None and rec.recording:
        rec.markers[name] = rec.markers.get(name, 0) + 1


# -- the recorder ----------------------------------------------------------

_aten = torch.ops.aten
_ADDS = (_aten.add_.Tensor, _aten.add_.Scalar)
_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _caller() -> str:
    """``file:line`` of the innermost frame outside torch and this
    package's analysis plane: where a host read happened."""
    here = os.path.dirname(os.path.abspath(__file__))
    for fs in reversed(traceback.extract_stack()):
        f = os.path.abspath(fs.filename)
        if f.startswith(here) or f"{os.sep}torch{os.sep}" in f:
            continue
        return f"{os.path.basename(f)}:{fs.lineno}"
    return "?"


class _Frame:
    __slots__ = ("kind", "start", "targets", "uses")

    def __init__(self, kind: str, start: int):
        self.kind = kind
        self.start = start
        self.targets: Dict[int, Tuple[torch.Tensor, int]] = {}
        self.uses: Dict[int, int] = {}


class _Recorder:
    def __init__(self, world: int, rank: int):
        self.world = world
        self.rank = rank
        self.recording = False
        self.frames: List[_Frame] = []
        self.n_ops = 0
        self.sites: List[CollectiveSite] = []
        self.carries: List[LoopCarry] = []
        self.host_reads: List[str] = []
        self.op_counts: Dict[str, int] = {}
        self.fp8_ops: List[Tuple[str, List[str]]] = []
        self.markers: Dict[str, int] = {}
        self.buffers: Dict[int, Buffer] = {}
        self.order: List[Buffer] = []
        self._finalizers: List[weakref.finalize] = []

    # -- frames

    def enter(self, kind: str) -> None:
        self.frames.append(_Frame(kind, self.n_ops))

    def exit(self) -> None:
        fr = self.frames.pop()
        path = "/".join([f.kind for f in self.frames] + [fr.kind])
        for sid, (t, _) in fr.targets.items():
            self.carries.append(LoopCarry(
                loop_kind=fr.kind, position=len(self.carries),
                aval=Aval.of(t), path=path,
                is_pure_add_accumulator=fr.uses.get(sid, 0) == 0))

    def path(self, leaf: str) -> str:
        return "/".join([f.kind for f in self.frames] + [leaf])

    def control_flow(self) -> Tuple[ControlFrame, ...]:
        return tuple(ControlFrame(f.kind, False) for f in self.frames)

    # -- storages

    def track(self, t: torch.Tensor, cls: str = "activations",
              label: str = "", born: Optional[int] = None) -> Buffer:
        st = t.untyped_storage()
        key = id(st)
        buf = self.buffers.get(key)
        if buf is not None and buf.freed is None:
            return buf
        buf = Buffer(int(st.nbytes()), self.n_ops if born is None else born,
                     None, cls, label)
        self.buffers[key] = buf
        self.order.append(buf)
        self._finalizers.append(weakref.finalize(st, self._free, buf))
        return buf

    def _free(self, buf: Buffer) -> None:
        if self.recording and buf.freed is None:
            buf.freed = self.n_ops

    def buffer(self, t: torch.Tensor) -> Optional[Buffer]:
        buf = self.buffers.get(id(t.untyped_storage()))
        return buf if buf is not None and buf.freed is None else None

    # -- ops

    def on_op(self, func, args, kwargs, out) -> None:
        self.n_ops += 1
        name = func._schema.name
        self.op_counts[name] = self.op_counts.get(name, 0) + 1
        written = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                if isinstance(v, torch.Tensor):
                    written.append(v)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor):
                self.track(o)
        if name.startswith("hvt::") and "fp8" in name and "matmul" in name:
            dts = sorted({str(a.dtype).replace("torch.", "") for a in args
                          if isinstance(a, torch.Tensor)
                          and a.dtype in _FLOAT8})
            self.fp8_ops.append((self.path(f"{name}[#{self.n_ops}]"), dts))
        if self.frames:
            fr = self.frames[-1]
            target = written[0] if (func in _ADDS and written) else None
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, torch.Tensor) and a is not target:
                    sid = id(a.untyped_storage())
                    fr.uses[sid] = fr.uses.get(sid, 0) + 1
            if target is not None:
                buf = self.buffer(target)
                sid = id(target.untyped_storage())
                if buf is not None and buf.born < fr.start:
                    fr.targets.setdefault(sid, (target, self.n_ops))

    def host_read(self) -> None:
        self.host_reads.append(self.path(f"item[#{self.n_ops}]@{_caller()}"))

    # -- collectives

    def collective(self, fn, args, kwargs):
        """``_comm``'s stand-in: log the call as a site, communicate
        nothing, return what the caller waits on (no work handles)."""
        p2p = fn is dist.batch_isend_irecv
        if not self.recording or getattr(fn, "__name__", "") == "wait":
            return [] if p2p else None
        group = kwargs.get("group")
        axes = (group.axes if isinstance(group, _SimGroup)
                else _default_axes())
        site = _site_of(fn, args, kwargs, _axes_size(axes))
        if site is None:
            return None
        kind, ins, outs, written = site
        for t in written:
            buf = self.buffer(t)
            if buf is not None and buf.born >= 0:
                buf.cls = "wire"
        self.n_ops += 1
        order = self.n_ops
        self.sites.append(CollectiveSite(
            kind=kind, axes=axes, order=order,
            path=self.path(f"{kind}[#{order}]"), in_avals=tuple(ins),
            out_avals=tuple(outs), control_flow=self.control_flow()))
        return [] if p2p else None


def _default_axes() -> Tuple[str, ...]:
    from .. import context as _ctx

    c = _ctx._context
    return tuple(c.world_axes) if c is not None else (_ctx.WORLD_AXIS,)


def _axes_size(axes) -> int:
    from .. import context as _ctx

    return _ctx._context.mesh.axis_size(axes)


def _chunked(t: torch.Tensor, n: int) -> Aval:
    """``t`` split into ``n`` equal chunks along dim 0, as ``[n, rows/n,
    ...]``: how the reference shapes an all-to-all operand."""
    shape = tuple(int(d) for d in t.shape)
    return Aval((n, shape[0] // n) + shape[1:], dtype_of(t.dtype))


def _cat_aval(tensors) -> Aval:
    """The aval of equal chunks laid end to end along dim 0."""
    ts = list(tensors)
    n = sum(int(t.shape[0]) for t in ts)
    return Aval((n,) + tuple(int(d) for d in ts[0].shape[1:]),
                dtype_of(ts[0].dtype))


def _site_of(fn, args, kwargs, size: int):
    """``(kind, in_avals, out_avals, written tensors)`` of one distributed
    call over a group of ``size``; None for a call that moves no data (a
    barrier)."""
    if fn is dist.all_reduce:
        x = args[0]
        op = kwargs.get("op", dist.ReduceOp.SUM)
        kind = {dist.ReduceOp.MAX: "pmax",
                dist.ReduceOp.MIN: "pmin"}.get(op, "psum")
        return kind, [Aval.of(x)], [Aval.of(x)], [x]
    if fn is dist.reduce_scatter:
        out, chunks = args[0], args[1]
        return ("reduce_scatter", [_cat_aval(chunks)], [Aval.of(out)],
                [out])
    if fn is dist.all_gather:
        outs, mine = args[0], args[1]
        return "all_gather", [Aval.of(mine)], [_cat_aval(outs)], list(outs)
    if fn is dist.all_to_all_single:
        out, x = args[0], args[1]
        if kwargs.get("input_split_sizes") or kwargs.get(
                "output_split_sizes") or len(args) > 2:
            return "all_to_all", [Aval.of(x)], [Aval.of(out)], [out]
        return "all_to_all", [_chunked(x, size)], [_chunked(out, size)], [out]
    if fn is dist.broadcast:
        x = args[0]
        return "broadcast", [Aval.of(x)], [Aval.of(x)], [x]
    if fn is dist.batch_isend_irecv:
        sends = [p.tensor for p in args[0] if p.op in (dist.isend, dist.send)]
        recvs = [p.tensor for p in args[0] if p.op in (dist.irecv, dist.recv)]
        return ("ppermute", [Aval.of(t) for t in sends],
                [Aval.of(t) for t in recvs], recvs)
    if fn is dist.barrier:
        return None
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    avals = [Aval.of(t) for t in ts]
    return getattr(fn, "__name__", "collective"), avals, avals, ts


class _OpLog(TorchDispatchMode):
    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _aten._local_scalar_dense.default:
            # A host read inside the step: logged, and read as zero.
            self.rec.host_read()
            self.rec.n_ops += 1
            t = args[0]
            if t.dtype == torch.bool:
                return False
            return 0 if not t.is_floating_point() else 0.0
        out = func(*args, **kwargs)
        self.rec.on_op(func, args, kwargs, out)
        return out


# -- state walking ---------------------------------------------------------


def _leaves(node, prefix: str = ""):
    """``(label, tensor)`` of every tensor of a nest of dicts, dataclasses,
    NamedTuples, lists, tuples and fused buffers, in walk order."""
    from ..checkpoint import _children

    if isinstance(node, torch.Tensor):
        yield prefix, node
        return
    kids = _children(node)
    if kids is None:
        return
    for k, v in kids:
        if isinstance(node, dict):
            label = f"{prefix}[{k!r}]"
        elif isinstance(k, int):
            label = f"{prefix}[{k}]"
        else:
            label = f"{prefix}.{k}" if prefix else str(k)
        yield from _leaves(v, label)


def _classes(args: Tuple) -> List[Tuple[str, str, torch.Tensor]]:
    """``(label, category, tensor)`` of every input leaf: a TrainState's
    params and opt_state by name, everything else workspace."""
    out = []
    for i, arg in enumerate(args):
        if hasattr(arg, "params") and hasattr(arg, "opt_state"):
            for field, cls in (("params", "params"),
                               ("opt_state", "opt_state"),
                               ("step", "workspace"), ("extra", "workspace"),
                               ("guard", "workspace")):
                for label, t in _leaves(getattr(arg, field, None),
                                        f"arg{i}.{field}"):
                    out.append((label, cls, t))
            continue
        for label, t in _leaves(arg, f"arg{i}"):
            out.append((label, "workspace", t))
    return out


def _fake_args(mode, args):
    from ..checkpoint import map_tensors

    def conv(t):
        return mode.from_tensor(t)

    return tuple(map_tensors(conv, a) for a in args)


# -- record ------------------------------------------------------------------


def _record_once(fn, args, world, rank, mesh, world_axes) -> Record:
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    shape, _ = _world_shape(world, mesh)
    size = 1
    for n in shape.values():
        size *= int(n)
    dev = next((t.device for _, _, t in _classes(args)), None)
    rec = _Recorder(size, rank)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with simulated_world(world, rank, mesh=mesh, world_axes=world_axes,
                         device=dev, _recorder=rec):
        try:
            fake = _fake_args(mode, args)
            leaves = _classes(fake)
            inputs: Dict[str, int] = {}
            seen = set()
            for label, cls, t in leaves:
                if id(t.untyped_storage()) in seen:
                    continue
                seen.add(id(t.untyped_storage()))
                buf = rec.track(t, cls, label, born=-1)
                inputs[cls] = inputs.get(cls, 0) + buf.nbytes
            rec.recording = True
            with mode, _OpLog(rec):
                out = fn(*fake)
            rec.recording = False
            replaced = _replaced(leaves, out, rec)
            record = Record(
                collectives=list(rec.sites), loop_carries=list(rec.carries),
                n_eqns=rec.n_ops, world=size, rank=rank,
                host_reads=list(rec.host_reads),
                op_counts=dict(rec.op_counts), fp8_ops=list(rec.fp8_ops),
                markers=dict(rec.markers), buffers=list(rec.order),
                replaced=replaced, input_bytes=inputs,
                global_state_bytes=sum(inputs.values()))
            del out, fake, leaves
        finally:
            rec.recording = False
            for f in rec._finalizers:
                f.detach()
    record.wall_s = time.perf_counter() - t0
    return record


def _replaced(leaves, out, rec: _Recorder) -> List[Dict[str, Any]]:
    """Input state leaves whose place in the returned state holds a new
    tensor of the same shape and dtype: state replaced, not updated in
    place."""
    new_state = out[0] if isinstance(out, (tuple, list)) and out else out
    if not (hasattr(new_state, "params") and hasattr(new_state, "opt_state")):
        return []
    after = {label: t for label, _, t in _classes((new_state,))}
    found = []
    for label, cls, t in leaves:
        if cls not in ("params", "opt_state"):
            continue
        u = after.get(label)
        if (u is None or u.untyped_storage() is t.untyped_storage()
                or tuple(u.shape) != tuple(t.shape) or u.dtype != t.dtype):
            continue
        buf = rec.buffer(u)
        found.append({"label": label, "class": cls,
                      "bytes": int(t.untyped_storage().nbytes()),
                      "out_born": buf.born if buf is not None else -1})
    return found


def _merge_rank_dependence(a: Record, b: Record) -> None:
    """Mark the sites where rank 0's and rank ``world - 1``'s records
    diverge as under rank-dependent control flow; sites only the other
    rank issues join the record too."""
    sig_a = [s.signature() for s in a.collectives]
    sig_b = [s.signature() for s in b.collectives]
    if sig_a == sig_b:
        return
    sm = difflib.SequenceMatcher(a=sig_a, b=sig_b, autojunk=False)
    keep_a, keep_b = set(), set()
    for blk in sm.get_matching_blocks():
        keep_a.update(range(blk.a, blk.a + blk.size))
        keep_b.update(range(blk.b, blk.b + blk.size))
    frame_ = ControlFrame("cond", True)

    def flag(s: CollectiveSite, tag: str) -> CollectiveSite:
        return dataclasses.replace(
            s, control_flow=s.control_flow + (frame_,),
            path=f"cond[{tag}]/{s.path}")

    sites = [s if i in keep_a else flag(s, f"rank {a.rank}")
             for i, s in enumerate(a.collectives)]
    sites += [flag(s, f"rank {b.rank}") for i, s in enumerate(b.collectives)
              if i not in keep_b]
    a.collectives = sorted(sites, key=lambda s: s.order)


def record(fn: Callable, args: Tuple, *, world: Optional[int] = None,
           rank: Optional[int] = None, mesh=None, world_axes=None,
           rank_check: bool = True) -> Record:
    """Record ``fn(*args)`` once under fake tensors as rank ``rank`` (default:
    this process's, 0 at another world size) of a simulated world of
    ``world`` ranks (default: the live context's size); see the module
    docstring. ``args`` are real tensors (or nests of them: a
    ``TrainState``, a batch); they are copied to fakes, so the step sees
    its real shapes and devices and changes nothing. The simulated world
    is the whole process's while the record runs: no other thread may
    run collectives meanwhile.

    With ``rank_check`` and ``world > 1`` the step is recorded again as
    rank ``world - 1`` (or 0, when ``rank`` is the last) and the sites
    where the two records diverge are marked rank-dependent."""
    if rank is None:
        from .. import context as _ctx

        c = _ctx._context
        rank = c.rank if c is not None and world in (None, c.size) else 0
    rec = _record_once(fn, args, world, rank, mesh, world_axes)
    if rank_check and rec.world > 1:
        other = rec.world - 1 if rank != rec.world - 1 else 0
        rec_b = _record_once(fn, args, world, other, mesh, world_axes)
        _merge_rank_dependence(rec, rec_b)
        rec.wall_s += rec_b.wall_s
    return rec

