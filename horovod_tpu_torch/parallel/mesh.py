"""Named process meshes: a grid of global ranks, and a process group per
axis.

The port of the JAX package's ``parallel/mesh.py``. Where the JAX package
arranges devices into a ``jax.sharding.Mesh`` and lets ``shard_map`` bind
its axis names, the port has one process per card: a :class:`Mesh` is a
numpy grid of global ranks (``arange(world)`` in row-major order) with a
name per dimension, and a ``torch.distributed`` process group for each
axis and each axis tuple asked for. A collective's ``axis=`` picks this
process's group along those axes (:func:`horovod_tpu_torch.context.
axis_group`); a tuple is the product of its axes, so on a ``(cross,
local)`` mesh ``axis=("cross", "local")`` is the whole grid.

``dist.new_group`` is a collective over the default group: every rank must
call it for every group, in the same order, even for a group it is not in.
So a mesh builds all of its groups when it is constructed, in a fixed
order, and a lookup never builds one.

Within a group, ranks are ordered by global rank (``torch.distributed``
sorts them), which is the row-major order of the group's axes when they
are given in the mesh's order; an axis tuple in another order raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..exceptions import HorovodTpuError

__all__ = [
    "AXIS_ORDER",
    "AxisGroup",
    "Mesh",
    "build_mesh",
    "data_parallel_mesh",
    "num_slices",
]

# Canonical parallelism axis names, in outer-to-inner mesh order (the JAX
# package's): axes that cross hosts outermost, tensor parallelism innermost.
AXIS_ORDER = ("dp", "pp", "ep", "fsdp", "sp", "tp")


class AxisGroup(NamedTuple):
    """This process's group along some mesh axes: ``group`` the process
    group (None for the default group), ``ranks`` its members' global ranks
    in group-rank order, ``index`` this process's rank in it. ``live`` is
    False where no collective runs -- a group of one, or a world without a
    process group -- and the group is then this process alone."""

    group: Any
    ranks: Tuple[int, ...]
    index: int
    live: bool

    @property
    def size(self) -> int:
        return len(self.ranks)

    def global_rank(self, group_rank: int) -> int:
        return self.ranks[group_rank]


def _world_group() -> AxisGroup:
    """The default group as it stands now (a world of one without one)."""
    if not dist.is_initialized():
        return AxisGroup(None, (0,), 0, False)
    n = dist.get_world_size()
    return AxisGroup(None, tuple(range(n)), dist.get_rank(), True)


class Mesh:
    """A grid of global ranks with named axes and this process's group
    along each axis and each built axis tuple (see the module docstring).
    Build it with :func:`build_mesh`; its constructor is collective when a
    process group is up."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 rank: int, axis_groups: Iterable[Sequence[str]] = ()):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(
                f"a {self.ranks.ndim}-D rank grid for axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        self.rank = int(rank)
        self._groups: Dict[Tuple[str, ...], Optional[AxisGroup]] = {}
        wanted = [(a,) for a in self.axis_names] + [self.axis_names]
        wanted += [self._normalize(g) for g in axis_groups]
        for axes in dict.fromkeys(wanted):  # first-seen order, no repeats
            self._build(axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self):
        return f"Mesh({self.shape})"

    def _normalize(self, axis) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or not axes:
            raise HorovodTpuError(
                f"unknown mesh axis {unknown or axes!r}: this mesh has axes "
                f"{self.axis_names}")
        pos = [self.axis_names.index(a) for a in axes]
        if pos != sorted(set(pos)):
            raise HorovodTpuError(
                f"axes {axes} must be distinct and in the mesh's order "
                f"{self.axis_names}")
        return axes

    def _rows(self, axes: Tuple[str, ...]) -> np.ndarray:
        """Every group along ``axes``: ``[n_groups, group_size]`` global
        ranks, each row in group-rank order, the rows in a fixed order."""
        other = [a for a in self.axis_names if a not in axes]
        perm = [self.axis_names.index(a) for a in other + list(axes)]
        size = int(np.prod([self.shape[a] for a in axes]))
        return self.ranks.transpose(perm).reshape(-1, size)

    def group_ranks(self, axis, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The global ranks of ``rank``'s group along ``axis``, in group-rank
        order (default: this process's)."""
        rank = self.rank if rank is None else rank
        rows = self._rows(self._normalize(axis))
        return next(tuple(int(r) for r in row) for row in rows if rank in row)

    def _build(self, axes: Tuple[str, ...]) -> None:
        rows = self._rows(axes)
        if rows.shape[0] == 1:
            self._groups[axes] = None  # the whole world: the default group
        elif rows.shape[1] == 1 or not dist.is_initialized():
            self._groups[axes] = AxisGroup(None, (self.rank,), 0, False)
        else:
            group = None
            for row in rows:  # every rank creates every group, in order
                g = dist.new_group([int(r) for r in row])
                if self.rank in row:
                    group = g
            mine = self.group_ranks(axes)
            self._groups[axes] = AxisGroup(group, mine, mine.index(self.rank),
                                           True)

    def group(self, axis) -> AxisGroup:
        """This process's group along ``axis`` (a name or a tuple of names
        in the mesh's order); an axis tuple the mesh did not build raises."""
        axes = self._normalize(axis)
        if axes not in self._groups:
            raise HorovodTpuError(
                f"no process group was built for axes {axes}; pass them in "
                "build_mesh(..., axis_groups=) (groups are built at "
                "construction, on every rank)")
        g = self._groups[axes]
        return _world_group() if g is None else g

    def axis_size(self, axis) -> int:
        return int(np.prod([self.shape[a] for a in self._normalize(axis)]))

    def axis_index(self, axis, rank: Optional[int] = None) -> int:
        """``rank``'s index along ``axis`` (row-major over a tuple)."""
        axes = self._normalize(axis)
        coords = np.argwhere(self.ranks == (self.rank if rank is None
                                            else rank))[0]
        index = 0
        for a in axes:
            i = self.axis_names.index(a)
            index = index * self.ranks.shape[i] + int(coords[i])
        return index


def _live_world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    from .. import context

    if context.is_initialized():
        return context.size(), context.rank()
    return 1, 0


def build_mesh(axes: Dict[str, int], *,
               axis_groups: Iterable[Sequence[str]] = (),
               world: Optional[int] = None,
               rank: Optional[int] = None) -> Mesh:
    """A named mesh with the given axis sizes over the world's ranks.

    Axes are laid out in :data:`AXIS_ORDER` (unknown names keep their given
    order, outermost first), as the JAX package lays them out; sizes must
    multiply to the world size, and one size of -1 is inferred. Every axis
    gets its process group, and so does the whole grid and each tuple in
    ``axis_groups``. ``world`` and ``rank`` default to the process group's
    (else the context's, else a world of one). A collective when a process
    group is up: every rank calls it with the same arguments."""
    live_world, live_rank = _live_world()
    n = live_world if world is None else int(world)
    rank = live_rank if rank is None else int(rank)
    names = sorted(
        axes.keys(),
        key=lambda a: AXIS_ORDER.index(a) if a in AXIS_ORDER else -1,
    )
    sizes = [int(axes[a]) for a in names]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"cannot infer axis size: {n} ranks / {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} ranks")
    grid = np.arange(n, dtype=np.int64).reshape(sizes)
    return Mesh(grid, names, rank, axis_groups)


def data_parallel_mesh(axis: str = "hvd") -> Mesh:
    """Flat 1-D mesh over the world (the reference's world communicator)."""
    return build_mesh({axis: -1})


def num_slices() -> int:
    """The number of hosts, counted as ``cross_size`` counts them."""
    from .. import context

    return context.cross_size() if context.is_initialized() else 1

