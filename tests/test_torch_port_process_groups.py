"""Named-axis process groups (parallel/mesh.py, context.init(mesh=,
hierarchical=), every collective's ``axis=``) held against the JAX
package's ``axis=`` collectives on a 2 x 2 mesh.

One gloo world of 4 CPU processes (``context.spawn_gloo``) runs every case
twice: under ``init(mesh={"cross": 2, "local": 2})`` and under
``init(hierarchical=True)`` with a local size of 2, which must build the
same ``(cross, local)`` mesh. Over ``"local"``, ``"cross"`` and
``("cross", "local")``: ``allreduce`` (Sum, Average, Min, Max),
``allgather``, ``broadcast`` (root 1 within the group) and
``reducescatter`` (Sum, Average), against the JAX functions with the same
``axis=`` under ``shard_map`` on a ``(cross, local)`` mesh of 4 CPU
devices, from the same seeded numpy inputs per rank. Tolerance 0: the
inputs are multiples of 1/64 below 8 in magnitude, so a sum of four is
exact in fp32 in any order; Min, Max and the moves are exact, and Average
divides by 2 or 4, which is exact. Also ``size(axis)``, ``rank(axis)``,
an unknown axis and an axis tuple out of the mesh's order raising
``HorovodTpuError``, ``init`` with world axes a subset of the mesh, and
``build_mesh``'s axis ordering and size inference against the JAX
package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu import _compat
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch import context
from horovod_tpu_torch.exceptions import HorovodTpuError
from horovod_tpu_torch.ops import collectives as tcoll
from horovod_tpu_torch.parallel import mesh as tmesh

WORLD = 4
AXES = {"local": "local", "cross": "cross", "both": ("cross", "local")}
VARIANTS = ("mesh", "hierarchical")


def _x(rank):
    # Multiples of 1/64 below 8 in magnitude: every sum of four is exact
    # in fp32, whatever order gloo and XLA add them in.
    x = np.random.RandomState(30 + rank).standard_normal((4, 3))
    return (np.round(np.clip(x, -7, 7) * 64) / 64).astype(np.float32)


def _cases(coll, x, axis):
    return {
        "sum": coll.allreduce(x, op=coll.Sum, axis=axis),
        "average": coll.allreduce(x, op=coll.Average, axis=axis),
        "min": coll.allreduce(x, op=coll.Min, axis=axis),
        "max": coll.allreduce(x, op=coll.Max, axis=axis),
        "allgather": coll.allgather(x, axis=axis),
        "broadcast": coll.broadcast(x, 1, axis=axis),
        "rs_sum": coll.reducescatter(x, op=coll.Sum, axis=axis),
        "rs_average": coll.reducescatter(x, op=coll.Average, axis=axis),
    }


def _port_groups():
    """One rank of the world of 4: every case under both meshes."""
    rank = int(os.environ["RANK"])
    x = torch.from_numpy(_x(rank))
    out = {}
    for variant in VARIANTS:
        if variant == "mesh":
            context.init(device="cpu", mesh={"cross": 2, "local": 2})
        else:
            os.environ.update(LOCAL_WORLD_SIZE="2", LOCAL_RANK=str(rank % 2))
            context.init(device="cpu", hierarchical=True)
        assert context.mesh().axis_names == ("cross", "local")
        res = {name: {k: v.numpy() for k, v in _cases(tcoll, x, a).items()}
               for name, a in AXES.items()}
        res["sizes"] = {name: (context.size(a), context.rank(a))
                        for name, a in AXES.items()}
        res["world"] = (context.size(), context.rank(),
                        context.local_rank(), context.cross_rank())
        for bad in ("nope", ("local", "cross")):
            with pytest.raises(HorovodTpuError):
                tcoll.allreduce(x, axis=bad)
        with pytest.raises(HorovodTpuError, match="root_rank"):
            tcoll.broadcast(x, 2, axis="local")
        out[variant] = res
    return out


@pytest.fixture(scope="module")
def port_world():
    return context.spawn_gloo(WORLD, _port_groups)


@pytest.fixture(scope="module")
def jax_world():
    devs = np.asarray(jax.devices("cpu")[:WORLD]).reshape(2, 2)
    mesh = JMesh(devs, ("cross", "local"))
    ctx = hvd.init(mesh=mesh, world_axes=("cross", "local"),
                   local_axes=("local",), cross_axes=("cross",))
    try:
        stacked = jnp.stack([jnp.asarray(_x(r)) for r in range(WORLD)])

        def body(x):
            x = x[0]
            out = {name: _cases(jcoll, x, a) for name, a in AXES.items()}
            out["sizes"] = {name: (hvd.size(a) + 0 * hvd.rank(a),
                                   hvd.rank(a)) for name, a in AXES.items()}
            return jax.tree.map(lambda t: jnp.asarray(t)[None], out)

        fn = jax.jit(_compat.shard_map(
            body, mesh=ctx.mesh, in_specs=(P(("cross", "local")),),
            out_specs=P(("cross", "local")), check_vma=False))
        out = jax.tree.map(np.asarray, fn(stacked))
        return [jax.tree.map(lambda t: t[r], out) for r in range(WORLD)]
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("axis", list(AXES))
@pytest.mark.parametrize("case", ["sum", "average", "min", "max",
                                  "allgather", "broadcast", "rs_sum",
                                  "rs_average"])
def test_axis_collective_matches_the_reference(port_world, jax_world,
                                               variant, axis, case):
    for rank in range(WORLD):
        got = port_world[rank][variant][axis][case]
        want = jax_world[rank][axis][case]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_axis_size_and_rank(port_world, jax_world, variant):
    for rank in range(WORLD):
        got = port_world[rank][variant]
        for name in AXES:
            want = tuple(int(v) for v in jax_world[rank]["sizes"][name])
            assert got["sizes"][name] == want, (rank, name)
        # size() and rank() are the world axes'; local and cross ranks
        # come from the launcher's environment, as before.
        assert got["world"][:2] == (WORLD, rank)
        if variant == "hierarchical":
            assert got["world"][2:] == (rank % 2, rank // 2)


@pytest.mark.parametrize("axes", [
    {"tp": 2, "dp": -1}, {"dp": 2, "pp": 2, "tp": 2}, {"local": 4, "x": 2},
    {"fsdp": 8},
])
def test_build_mesh_orders_and_infers_like_the_reference(axes):
    want = jmesh.build_mesh(axes, devices=jax.devices("cpu")[:8])
    got = tmesh.build_mesh(axes, world=8, rank=5)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.ranks, ids - ids.min())
    assert all(not got.group(a).live for a in got.axis_names)


def test_build_mesh_rejects_bad_sizes():
    with pytest.raises(ValueError, match="at most one"):
        tmesh.build_mesh({"a": -1, "b": -1}, world=4, rank=0)
    with pytest.raises(ValueError, match="cannot infer"):
        tmesh.build_mesh({"a": 3, "b": -1}, world=4, rank=0)
    with pytest.raises(ValueError, match="!= 4 ranks"):
        tmesh.build_mesh({"a": 3}, world=4, rank=0)
    m = tmesh.build_mesh({"a": 2, "b": 2, "c": 2}, world=8, rank=6)
    assert m.axis_index(("a", "c")) == 2 and m.axis_size(("a", "c")) == 4
    with pytest.raises(HorovodTpuError, match="no process group"):
        m.group(("a", "c"))
    m = tmesh.build_mesh({"a": 2, "b": 2, "c": 2}, world=8, rank=6,
                         axis_groups=[("a", "c")])
    assert m.group_ranks(("a", "c")) == (2, 3, 6, 7)
    assert m.group(("a", "c")).ranks == (6,)  # no process group: alone


def test_init_with_world_axes_a_subset_of_the_mesh(monkeypatch):
    # The data-parallel world is the (dp, pp) axes of a dp x pp x tp mesh:
    # size() and rank() read them, and init builds their group.
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    try:
        context.init(device="cpu", mesh={"tp": 2, "pp": 2, "dp": 2},
                     world_axes=["dp", "pp"])
        assert context.mesh().axis_names == ("dp", "pp", "tp")
        assert (context.size(), context.rank()) == (4, 2)
        assert (context.size("tp"), context.rank("tp")) == (2, 1)
        assert context.mesh().group_ranks(("dp", "pp")) == (1, 3, 5, 7)
        assert context.world_axes() == ("dp", "pp")
        # Without a process group every collective is this process alone.
        assert tcoll.world_size() == 1
        with pytest.raises(HorovodTpuError, match="unknown mesh axis"):
            context.size("sp")
    finally:
        context.shutdown()
