"""The port's collectives, compression and process context held against the
JAX package's.

* ``allreduce`` (every op, prescale and postscale, integer Average),
  ``allgather`` (a scalar too), ``broadcast`` and ``reducescatter`` (Sum,
  its default, and Average) on a gloo world of 2 CPU processes
  (``context.spawn_gloo``) against the JAX functions under ``shard_map``
  on 2 CPU devices, from the same seeded numpy inputs per rank. Tolerance
  0 for Sum/Min/Max/Product of two values, integer Average and the moves;
  Average of floats divides by 2 on both sides, which is exact.
* ``Compression.fp16`` / ``bf16`` standalone against the JAX package's:
  the same wire values and the same decompressed values (tolerance 0:
  the same casts and one division by the same fp32 scale).
* The context: ``init(backend="gloo")`` brings up a world of one on a
  file store and ``shutdown`` tears it down; ``cross_rank`` /
  ``cross_size`` count hosts as the JAX package does (``rank //
  local_size``, ``size // local_size``).
* The uneven and point-to-point collectives on gloo worlds of 2 (the
  world above) and 3 (``_port_uneven`` in both): ``allgather`` of uneven
  first dimensions (C8) against the JAX process path's algorithm
  (``ops/eager.py`` ``allgather``: sizes, pad, gather, slice), transcribed
  here in numpy, exact; a trailing shape that differs raising
  ``HorovodTpuError`` on every rank, after which the group still works;
  ``alltoall`` with uneven ``splits`` and its received splits against
  ``eager.alltoall``'s algorithm, exact, with the twins of
  ``test_alltoall_with_splits_returns_recv`` and
  ``test_eager_alltoall_bad_splits_sum`` (and a bad table on one rank
  only, which every rank raises on); ``grouped_allreduce`` with
  ``fuse=True`` and ``fuse=False`` against the JAX function (Sum exact on
  inputs whose sums are exact in any order); ``ppermute`` on a ring
  (``test_ppermute_ring``'s twin); ``masked_allreduce`` on uneven data
  (``test_masked_allreduce_uneven_data``'s twin, rtol 1e-6, and zero when
  no rank is valid); ``join() == -1``; ``broadcast`` of a bool tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu import _compat
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops.compression import Compression as JComp
from horovod_tpu_torch import context
from horovod_tpu_torch.exceptions import HorovodTpuError
from horovod_tpu_torch.ops import collectives as tcoll
from horovod_tpu_torch.ops.compression import Compression as TComp

WORLD = 2
OPS = ["AVERAGE", "SUM", "MIN", "MAX", "PRODUCT"]


def _inputs(rank):
    rs = np.random.RandomState(10 + rank)
    return {
        "x": rs.standard_normal((4, 3)).astype(np.float32),
        "i": rs.randint(-50, 50, (5,)).astype(np.int32),
        "s": np.float32(rank + 0.5),
    }


def _port_ops():
    """One rank of the gloo world: every collective."""
    inp = {k: torch.from_numpy(np.asarray(v)) for k, v in _inputs(
        context.rank()).items()}
    x = inp["x"]
    out = {}
    for name in OPS:
        op = getattr(tcoll.ReduceOp, name)
        out[f"allreduce_{name}"] = tcoll.allreduce(
            x, op=op, prescale_factor=0.5, postscale_factor=3.0
        ).numpy()
    out["allreduce_int_average"] = tcoll.allreduce(inp["i"]).numpy()
    out["allgather"] = tcoll.allgather(x).numpy()
    out["allgather_scalar"] = tcoll.allgather(inp["s"]).numpy()
    out["broadcast"] = tcoll.broadcast(x, root_rank=1).numpy()
    out["reducescatter_sum"] = tcoll.reducescatter(x).numpy()
    out["reducescatter_average"] = tcoll.reducescatter(
        x, op=tcoll.Average
    ).numpy()
    tcoll.barrier()
    assert np.array_equal(x.numpy(), _inputs(context.rank())["x"])  # kept
    with pytest.raises(HorovodTpuError, match="root_rank"):
        tcoll.broadcast(x, root_rank=WORLD)
    with pytest.raises(ValueError, match="multiple of the world"):
        tcoll.reducescatter(x[:3])
    out["uneven"] = _port_uneven()
    return out


def _ragged(rank):
    """Rank ``rank``'s uneven rows ``[rank + 1, 3]`` (float) and its split
    table, ``world`` sizes of 1-3 rows summing to its dim 0."""
    rs = np.random.RandomState(60 + rank)
    return rs.standard_normal((rank + 1, 3)).astype(np.float32)


def _splits(rank, world):
    return [(rank + d) % 3 + 1 for d in range(world)]


def _a2a_rows(rank, world):
    n = sum(_splits(rank, world))
    return (np.arange(n * 2, dtype=np.float32).reshape(n, 2)
            + 100.0 * rank)


def _grouped(rank):
    # Multiples of 1/64: every sum of three is exact in any order.
    rs = np.random.RandomState(70 + rank)
    return [(np.round(rs.standard_normal(s) * 64) / 64).astype(np.float32)
            for s in ((5,), (2, 3), (7,))]


def _port_uneven():
    """The uneven and point-to-point cases, on any world size."""
    rank, world = context.rank(), context.size()
    out = {"allgather": tcoll.allgather(torch.from_numpy(_ragged(rank))).numpy()}
    out["allgather_scalar"] = tcoll.allgather(torch.tensor(rank + 0.5)).numpy()
    with pytest.raises(HorovodTpuError, match="trailing shapes"):
        tcoll.allgather(torch.zeros((2, 3 + rank)))
    with pytest.raises(HorovodTpuError, match="trailing shapes"):
        tcoll.allgather(torch.zeros((2, 3), dtype=torch.float32 if rank
                                    else torch.float64))
    out["after_mismatch"] = tcoll.allreduce(torch.ones(2), op=tcoll.Sum).numpy()
    rows, recv = tcoll.alltoall(torch.from_numpy(_a2a_rows(rank, world)),
                                splits=_splits(rank, world))
    out["alltoall"], out["alltoall_recv"] = rows.numpy(), recv.numpy()
    eq, eq_recv = tcoll.alltoall(torch.arange(2.0 * world), splits=[2] * world)
    out["alltoall_equal_recv"] = eq_recv.numpy()
    out["alltoall_nosplits"] = tcoll.alltoall(
        torch.arange(2.0 * world) + 10 * rank).numpy()
    with pytest.raises(HorovodTpuError):
        tcoll.alltoall(torch.arange(4.0), splits=[3])
    with pytest.raises(HorovodTpuError, match=r"rank\(s\) \[1\]"):
        tcoll.alltoall(torch.arange(float(world)),
                       splits=[1] * world if rank != 1 else [world] * world)
    g = [torch.from_numpy(a) for a in _grouped(rank)]
    out["grouped_fused"] = [t.numpy() for t in tcoll.grouped_allreduce(
        g, op=tcoll.Sum, fuse=True)]
    out["grouped_unfused"] = [t.numpy() for t in tcoll.grouped_allreduce(
        g, op=tcoll.Sum, fuse=False)]
    out["grouped_max"] = [t.numpy() for t in tcoll.grouped_allreduce(
        g, op=tcoll.Max)]
    out["ppermute"] = tcoll.ppermute(
        torch.tensor([rank], dtype=torch.int32),
        perm=[(i, (i + 1) % world) for i in range(world)]).numpy()
    out["ppermute_partial"] = tcoll.ppermute(
        torch.tensor([rank + 1.0]), perm=[(0, world - 1)]).numpy()
    per_rank = {"g": torch.tensor([rank + 1.0])}
    out["masked"] = float(tcoll.masked_allreduce(
        per_rank, valid=rank < world - 1)["g"][0])
    out["masked_none"] = float(tcoll.masked_allreduce(
        per_rank, valid=False)["g"][0])
    out["join"] = tcoll.join()
    flags = torch.tensor([True, False, rank == 0])
    out["broadcast_bool"] = tcoll.broadcast(flags, root_rank=world - 1)
    return out


@pytest.fixture(scope="module")
def port_world():
    return context.spawn_gloo(WORLD, _port_ops)


@pytest.fixture(scope="module")
def jax_world():
    ctx = hvd.init(devices=jax.devices("cpu")[:WORLD])
    try:
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                               *[_inputs(r) for r in range(WORLD)])

        def body(t):
            t = jax.tree.map(lambda a: a[0], t)
            x = t["x"]
            out = {}
            for name in OPS:
                op = getattr(jcoll.ReduceOp, name)
                out[f"allreduce_{name}"] = jcoll.allreduce(
                    x, op=op, prescale_factor=0.5, postscale_factor=3.0
                )
            out["allreduce_int_average"] = jcoll.allreduce(t["i"])
            out["allgather"] = jcoll.allgather(x)
            out["allgather_scalar"] = jcoll.allgather(t["s"])
            out["broadcast"] = jcoll.broadcast(x, root_rank=1)
            out["reducescatter_sum"] = jcoll.reducescatter(x)
            out["reducescatter_average"] = jcoll.reducescatter(
                x, op=jcoll.Average
            )
            # Per-rank results, stacked over the world axis.
            return jax.tree.map(lambda a: a[None], out)

        fn = jax.jit(_compat.shard_map(
            body, mesh=ctx.mesh, in_specs=(P(hvd.WORLD_AXIS),),
            out_specs=P(hvd.WORLD_AXIS), check_vma=False,
        ))
        out = jax.tree.map(np.asarray, fn(stacked))
        return [{k: v[r] for k, v in out.items()} for r in range(WORLD)]
    finally:
        hvd.shutdown()


KEYS = [f"allreduce_{n}" for n in OPS] + [
    "allreduce_int_average", "allgather", "allgather_scalar", "broadcast",
    "reducescatter_sum", "reducescatter_average",
]


@pytest.mark.parametrize("key", KEYS)
def test_collective_matches_the_reference(port_world, jax_world, key):
    for rank in range(WORLD):
        got, want = port_world[rank][key], jax_world[rank][key]
        assert got.shape == want.shape and got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["fp16", "bf16"])
def test_standalone_compression_matches_the_reference(name):
    x = np.random.RandomState(0).standard_normal(257).astype(np.float32)
    x[7] = 9.0e4  # fp16: a local max-abs prescale above 1
    jw, jctx = getattr(JComp, name).compress(jnp.asarray(x))
    tw, tctx = getattr(TComp, name).compress(torch.from_numpy(x))
    assert str(tw.dtype).replace("torch.", "") == str(jw.dtype)
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    got = getattr(TComp, name).decompress(tw, tctx)
    want = getattr(JComp, name).decompress(jw, jctx)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_gloo_world_of_one_and_shutdown(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    ctx = context.init(device="cpu", backend="gloo")
    try:
        assert ctx.backend == "gloo" and dist.is_initialized()
        assert (context.size(), context.cross_size(), context.cross_rank()) == (
            1, 1, 0)
        x = torch.arange(4.0)
        assert torch.equal(tcoll.allreduce(x), x)
        assert torch.equal(tcoll.allgather(x), x)
    finally:
        context.shutdown()
    assert not dist.is_initialized() and not context.is_initialized()
    with pytest.raises(ValueError, match="runs on cuda"):
        context.init(device="cpu", backend="nccl")
    context.shutdown()


def test_cross_rank_and_size_count_hosts(monkeypatch):
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    try:
        context.init(device="cpu")
        assert (context.rank(), context.size(), context.local_rank(),
                context.local_size()) == (5, 8, 1, 4)
        assert (context.cross_rank(), context.cross_size()) == (1, 2)
        assert context.context().backend is None and not dist.is_initialized()
    finally:
        context.shutdown()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not divide"):
        context.init(device="cpu")


# -- the uneven and point-to-point collectives ---------------------------


def _eager_allgather(xs):
    """``horovod_tpu/ops/eager.py`` ``allgather``'s algorithm in numpy:
    exchange the sizes, pad every rank's rows to the largest, gather,
    slice each rank's rows out."""
    xs = [x[None] if x.ndim == 0 else x for x in xs]
    sizes = np.asarray([x.shape[0] for x in xs])
    top = int(sizes.max())
    g = np.stack([np.pad(x, [(0, top - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
                  for x in xs])
    return np.concatenate([g[i, :int(sizes[i])] for i in range(len(xs))])


def _eager_alltoall(xs, tables, me):
    """``eager.py`` ``alltoall``'s algorithm in numpy for rank ``me``."""
    all_splits = np.asarray(tables, dtype=np.int64)
    g = _eager_allgather(xs)
    row_offsets = np.concatenate([[0], np.cumsum(all_splits.sum(axis=1))])[:-1]
    parts = []
    for src in range(len(xs)):
        start = row_offsets[src] + all_splits[src, :me].sum()
        parts.append(g[int(start):int(start + all_splits[src, me])])
    return np.concatenate(parts), all_splits[:, me].astype(np.int32)


@pytest.fixture(scope="module")
def world3():
    return context.spawn_gloo(3, _port_uneven)


@pytest.fixture(scope="module", params=[2, 3])
def uneven(request, port_world, world3):
    n = request.param
    return n, ([r["uneven"] for r in port_world] if n == 2 else world3)


def _jax_grouped(n):
    ctx = hvd.init(devices=jax.devices("cpu")[:n])
    try:
        stacked = [jnp.stack(xs) for xs in zip(*[_grouped(r)
                                                 for r in range(n)])]

        def body(ts):
            ts = [t[0] for t in ts]
            out = {"fused": jcoll.grouped_allreduce(ts, op=jcoll.Sum,
                                                    fuse=True),
                   "unfused": jcoll.grouped_allreduce(ts, op=jcoll.Sum,
                                                      fuse=False),
                   "max": jcoll.grouped_allreduce(ts, op=jcoll.Max)}
            return jax.tree.map(lambda a: a[None], out)

        fn = jax.jit(_compat.shard_map(
            body, mesh=ctx.mesh, in_specs=(P(hvd.WORLD_AXIS),),
            out_specs=P(hvd.WORLD_AXIS), check_vma=False))
        return jax.tree.map(np.asarray, fn(stacked))
    finally:
        hvd.shutdown()


def test_uneven_allgather_is_the_process_paths(uneven):
    n, out = uneven
    want = _eager_allgather([_ragged(r) for r in range(n)])
    scalars = _eager_allgather([np.float32(r + 0.5) for r in range(n)])
    for r in range(n):
        np.testing.assert_array_equal(out[r]["allgather"], want)
        np.testing.assert_array_equal(out[r]["allgather_scalar"], scalars)
        # The mismatch raised on every rank and left the group working.
        np.testing.assert_array_equal(out[r]["after_mismatch"], float(n))


def test_alltoall_with_uneven_splits(uneven):
    n, out = uneven
    xs = [_a2a_rows(r, n) for r in range(n)]
    tables = [_splits(r, n) for r in range(n)]
    for r in range(n):
        rows, recv = _eager_alltoall(xs, tables, r)
        np.testing.assert_array_equal(out[r]["alltoall"], rows)
        np.testing.assert_array_equal(out[r]["alltoall_recv"], recv)
        assert out[r]["alltoall_recv"].dtype == np.int32
        # test_alltoall_with_splits_returns_recv's twin.
        np.testing.assert_array_equal(out[r]["alltoall_equal_recv"], 2)
        want = np.concatenate([np.arange(2.0 * n)[2 * r:2 * r + 2] + 10 * s
                               for s in range(n)])
        np.testing.assert_array_equal(out[r]["alltoall_nosplits"], want)


def test_grouped_allreduce_matches_the_reference(uneven):
    n, out = uneven
    ref = _jax_grouped(n)
    for r in range(n):
        for key, name in (("grouped_fused", "fused"),
                          ("grouped_unfused", "unfused"),
                          ("grouped_max", "max")):
            for got, want in zip(out[r][key], ref[name]):
                np.testing.assert_array_equal(got, want[r])


def test_ppermute_masked_join_and_bool_broadcast(uneven):
    n, out = uneven
    for r in range(n):
        # test_ppermute_ring's twin; a rank that receives nothing gets zeros.
        np.testing.assert_array_equal(out[r]["ppermute"], [(r - 1) % n])
        np.testing.assert_array_equal(out[r]["ppermute_partial"],
                                      [1.0 if r == n - 1 else 0.0])
        # test_masked_allreduce_uneven_data's twin: the last rank ran dry.
        assert out[r]["masked"] == pytest.approx(
            sum(range(1, n)) / (n - 1), rel=1e-6)
        assert out[r]["masked_none"] == 0.0
        assert out[r]["join"] == -1
        b = out[r]["broadcast_bool"]
        assert b.dtype == torch.bool and b.tolist() == [True, False, n == 1]


def test_alltoall_bad_splits_and_one_process_semantics():
    # test_eager_alltoall_bad_splits_sum's twin, and the one-process world.
    with pytest.raises(HorovodTpuError):
        tcoll.alltoall(torch.arange(4.0), splits=[3])
    with pytest.raises(HorovodTpuError):
        tcoll.alltoall(torch.arange(4.0), splits=[2, 2])
    out, recv = tcoll.alltoall(torch.arange(4.0), splits=[4])
    assert torch.equal(out, torch.arange(4.0)) and recv.tolist() == [4]
    assert torch.equal(tcoll.allgather(torch.arange(3.0)), torch.arange(3.0))
    assert tcoll.join() == -1
    with pytest.raises(HorovodTpuError, match="names no mesh axis"):
        tcoll.allreduce(torch.ones(1), axis="local")
