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
