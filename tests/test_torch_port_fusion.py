"""The port's fusion layer and collectives held against the JAX package's.

* ``bucket_byte_layout`` of the port against the JAX package's on the
  same flax-layout tree of GPT-2 small's shapes (nested dicts, keys in
  sorted order on both sides -- so ``block_10`` sorts before ``block_2``),
  at several thresholds and pad multiples: equal.
* ``fused_allreduce``, ``fused_reducescatter`` and ``fused_allgather`` on
  a gloo world of 2 CPU processes (``context.spawn_gloo``) against the
  JAX functions under ``shard_map`` on 2 CPU devices, with the wire
  uncompressed, cast to bf16, and cast to fp16 with the max-abs prescale
  (one element large enough to move the scale off 1). Rank r holds the
  same seeded tree on both sides. Tolerance 0: each reduced element is a
  sum of two values, rounded once in the wire dtype on either side, and
  the Average's division by 2 is exact.
* The port's own parameter dict: the trainer packs it (not the flax tree),
  so its ZeRO-1 state is laid out by the port's names; the layout matches
  what ``pack`` builds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu import _compat
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.ops.compression import Compression as JComp
from horovod_tpu_torch import context
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.ops.compression import Compression as TComp

WORLD = 2
THRESHOLD = 256  # bytes: several buckets per dtype
COMPRESSIONS = ["none", "bf16", "fp16"]


def _flax_shapes():
    cfg = jgpt2.GPT2Config.small()
    return jax.eval_shape(
        jgpt2.GPT2LMModel(cfg).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 8), jnp.int32),
    )["params"]


@pytest.mark.parametrize("pad_multiple", [1, 2, 8])
@pytest.mark.parametrize("threshold", [None, 4 << 20, 64 << 20])
def test_bucket_byte_layout_matches_the_reference(threshold, pad_multiple):
    shapes = _flax_shapes()
    want = jfusion.bucket_byte_layout(shapes, threshold,
                                      pad_multiple=pad_multiple)
    meta = jax.tree.map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        shapes,
    )
    got = tfusion.bucket_byte_layout(meta, threshold,
                                     pad_multiple=pad_multiple)
    assert got == want and len(got) > 1


def test_port_parameter_dict_layout_is_what_pack_builds():
    from horovod_tpu_torch.models import GPT2Config, GPT2LMModel

    cfg = GPT2Config.tiny(param_dtype=torch.float32)
    params = dict(GPT2LMModel(cfg, device="cpu").named_parameters())
    layout = tfusion.bucket_byte_layout(params, 64 << 10, pad_multiple=4)
    with torch.no_grad():
        buffers, spec = tfusion.pack(params, 64 << 10, pad_multiple=4)
    assert layout == [("float32", b.numel() * 4) for b in buffers]
    assert list(spec.padded_sizes()) == [b.numel() for b in buffers]
    # Every name of the port's dict lands in exactly one slot.
    assert sorted(s.index for slots in spec.buckets for s in slots) == list(
        range(len(params))
    )


def _tree(rank):
    rs = np.random.RandomState(rank)
    w = rs.standard_normal((5, 7)).astype(np.float32)
    if rank == 1:
        w[2, 3] = 3.0e4  # the fp16 prescale must move off 1
    return {
        "w": w,
        "b": rs.standard_normal((13,)).astype(np.float32),
        "z": {"k": rs.standard_normal((3, 11)).astype(np.float32)},
        "h": rs.standard_normal((4, 9)).astype(np.float32),
    }


def _port_collectives():
    """One rank of the gloo world: every collective under every wire."""
    rank = context.rank()
    tree = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                {kk: torch.from_numpy(vv) for kk, vv in v.items()})
            for k, v in _tree(rank).items()}
    out = {}
    for name in COMPRESSIONS:
        comp = getattr(TComp, name)
        ar = tfusion.fused_allreduce(tree, threshold_bytes=THRESHOLD,
                                     compression=comp)
        shards, spec = tfusion.fused_reducescatter(
            tree, threshold_bytes=THRESHOLD, compression=comp
        )
        ag = tfusion.fused_allgather(shards, spec, compression=comp)
        np_tree = functools.partial(jax.tree.map, lambda t: t.numpy())
        out[name] = {
            "allreduce": np_tree(ar),
            "shards": [s.numpy() for s in shards.buffers],
            "allgather": np_tree(ag),
        }
    return out


@pytest.fixture(scope="module")
def port_world():
    return context.spawn_gloo(WORLD, _port_collectives)


@pytest.fixture(scope="module")
def jax_world():
    ctx = hvd.init(devices=jax.devices("cpu")[:WORLD])
    yield ctx
    hvd.shutdown()


def _jax_run(ctx, name):
    comp = getattr(JComp, name)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[_tree(r) for r in range(WORLD)])

    def body(t):
        t = jax.tree.map(lambda x: x[0], t)
        ar = jfusion.fused_allreduce(t, threshold_bytes=THRESHOLD,
                                     compression=comp)
        shards, spec = jfusion.fused_reducescatter(
            t, threshold_bytes=THRESHOLD, compression=comp
        )
        ag = jfusion.fused_allgather(shards, spec, compression=comp)
        return ar, shards.buffers, ag

    fn = jax.jit(_compat.shard_map(
        body, mesh=ctx.mesh, in_specs=(P(hvd.WORLD_AXIS),),
        out_specs=(P(), P(hvd.WORLD_AXIS), P()), check_vma=False,
    ))
    ar, shards, ag = fn(stacked)
    return (jax.tree.map(np.asarray, ar), [np.asarray(s) for s in shards],
            jax.tree.map(np.asarray, ag))


def _equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", COMPRESSIONS)
def test_fused_allreduce_matches_the_reference(port_world, jax_world, name):
    want, _, _ = _jax_run(jax_world, name)
    for rank in range(WORLD):
        _equal(port_world[rank][name]["allreduce"], want)


@pytest.mark.parametrize("name", COMPRESSIONS)
def test_fused_reducescatter_matches_the_reference(port_world, jax_world,
                                                   name):
    # The JAX shards come back concatenated over the world axis: rank r's
    # shard of bucket i is its r-th chunk.
    _, want, _ = _jax_run(jax_world, name)
    assert len(port_world[0][name]["shards"]) == len(want) > 2
    for i, full in enumerate(want):
        chunks = np.split(full, WORLD)
        for rank in range(WORLD):
            np.testing.assert_array_equal(
                port_world[rank][name]["shards"][i], chunks[rank]
            )


@pytest.mark.parametrize("name", COMPRESSIONS)
def test_fused_allgather_matches_the_reference(port_world, jax_world, name):
    _, _, want = _jax_run(jax_world, name)
    if name == "fp16":
        # XLA on the CPU folds the fp16 round trip around the move-only
        # all-gather (excess precision allowed), so the reference's gather
        # comes back unrounded; the port rounds on the wire, as the
        # reference does on a TPU. Its values stay under the prescale's
        # threshold, so the wire scale is exactly 1 and the wire is a cast.
        assert max(np.abs(x).max() for x in jax.tree.leaves(want)) < (
            tfusion.FP16_SAFE_MAX
        )
        want = jax.tree.map(
            lambda x: x.astype(np.float16).astype(np.float32), want
        )
    for rank in range(WORLD):
        _equal(port_world[rank][name]["allgather"], want)
    # Reduce-scatter then all-gather is the allreduce -- except on the fp16
    # wire, where the gather rounds again at another scale.
    if name != "fp16":
        _equal(port_world[0][name]["allgather"],
               port_world[0][name]["allreduce"])
