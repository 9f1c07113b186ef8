"""The port's Adasum (ops/adasum.py) held against the JAX package's.

* ``allreduce(op=Adasum)`` per leaf and ``adasum_allreduce_tree`` on gloo
  worlds of 2, 3, 4 and 5 CPU processes (``context.spawn_gloo``, one world
  a size for every case) against ``horovod_tpu.ops.adasum.
  adasum_allreduce`` under ``shard_map`` on as many of the 8 CPU devices,
  from the same seeded numpy leaves per rank, in fp32 and bf16 (rounded to
  bf16 after every combine on both sides), with a leaf that is zero on
  rank 0 and one that is zero everywhere (the zero-norm guard). Tolerance:
  1e-5 of the leaf's max |x| (the fp32 dots are summed in other orders:
  rows of 1024 then fp64 in the port, one fp32 ``vdot`` in the JAX
  package). World 5 takes the remainder path (pre-combine and hand-back).
* The twins of ``test_parallel.py::test_adasum_orthogonal_adds_parallel_
  averages`` (every world) and ``::test_adasum_two_rank_formula`` (world
  2), at their rtol 1e-5.
* :func:`adasum_stacked` (the schedule over virtual ranks in one process)
  equal bit for bit to the distributed result on world 4, and to
  ``_pairwise`` applied leaf by leaf in the schedule's order.
* :func:`adasum_fold` against ``horovod_tpu.ops.eager._adasum_fold``
  (numpy) in fp64 within 1e-12 relative: the same fold, its dots summed by
  numpy's BLAS and by torch in other orders (one fp64 ulp apart at most in
  the runs this was written against). It pairs as VHDD at 2-4 and 6-8
  ranks (the fp32 schedule within 1e-5 relative L2 of it) and not at 5
  (nor 9), where the reference's VHDD and the port's agree with each other
  and both differ from the fold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd
from horovod_tpu import _compat
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu.ops.eager import _adasum_fold
from horovod_tpu_torch import context
from horovod_tpu_torch.ops import adasum as tadasum
from horovod_tpu_torch.ops import collectives as tcoll

WORLDS = (2, 3, 4, 5)
TOL = 1e-5


def _leaves(rank):
    """Rank ``rank``'s seeded leaves: fp32 and bf16 (as fp32 values that
    bf16 holds exactly), a leaf zero on rank 0 and one zero everywhere."""
    rs = np.random.RandomState(100 + rank)
    bf = np.asarray(jnp.asarray(rs.standard_normal((37, 5)) * 0.3,
                                jnp.bfloat16).astype(jnp.float32))
    return {
        "w": rs.standard_normal((16, 9)).astype(np.float32),
        "b": (rs.standard_normal((1500,)) * 1e-3).astype(np.float32),
        "h": bf,
        "z0": (np.zeros((6,), np.float32) if rank == 0
               else rs.standard_normal((6,)).astype(np.float32)),
        "zz": np.zeros((4,), np.float32),
    }


BF16 = ("h",)


def _torch_leaves(rank):
    return {k: torch.tensor(v).to(torch.bfloat16 if k in BF16
                                      else torch.float32)
            for k, v in _leaves(rank).items()}


def _np(t):
    return t.float().numpy()


def _port_adasum():
    """One rank: Adasum per leaf, over the whole tree, and the twins'
    inputs."""
    rank, world = context.rank(), context.size()
    tree = _torch_leaves(rank)
    per_leaf = {k: _np(tcoll.allreduce(v, op=tcoll.Adasum))
                for k, v in tree.items()}
    whole = {k: _np(v) for k, v in
             tadasum.adasum_allreduce_tree(tree).items()}
    out = {"per_leaf": per_leaf, "tree": whole}
    # Prescale before and postscale after, as the JAX device path does.
    out["scaled"] = _np(tcoll.allreduce(tree["w"], op=tcoll.Adasum,
                                        prescale_factor=0.5,
                                        postscale_factor=4.0))
    eye = torch.eye(world) * 3.0
    out["orth"] = tcoll.allreduce(eye[rank], op=tcoll.Adasum).numpy()
    same = torch.arange(1.0, 5.0)
    out["same"] = tcoll.allreduce(same, op=tcoll.Adasum).numpy()
    if world == 2:
        rs = np.random.RandomState(1)
        ab = [rs.randn(6).astype(np.float32) for _ in range(2)]
        out["pair"] = tcoll.allreduce(torch.from_numpy(ab[rank]),
                                      op=tcoll.Adasum).numpy()
    return out


@pytest.fixture(scope="module", params=WORLDS)
def world(request):
    n = request.param
    return n, context.spawn_gloo(n, _port_adasum)


def _jax_adasum(n):
    ctx = hvd.init(devices=jax.devices("cpu")[:n])
    try:
        trees = [{k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else
                                 jnp.float32) for k, v in _leaves(r).items()}
                 for r in range(n)]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)

        def body(t):
            t = jax.tree.map(lambda a: a[0], t)
            out = jadasum.adasum_allreduce_tree(t)
            out["scaled"] = hvd.allreduce(t["w"], op=hvd.Adasum,
                                          prescale_factor=0.5,
                                          postscale_factor=4.0)
            return jax.tree.map(lambda a: a[None], out)

        fn = jax.jit(_compat.shard_map(
            body, mesh=ctx.mesh, in_specs=(P(hvd.WORLD_AXIS),),
            out_specs=P(hvd.WORLD_AXIS), check_vma=False))
        out = fn(stacked)
        return [{k: np.asarray(v[r].astype(jnp.float32))
                 for k, v in out.items()} for r in range(n)]
    finally:
        hvd.shutdown()


def _close(got, want, what):
    tol = TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def test_adasum_matches_the_reference(world):
    n, port = world
    ref = _jax_adasum(n)
    for rank in range(n):
        for key in _leaves(0):
            _close(port[rank]["per_leaf"][key], ref[rank][key],
                   f"world {n} rank {rank} {key} (allreduce)")
            _close(port[rank]["tree"][key], ref[rank][key],
                   f"world {n} rank {rank} {key} (tree)")
        _close(port[rank]["scaled"], ref[rank]["scaled"],
               f"world {n} rank {rank} scaled")
        # Every rank ends with the same values, bit for bit.
        for key in _leaves(0):
            np.testing.assert_array_equal(port[rank]["tree"][key],
                                          port[0]["tree"][key])
    np.testing.assert_array_equal(port[0]["tree"]["zz"], 0.0)


def test_adasum_twins_of_the_reference_tests(world):
    n, port = world
    # test_adasum_orthogonal_adds_parallel_averages (world 8 there; the
    # property holds at every world size).
    eye = np.eye(n, dtype=np.float32) * 3.0
    for r in range(n):
        np.testing.assert_allclose(port[r]["orth"], eye.sum(0), rtol=1e-5)
        np.testing.assert_allclose(port[r]["same"], np.arange(1.0, 5.0),
                                   rtol=1e-5)
    if n == 2:  # test_adasum_two_rank_formula
        rs = np.random.RandomState(1)
        a = rs.randn(6).astype(np.float32)
        b = rs.randn(6).astype(np.float32)
        dot = a @ b
        want = (1 - dot / (2 * (a @ a))) * a + (1 - dot / (2 * (b @ b))) * b
        for r in range(2):
            np.testing.assert_allclose(port[r]["pair"], want, rtol=1e-5)


def test_stacked_schedule_is_the_distributed_result(world):
    n, port = world
    trees = [_torch_leaves(r) for r in range(n)]
    stacked = tadasum.adasum_stacked(trees)
    for key in _leaves(0):
        np.testing.assert_array_equal(_np(stacked[key]),
                                      port[0]["tree"][key])
    # The same schedule leaf by leaf with _pairwise (dots by torch.dot):
    # the result up to the dots' summation order.
    sched = tadasum.schedule(n)
    for key in _leaves(0):
        x = [t[key] for t in trees]
        for even, odd in sched.pre:
            x[even] = tadasum._pairwise(x[even], x[odd])
        for pairs in sched.rounds:
            for lo, hi in pairs:
                x[lo] = x[hi] = tadasum._pairwise(x[lo], x[hi])
        _close(_np(stacked[key]), _np(x[0]), f"world {n} {key} _pairwise")


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 8])
def test_adasum_fold_is_the_reference_fold(n):
    g = np.random.RandomState(n).randn(n, 7, 33).astype(np.float32)
    want = _adasum_fold(g)
    got = tadasum.adasum_fold(torch.from_numpy(g))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    # Zero contributions take the guard, as in the reference.
    g[0] = 0.0
    np.testing.assert_allclose(tadasum.adasum_fold(torch.from_numpy(g)),
                               _adasum_fold(g), rtol=1e-12,
                               atol=1e-12 * np.abs(_adasum_fold(g)).max())


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pairing(n, vhdd):
    """The nested pairs a reduction of ``n`` ranks forms (ranks as ints)."""
    if vhdd:
        x = list(range(n))
        s = tadasum.schedule(n)
        for even, odd in s.pre:
            x[even] = (x[even], x[odd])
        for pairs in s.rounds:
            for lo, hi in pairs:
                x[lo] = x[hi] = (x[lo], x[hi])
        return x[0]
    v = list(range(n))
    while len(v) > 1:
        v = [(v[i], v[i + 1]) if i + 1 < len(v) else v[i]
             for i in range(0, len(v), 2)]
    return v[0]


@pytest.mark.parametrize("n", range(2, 9))
def test_fold_pairs_like_vhdd_only_at_some_sizes(n):
    # The fold (the reference's process path) and VHDD (its device path)
    # pair alike at 2-4 and 6-8 ranks, and not at 5 (nor at 9-11 and 13,
    # past the 8 CPU devices). Not a fault of the port: the reference's own
    # VHDD agrees with the port's.
    alike = _pairing(n, True) == _pairing(n, False)
    assert alike == (n != 5)
    assert (_pairing(9, True) == _pairing(9, False)) is False
    g = np.random.RandomState(50 + n).randn(n, 300).astype(np.float32)
    vhdd = _np(tadasum.adasum_stacked([{"g": torch.from_numpy(v)}
                                       for v in g])["g"])
    fold = _adasum_fold(g)
    if alike:
        assert _rel_l2(vhdd, fold) <= 1e-5
        return
    assert _rel_l2(vhdd, fold) > 1e-3
    ctx = hvd.init(devices=jax.devices("cpu")[:n])
    try:
        fn = jax.jit(_compat.shard_map(
            lambda x: jadasum.adasum_allreduce(x[0])[None],
            mesh=ctx.mesh, in_specs=(P(hvd.WORLD_AXIS),),
            out_specs=P(hvd.WORLD_AXIS), check_vma=False))
        ref = np.asarray(fn(jnp.asarray(g)))[0]
    finally:
        hvd.shutdown()
    _close(vhdd, ref, f"VHDD at n={n}")


def test_schedule_shapes():
    s5 = tadasum.schedule(5)
    assert s5.pre == ((0, 1),) and s5.post == ((0, 1),)
    assert s5.rounds == (((0, 2), (3, 4)), ((0, 3), (2, 4)))
    s4 = tadasum.schedule(4)
    assert s4.pre == () and s4.rounds == (((0, 1), (2, 3)), ((0, 2), (1, 3)))
    assert tadasum.schedule(1).rounds == ()
    # At one process the reduction is a copy.
    x = torch.arange(3.0)
    y = tcoll.allreduce(x, op=tcoll.Adasum)
    assert torch.equal(x, y) and y is not x
