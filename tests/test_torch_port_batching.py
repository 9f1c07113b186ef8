"""The port's request packing (horovod_tpu_torch.ops.batching) held
against the JAX package's ``ops/batching.py`` on the same requests: the
packed batch, the row->request routing and the unpacked responses agree
exactly on full and partial batches of mixed-leaf requests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import batching as jb
from horovod_tpu_torch.ops import batching as tb


def _requests(n, seed=0):
    rs = np.random.RandomState(seed)
    return [
        {"x": rs.standard_normal((3,)).astype(np.float32),
         "tok": rs.randint(0, 100, (2, 2)).astype(np.int32),
         "n": np.int32(i)}
        for i in range(n)
    ]


@pytest.mark.parametrize("n,batch", [(1, 1), (3, 8), (4, 4), (5, 8), (7, 8)])
def test_pack_requests_matches_jax(n, batch):
    reqs = _requests(n, seed=n)
    jbatch, jspec = jb.pack_requests(
        [jax.tree.map(jnp.asarray, r) for r in reqs], batch
    )
    tbatch, tspec = tb.pack_requests(
        [{k: torch.from_numpy(np.asarray(v)) for k, v in r.items()}
         for r in reqs], batch,
    )
    assert tspec.row_to_request == jspec.row_to_request
    assert (tspec.n_valid, tspec.batch_size, tspec.fill) == (
        jspec.n_valid, jspec.batch_size, jspec.fill
    )
    for key in ("x", "tok", "n"):
        np.testing.assert_array_equal(tbatch[key].numpy(),
                                      np.asarray(jbatch[key]))
    # A model that maps each row to a new schema: responses route back.
    jout = {"y": jbatch["x"][:, :2] * 10.0, "m": jbatch["n"] + 1}
    tout = {"y": tbatch["x"][:, :2] * 10.0, "m": tbatch["n"] + 1}
    jresp = jb.unpack_responses(jout, jspec)
    tresp = tb.unpack_responses(tout, tspec)
    for i, (j, t) in enumerate(zip(jresp, tresp)):
        np.testing.assert_array_equal(t["y"].numpy(), np.asarray(j["y"]))
        assert int(t["m"]) == int(j["m"]) == i + 1
    for i, back in enumerate(tb.unpack_requests(tbatch, tspec)):
        np.testing.assert_array_equal(back["tok"].numpy(), reqs[i]["tok"])


def test_bare_tensor_requests_and_pad_rows():
    reqs = [torch.full((4,), float(i)) for i in range(3)]
    batch, spec = tb.pack_requests(reqs, 8)
    assert batch.shape == (8, 4) and spec.fill == 3 / 8
    assert torch.all(batch[3:] == 0)
    assert list(spec.row_to_request) == [2, 1, 0]
    resp = tb.unpack_responses(batch * 2, spec)
    assert [float(r[0]) for r in resp] == [0.0, 2.0, 4.0]


def test_schema_validation():
    with pytest.raises(ValueError, match="at least one"):
        tb.pack_requests([], 4)
    with pytest.raises(ValueError, match="exceed batch_size"):
        tb.pack_requests([torch.zeros(2)] * 5, 4)
    with pytest.raises(ValueError, match="schema mismatch"):
        tb.pack_requests([torch.zeros(3), torch.zeros(4)], 4)
    with pytest.raises(ValueError, match="schema mismatch"):
        tb.pack_requests([{"x": torch.zeros(3)}, {"y": torch.zeros(3)}], 4)
    with pytest.raises(ValueError, match="schema mismatch"):
        tb.pack_requests([torch.zeros(3), torch.zeros(3, dtype=torch.int32)], 4)
    _, spec = tb.pack_requests([torch.zeros(2)] * 2, 4)
    with pytest.raises(ValueError, match="leading dim"):
        tb.unpack_responses(torch.zeros((3, 2)), spec)


def test_pack_unpack_buckets_match_jax():
    tree = {"a": np.arange(8.0, dtype=np.float32),
            "b": np.arange(3, dtype=np.int32),
            "c": np.ones((2, 3), np.float32)}
    jbufs, jspec = jb.pack(jax.tree.map(jnp.asarray, tree),
                           threshold_bytes=40, pad_multiple=4)
    tbufs, tspec = tb.pack({k: torch.from_numpy(v) for k, v in tree.items()},
                           threshold_bytes=40, pad_multiple=4)
    assert tspec.pad == jspec.pad
    assert [[(s.index, s.size) for s in b] for b in tspec.buckets] == [
        [(s.index, s.size) for s in b] for b in jspec.buckets
    ]
    for t, j in zip(tbufs, jbufs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    out = tb.unpack(tbufs, tspec)
    for k, v in tree.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
    assert tb.leaf_nbytes(torch.zeros((2, 3), dtype=torch.bfloat16)) == 12


def test_tree_flatten_orders_like_jax():
    tree = {"b": [torch.zeros(1), (torch.ones(1), 3)], "a": torch.ones(2)}
    leaves, td = tb.tree_flatten(tree)
    jleaves, _ = jax.tree.flatten(
        {"b": [0, (1, 3)], "a": 2}
    )
    assert [int(x.numel()) if isinstance(x, torch.Tensor) else x
            for x in leaves] == [2, 1, 1, 3]
    assert jleaves == [2, 0, 1, 3]  # same order: "a" first, then "b"
    back = tb.tree_unflatten(td, leaves)
    assert isinstance(back["b"], list) and isinstance(back["b"][1], tuple)
    assert tb.tree_flatten(back)[1] == td
