"""The port's object and state helpers (functions.py) against the JAX
package's ``functions.py``, on a gloo world of 3 CPU processes
(``context.spawn_gloo``, one world for every case) with root rank 1:

* ``broadcast_object`` and ``allgather_object`` of objects of a different
  pickled size on each rank;
* ``broadcast_variables`` (and its alias ``broadcast_parameters``) of a
  nest of fp32, bf16, int64 and bool tensors, different on each rank: the
  root's values bit for bit, new tensors, the inputs left alone;
* ``broadcast_optimizer_state`` with mixed leaves
  (``test_collectives.py::test_broadcast_optimizer_state_with_mixed_leaves``'s
  twin: a string, an int, a float, None, a numpy array, a tensor) and the
  port's own ``DistributedOptState`` of AdamW three passes in at
  ``backward_passes_per_step=2`` (its accumulator differing by rank): the
  root's values exactly, every leaf's type kept, the NamedTuples rebuilt.

The one-process semantics are held against the JAX functions themselves
(its process path at one process).
"""

import jax
import numpy as np
import pytest
import torch

import horovod_tpu as hvd
from horovod_tpu_torch import context
from horovod_tpu_torch import functions as tfn
from horovod_tpu_torch import optimizer as topt

WORLD, ROOT = 3, 1


def _obj(rank):
    return {"rank": rank, "name": "r" * (rank + 1), "data": list(range(rank * 7)),
            "arr": np.arange(rank + 2, dtype=np.int16)}


def _tree(rank):
    g = torch.Generator().manual_seed(rank)
    return {"w": torch.randn((4, 3), generator=g),
            "h": torch.randn((5,), generator=g).to(torch.bfloat16),
            "i": torch.arange(6) * (rank + 1),
            "m": torch.tensor([True, rank == 0, False])}


def _state(rank):
    opt = topt.DistributedOptimizer(topt.adamw(1e-2),
                                    backward_passes_per_step=2)
    params = {"w": torch.zeros(3), "b": torch.zeros(2)}
    state = opt.init(params)
    for i in range(3):  # the second pass reduces, on every rank together
        grads = {"w": torch.full((3,), rank + 1.0 + i),
                 "b": torch.full((2,), -1.0 - rank)}
        _, state = opt.update(grads, state, params)
    return {"opt": state, "name": f"adam{rank}", "step": 3 + rank,
            "lr": 0.5 * rank, "none": None,
            "count": np.full((2,), rank, np.float32)}


def _port_functions():
    rank = context.rank()
    out = {"object": tfn.broadcast_object(_obj(rank), ROOT),
           "gathered": tfn.allgather_object(_obj(rank))}
    tree = _tree(rank)
    kept = {k: v.clone() for k, v in tree.items()}
    got = tfn.broadcast_parameters(tree, ROOT)
    assert all(torch.equal(tree[k], kept[k]) for k in tree)  # inputs kept
    assert all(got[k].data_ptr() != tree[k].data_ptr() for k in tree)
    out["variables"] = got
    out["state_own"] = _state(rank)
    out["state"] = tfn.broadcast_optimizer_state(out["state_own"], ROOT)
    return out


@pytest.fixture(scope="module")
def port_world():
    return context.spawn_gloo(WORLD, _port_functions)


def test_broadcast_and_allgather_object(port_world):
    want = _obj(ROOT)
    for r in range(WORLD):
        got = port_world[r]["object"]
        assert {k: v for k, v in got.items() if k != "arr"} == {
            k: v for k, v in want.items() if k != "arr"}
        np.testing.assert_array_equal(got["arr"], want["arr"])
        assert got["arr"].dtype == np.int16
        gathered = port_world[r]["gathered"]
        assert [g["name"] for g in gathered] == [_obj(i)["name"]
                                                 for i in range(WORLD)]
        assert [g["data"] for g in gathered] == [_obj(i)["data"]
                                                 for i in range(WORLD)]


def test_broadcast_variables_is_the_roots_bit_for_bit(port_world):
    want = _tree(ROOT)
    for r in range(WORLD):
        got = port_world[r]["variables"]
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert torch.equal(got[k], want[k]), (r, k)


def _leaves(node, out):
    if isinstance(node, dict):
        for k in sorted(node):
            _leaves(node[k], out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _leaves(v, out)
    else:
        out.append(node)
    return out


def test_broadcast_optimizer_state_with_mixed_leaves(port_world):
    want = port_world[ROOT]["state_own"]
    for r in range(WORLD):
        got = port_world[r]["state"]
        # The reference test's leaves: types kept, values exact.
        assert got["name"] == "adam1" and type(got["step"]) is int
        assert got["step"] == 4 and got["lr"] == 0.5 and got["none"] is None
        assert got["count"].dtype == np.float32
        np.testing.assert_array_equal(got["count"], want["count"])
        opt = got["opt"]
        assert type(opt) is topt.DistributedOptState
        assert type(opt.inner) is topt.AdamState
        for a, b in zip(_leaves(opt, []), _leaves(want["opt"], [])):
            assert type(a) is type(b)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b)
            else:
                assert a == b


@pytest.fixture
def world8():
    hvd.init(devices=jax.devices("cpu")[:8])
    yield
    hvd.shutdown()


def test_one_process_semantics_match_the_reference(world8):
    # hvd.* here is the JAX package's process path at one process.
    obj = {"a": 1, "b": [1, 2, 3], "c": "hello"}
    assert tfn.broadcast_object(obj, 0) == hvd.broadcast_object(obj, 0) == obj
    assert tfn.allgather_object(obj) == hvd.allgather_object(obj) == [obj]
    state = {"count": np.zeros((2,), np.float32), "name": "adam", "step": 3}
    got = tfn.broadcast_optimizer_state(state, 0)
    ref = hvd.broadcast_optimizer_state(state, 0)
    assert got["name"] == ref["name"] == "adam"
    assert got["step"] == ref["step"] == 3
    np.testing.assert_array_equal(got["count"], np.asarray(ref["count"]))
    x = {"w": torch.arange(3.0)}
    y = tfn.broadcast_variables(x)
    assert torch.equal(y["w"], x["w"]) and y["w"] is not x["w"]
    assert tfn.broadcast_variables({}) == {}
