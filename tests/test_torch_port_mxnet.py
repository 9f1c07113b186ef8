"""The port's MXNet frontend (horovod_tpu_torch.mxnet) held against the JAX
package's (horovod_tpu.mxnet), on the CPU, with the contract tests' fake
``mxnet``.

Twins of ``tests/test_mxnet_contract.py``: at world 1 each case runs on
both frontends (the JAX package's over its native runtime) and their
outputs must be equal; on a gloo world of 2 (``tests/torch_spark_ranks.
py``, which holds the same fake) the port's collectives, parameter
broadcast, optimizer and trainer must give the exact sums and means of
the ranks' values (small integers in fp32: exact). The missing-mxnet
path raises the same clean ImportError on both.
"""

import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch import context

import torch_spark_ranks as R


@pytest.fixture
def both(monkeypatch):
    """The port's and the JAX package's frontends on the fake mxnet, each
    with a world of one."""
    monkeypatch.setitem(sys.modules, "mxnet", R.fake_mx())
    sys.modules.pop("horovod_tpu.mxnet", None)
    import horovod_tpu.mxnet as ref
    import horovod_tpu_torch.mxnet as port

    ref.init(0, 1)
    port.init(0, 1, device="cpu")
    yield port, ref
    port.shutdown()
    ref.shutdown()


def test_rank_size(both):
    for hvd_mx in both:
        assert (hvd_mx.rank(), hvd_mx.size()) == (0, 1)
        assert hvd_mx.is_initialized()


def test_allreduce_roundtrip(both):
    t = R.NDArray(np.arange(6, dtype=np.float32).reshape(2, 3))
    outs = [hvd_mx.allreduce(t, name="c0").asnumpy() for hvd_mx in both]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], t.asnumpy())
    outs = [hvd_mx.allreduce(t, average=False, name="c1").asnumpy()
            for hvd_mx in both]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_allgather_broadcast(both):
    t = R.NDArray(np.arange(4, dtype=np.float32).reshape(2, 2) + 1)
    for call in (lambda m: m.allgather(t, name="g0"),
                 lambda m: m.broadcast(t, root_rank=0, name="b0")):
        outs = [call(hvd_mx).asnumpy() for hvd_mx in both]
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[0], t.asnumpy())


def test_broadcast_parameters(both):
    for hvd_mx in both:
        params = {"w": R.Param(np.full((3,), 2.0, np.float32)),
                  "b": R.NDArray(np.ones(2, np.float32))}
        hvd_mx.broadcast_parameters(params, root_rank=0)
        np.testing.assert_array_equal(params["w"].data().asnumpy(), 2.0)
        np.testing.assert_array_equal(params["b"].asnumpy(), 1.0)
        with pytest.raises(ValueError):
            hvd_mx.broadcast_parameters([1, 2, 3])


def test_distributed_optimizer_wraps_update(both):
    for hvd_mx in both:
        dopt = hvd_mx.DistributedOptimizer(R.SGD())
        g = R.NDArray(np.ones((4,), np.float32))
        dopt.update(0, None, g, None)
        dopt.update_multi_precision(1, None, g, None)
        assert [i for i, _ in dopt.updates] == [0, 1]
        np.testing.assert_array_equal(dopt.updates[0][1].asnumpy(), 1.0)
        assert isinstance(dopt, R.SGD)


def test_distributed_trainer_allreduce_grads(both):
    for hvd_mx in both:
        params = {"w": R.Param(np.zeros((3,), np.float32))}
        params["w"]._grad = R.NDArray(np.full((3,), 5.0, np.float32))
        trainer = hvd_mx.DistributedTrainer(params, "sgd")
        trainer._allreduce_grads()  # a world of one leaves them as they are
        np.testing.assert_array_equal(params["w"].list_grad()[0].asnumpy(),
                                      5.0)


def test_init_wants_the_card_unless_given_the_cpu(monkeypatch):
    """``init`` forwards to ``native.init``: with no ``device`` it asks for
    this process's card, which a machine without CUDA refuses."""
    monkeypatch.setitem(sys.modules, "mxnet", R.fake_mx())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import horovod_tpu_torch.mxnet as port

    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.init(0, 1)
    assert not port.is_initialized()


def test_missing_mxnet_raises_clean_importerror(monkeypatch):
    monkeypatch.setitem(sys.modules, "mxnet", None)
    sys.modules.pop("horovod_tpu.mxnet", None)
    import horovod_tpu.mxnet as ref
    import horovod_tpu_torch.mxnet as port

    for hvd_mx in (port, ref):
        for call in (lambda m: m.allreduce(np.ones(2)),
                     lambda m: m.broadcast_parameters({}),
                     lambda m: m.DistributedOptimizer(R.SGD())):
            with pytest.raises(ImportError, match="mxnet"):
                call(hvd_mx)


def test_world_of_two_on_gloo():
    """Every call on a gloo world of 2: rank r holds r + 1."""
    a, b = context.spawn_gloo(2, R.mx_world)
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, out in enumerate((a, b)):
        assert (out["rank"], out["size"]) == (r, 2)
        np.testing.assert_array_equal(out["avg"], base * 1.5)
        np.testing.assert_array_equal(out["sum"], base * 3)
        np.testing.assert_array_equal(
            out["gather"], np.concatenate([base[:1], base[:2] * 2]))
        np.testing.assert_array_equal(out["bcast"], base * 2)
        np.testing.assert_array_equal(out["bp"]["w"], np.full(3, 2.0))
        np.testing.assert_array_equal(out["bp"]["b"], np.zeros(2))
        idx = [i for i, _ in out["opt"]]
        assert idx == [0, 1, [2, 3]]
        np.testing.assert_array_equal(out["opt"][0][1], np.full(4, 1.5))
        np.testing.assert_array_equal(out["opt"][1][1], np.full(4, 1.5))
        np.testing.assert_array_equal(out["opt"][2][1][0], np.full(4, 1.5))
        np.testing.assert_array_equal(out["opt"][2][1][1], np.full(2, 3.0))
        np.testing.assert_array_equal(out["trainer"], np.full(3, 6.0))
