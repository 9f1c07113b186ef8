"""The port's PyTorch frontend (``horovod_tpu_torch.torch``) against the JAX
package's (``horovod_tpu.torch``).

Twins of ``tests/test_torch_api.py`` (lines 63-483). Multi-process: the
same cases (``tests/torch_eager_ranks.py`` TORCH_SUITE) on a world of two
processes of each frontend -- the port's on the store of a gloo world
``horovod_tpu_torch.init`` formed, the JAX package's on its native TCP
runtime -- from the same seeded weights and data: the optimizer's
parameters after training (SGD, AdamW, ``backward_passes_per_step``)
within 1e-6 and Adasum's within 1e-5 (they are bit for bit here), every
collective's result, SyncBatchNorm's global statistics and gradients,
``broadcast_optimizer_state``, ``TorchState.sync``, an uneven join and
``ElasticSampler``. Single-process: the wrappers at world 1.
"""

import numpy as np
import pytest
import torch

import torch_eager_ranks as R

CASES = [c.__name__ for c in R.TORCH_SUITE]
TOL = {"t_adasum": 1e-5}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    def run_ref():
        R.shared(tmp_path_factory, "refbuild", lambda: R.reference_build())
        return R.run_world("ref", "torch", 2)

    return {"port": R.shared(tmp_path_factory, "torch_port",
                             lambda: R.run_world("port", "torch", 2)),
            "ref": R.shared(tmp_path_factory, "torch_ref", run_ref)}


def _close(got, want, tol, where):
    if isinstance(want, list) and want and isinstance(want[0], np.ndarray):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype, where
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=where)
    elif isinstance(want, list) and want and isinstance(want[0], float):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=where)
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("case", CASES)
def test_frontend_case_matches_the_reference(worlds, case):
    for rank in range(2):
        p, r = worlds["port"][rank][case], worlds["ref"][rank][case]
        assert set(p) == set(r), (rank, set(p) ^ set(r))
        for key, want in r.items():
            if key == "_seconds":
                continue
            _close(p[key], want, TOL.get(case, 1e-6),
                   f"rank {rank} {case}.{key}")


def test_frontend_world_semantics(worlds):
    port = worlds["port"]
    for rank in range(2):
        res = port[rank]["t_collectives"]
        np.testing.assert_array_equal(res["avg"], np.full(4, 1.5, np.float32))
        np.testing.assert_array_equal(res["inplace"],
                                      np.full((2, 3), 3.0, np.float32))
        assert res["inplace_is_t"] is True
        assert res["ag"].shape == (3, 2)
        np.testing.assert_array_equal(res["bc"], np.ones(3, np.float32))
        np.testing.assert_array_equal(res["bc_"], np.ones(3, np.float32))
        assert res["a2a_splits"].tolist() == [2, 2]
        assert res["scalar_shape"] == ()
    # Every rank ends with the same weights; the uneven join returns a rank.
    for case in ("t_optimizer_sgd", "t_backward_passes", "t_adasum"):
        np.testing.assert_array_equal(port[0][case]["w"], port[1][case]["w"])
    assert port[0]["t_join_uneven"]["last"] in (0, 1)
    assert port[0]["t_torch_state_sync"]["epochs"] == [0, 0]
    np.testing.assert_array_equal(port[1]["t_torch_state_sync"]["w"],
                                  np.ones((1, 2), np.float32))
    assert port[0]["t_broadcast_optimizer_state"]["lrs"] == [0.01, 0.01]


def test_sync_batch_norm_is_batch_norm_on_the_whole_batch(worlds):
    full = R._data(0, 40, (8, 3, 4, 4)).requires_grad_(True)
    bn = torch.nn.BatchNorm2d(3)
    bn.train()
    out = bn(full)
    (out * R._data(0, 41, (4, 3, 4, 4)).repeat(2, 1, 1, 1)).sum().backward()
    for rank in range(2):
        res = worlds["port"][rank]["t_sync_batch_norm"]
        rows = slice(rank * 4, (rank + 1) * 4)
        np.testing.assert_allclose(res["out"], out[rows].detach().numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(res["dx"], full.grad[rows].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(res["running_mean"],
                                   bn.running_mean.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# The single-process tier (twins of test_torch_api.TestSingleProcess).
# ---------------------------------------------------------------------------


@pytest.fixture()
def hvd():
    import horovod_tpu_torch.torch as hvd

    hvd.init(0, 1, device="cpu")
    yield hvd
    hvd.shutdown()


class TestSingleProcess:
    def test_rank_size(self, hvd, monkeypatch):
        monkeypatch.delenv("HVT_LOCAL_RANK", raising=False)
        monkeypatch.delenv("LOCAL_RANK", raising=False)
        assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (0, 1, 0)
        assert hvd.is_initialized()
        monkeypatch.setenv("HVT_LOCAL_RANK", "3")
        assert hvd.local_rank() == 3

    def test_allreduce_and_inplace(self, hvd):
        t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        assert torch.equal(hvd.allreduce(t, name="t0"), t)
        u = torch.full((6,), 3.0)
        ptr = u.data_ptr()
        ret = hvd.allreduce_(u, name="direct.ar", op=hvd.Sum)
        assert ret is u and u.data_ptr() == ptr
        assert torch.equal(u, torch.full((6,), 3.0))
        ts = [torch.ones(3), torch.full((2, 2), 2.0)]
        outs = hvd.grouped_allreduce_(ts, name="direct.grp", op=hvd.Sum)
        assert all(o is x for o, x in zip(outs, ts))

    def test_async_poll_and_collectives(self, hvd):
        h = hvd.allreduce_async(torch.ones(8), name="t2")
        while not hvd.poll(h):
            pass
        assert torch.equal(hvd.synchronize(h), torch.ones(8))
        t = torch.arange(4).reshape(2, 2)
        assert torch.equal(hvd.allgather(t, name="g0"), t)
        assert torch.equal(hvd.broadcast(torch.full((3,), 7.0), 0, name="b"),
                           torch.full((3,), 7.0))
        out, splits = hvd.alltoall(torch.arange(4.0), name="a")
        assert torch.equal(out, torch.arange(4.0)) and splits.tolist() == [4]
        outs = hvd.grouped_allreduce([torch.ones(3), torch.full((2,), 2.0)],
                                     name="grp")
        assert torch.equal(outs[1], torch.full((2,), 2.0))
        assert hvd.allreduce(torch.tensor(2.0), name="sc").shape == ()
        bf = hvd.allreduce(torch.ones(5, dtype=torch.bfloat16), name="bf")
        assert bf.dtype == torch.bfloat16
        assert hvd.join() == 0
        hvd.barrier()

    def test_objects(self, hvd):
        obj = {"a": 1, "b": [1, 2, 3]}
        assert hvd.broadcast_object(obj) == obj
        assert hvd.allgather_object({"x": 2}) == [{"x": 2}]

    def test_optimizer_at_world_one_is_the_unwrapped_one(self, hvd):
        """The hooks and the runtime run at world 1 too: Average divides by
        1, so the wrapped SGD's step is the plain one's bit for bit."""
        from horovod_tpu_torch import native

        models = []
        for wrap in (False, True):
            torch.manual_seed(0)
            model = torch.nn.Linear(4, 2)
            opt = torch.optim.SGD(model.parameters(), lr=0.1)
            if wrap:
                opt = hvd.DistributedOptimizer(
                    opt, named_parameters=model.named_parameters())
            c0 = native.metrics_counters()
            for i in range(3):
                opt.zero_grad()
                model(R._data(0, 70 + i, (8, 4))).pow(2).mean().backward()
                opt.step()
            models.append(model)
        c1 = native.metrics_counters()
        for a, b in zip(models[0].parameters(), models[1].parameters()):
            assert torch.equal(a, b)
        assert c1["cache_misses"] - c0["cache_misses"] == 2
        assert c1["cache_hits"] - c0["cache_hits"] == 4

    def test_optimizer_unused_parameter(self, hvd):
        class M(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.used = torch.nn.Linear(4, 2)
                self.unused = torch.nn.Linear(4, 2)

            def forward(self, x):
                return self.used(x)

        model = M()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        model(torch.randn(8, 4)).pow(2).mean().backward()
        assert model.unused.weight.grad is None
        opt.step()  # the sweep allreduces zeros for the missing gradients
        assert torch.all(model.unused.weight.grad == 0)

    def test_optimizer_duplicate_names_rejected(self, hvd):
        model = torch.nn.Linear(4, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        with pytest.raises(ValueError, match="unique"):
            hvd.DistributedOptimizer(
                opt, named_parameters=[("same", p)
                                       for p in model.parameters()])

    def test_skip_synchronize(self, hvd):
        model = torch.nn.Linear(3, 1)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        model(torch.randn(4, 3)).sum().backward()
        opt.synchronize()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 0.5)
        with opt.skip_synchronize():
            opt.step()

    def test_compression(self, hvd):
        from horovod_tpu_torch.torch import Compression

        t = torch.tensor([1.0, 2.5])
        for c, dt in ((Compression.fp16, torch.float16),
                      (Compression.bf16, torch.bfloat16)):
            wire, ctx = c.compress(t)
            assert wire.dtype == dt and c.decompress(wire, ctx).dtype == \
                torch.float32
        assert Compression.none.compress(t)[0] is t

    def test_sync_batch_norm_matches_local_bn_single(self, hvd):
        torch.manual_seed(0)
        x = torch.randn(4, 3, 5, 5)
        sbn = hvd.SyncBatchNorm(3)
        bn = torch.nn.BatchNorm2d(3)
        bn.load_state_dict(sbn.state_dict())
        sbn.train(), bn.train()
        assert torch.allclose(sbn(x), bn(x), atol=1e-5)

    def test_elastic_sampler(self, hvd):
        from horovod_tpu_torch.torch.elastic import ElasticSampler

        data = list(range(10))
        s = ElasticSampler(data, shuffle=False)
        first = list(s)
        assert sorted(first) == data
        s.record_indices(first[:4])
        s.reset()
        assert sorted(s) == sorted(set(data) - set(first[:4]))

    def test_elastic_sampler_pads_short_tail(self, hvd, monkeypatch):
        from horovod_tpu_torch.torch import elastic as el

        s = el.ElasticSampler(list(range(4)), shuffle=False)
        s.record_indices([0, 1, 2])
        monkeypatch.setattr(el.mpi_ops, "size", lambda: 4)
        monkeypatch.setattr(el.mpi_ops, "rank", lambda: 0)
        s.reset()
        assert s.total_size == 4 and len(s.remaining_indices) == 4
        assert all(i == 3 for i in s.remaining_indices)

    def test_timeline(self, hvd, tmp_path):
        import json

        path = tmp_path / "tl.json"
        hvd.start_timeline(str(path))
        hvd.allreduce(torch.ones(2), name="tl")
        hvd.stop_timeline()
        names = {e.get("name") for e in json.loads(path.read_text())}
        assert "ALLREDUCE" in names
