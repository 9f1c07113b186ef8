"""The port's eager collectives (``horovod_tpu_torch.ops.eager``), stall
inspector (``utils/stall.py``) and metric names against the JAX package's.

At world 1, in this process, each eager op against
``horovod_tpu/ops/eager.py`` (values, dtypes, error messages), bit for
bit. At worlds 2 and 3 (gloo worlds of processes) against the JAX
package's own formulas on every rank's seeded inputs: sums in rank order
(bit for bit at 2, fp32 within 1e-6 relative at 3), integer Average as a
floor division (exact), Adasum through its ``_adasum_fold`` (bit for bit:
the same fp64 numpy fold). Then the twins of ``tests/test_utils.py:83-130``
(stall warning, shutdown, the watchdog firing and staying quiet) and the
``eager.*``, ``stall.*`` and ``native.*`` names against the JAX
package's.
"""

import logging
import time

import numpy as np
import pytest
import torch

import torch_eager_ranks as R
from horovod_tpu_torch import context
from horovod_tpu_torch.exceptions import HorovodTpuError
from horovod_tpu_torch.obs import registry as reg_mod
from horovod_tpu_torch.ops import eager
from horovod_tpu_torch.utils.stall import StallInspector


@pytest.fixture
def jeager():
    from horovod_tpu.ops import eager as je

    return je


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("op", ["Sum", "Average", "Min", "Max", "Product",
                                "Adasum"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16])
def test_allreduce_at_world_one_matches_the_reference(jeager, op, dtype):
    x = (np.random.default_rng(0).standard_normal((3, 4)) * 5).astype(dtype)
    got = eager.allreduce(torch.from_numpy(x.copy()), getattr(eager, op),
                          prescale=2.0, postscale=0.5)
    want = _np(jeager.allreduce(x, getattr(jeager, op), prescale=2.0,
                                postscale=0.5))
    assert got.dtype == torch.from_numpy(want.copy()).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_fp64_and_int64_keep_their_dtype():
    # The JAX package's results go through jnp (fp32 and int32 without
    # x64); the port keeps the input's dtype.
    for dt in (torch.float64, torch.int64):
        x = torch.arange(6, dtype=dt)
        got = eager.allreduce(x, eager.Average, postscale=3.0)
        assert got.dtype == dt and torch.equal(got, x * 3)


def test_the_other_ops_at_world_one_match_the_reference(jeager):
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_array_equal(
        eager.allgather(torch.from_numpy(x)).numpy(), _np(jeager.allgather(x)))
    assert eager.allgather(torch.tensor(3.0)).shape == (1,)
    np.testing.assert_array_equal(
        eager.broadcast(torch.from_numpy(x), 0).numpy(),
        _np(jeager.broadcast(x, 0)))
    out, sp = eager.alltoall(torch.from_numpy(x), [6])
    jout, jsp = jeager.alltoall(x, [6])
    np.testing.assert_array_equal(out.numpy(), _np(jout))
    assert sp.dtype == torch.int32 and sp.tolist() == _np(jsp).tolist()
    np.testing.assert_array_equal(
        eager.reducescatter(torch.from_numpy(x), eager.Average).numpy(),
        _np(jeager.reducescatter(x, jeager.Average)))
    eager.barrier()
    # Lists and numpy arrays are taken too, as the JAX package takes them.
    np.testing.assert_array_equal(eager.allreduce([1, 2], eager.Sum).numpy(),
                                  _np(jeager.allreduce([1, 2], jeager.Sum)))


def test_a_broadcast_root_outside_the_world_raises():
    with pytest.raises(HorovodTpuError,
                       match="root_rank 3 out of range for world size 1"):
        eager.broadcast(torch.ones(2), root_rank=3)


@pytest.mark.parametrize("call", ["alltoall_splits", "alltoall_sum"])
def test_errors_at_world_one_are_the_references(jeager, call):
    x = np.ones((4, 2), np.float32)
    calls = {
        "alltoall_splits": lambda m, t: m.alltoall(t, [2, 2]),
        "alltoall_sum": lambda m, t: m.alltoall(t, [3]),
    }
    with pytest.raises(Exception) as want:
        calls[call](jeager, x)
    with pytest.raises(HorovodTpuError) as got:
        calls[call](eager, torch.from_numpy(x))
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def eager_worlds(tmp_path_factory):
    return {n: R.shared(tmp_path_factory, f"eager_{n}",
                        lambda n=n: context.spawn_gloo(n, R.eager_world))
            for n in (2, 3)}


def _expected(n):
    from horovod_tpu.ops.eager import _adasum_fold

    ins = [R.eager_inputs(r) for r in range(n)]
    xs = np.stack([i["x"] for i in ins])
    xis = np.stack([i["xi"] for i in ins])
    want = {
        "sum": xs.sum(0), "avg": xs.sum(0) / n, "min": xs.min(0),
        "max": xs.max(0), "prod": xs.prod(0),
        # The reference casts every result back to the input's dtype.
        "avg_int": (xis.sum(0) // n).astype(np.int32),
        "sum_int": xis.sum(0).astype(np.int32),
        "scaled": (xs * 2.0).sum(0) * 0.5,
        "scaled_int": (xis * 0.5).sum(0).astype(np.int32),
        "adasum": _adasum_fold(np.stack([i["x64"] for i in ins])),
        "ag": np.concatenate([np.full((r + 1, 2), r) for r in range(n)]),
        "bc": np.full((3,), float(n - 1), np.float32),
    }
    rs = (np.stack([np.arange(n * 2) + r for r in range(n)]).sum(0) // n)
    return want, rs


@pytest.mark.parametrize("n", [2, 3])
def test_eager_world_matches_the_reference_formulas(eager_worlds, n):
    results = eager_worlds[n]
    want, rs = _expected(n)
    for rank, got in enumerate(results):
        for key, w in want.items():
            g = got[key]
            assert g.dtype == np.asarray(w).dtype or key == "adasum", (key,)
            if n == 2 or g.dtype.kind != "f" or key == "adasum":
                np.testing.assert_array_equal(g, w, err_msg=f"{n} {key}")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{n} {key}")
        np.testing.assert_array_equal(got["rs"], rs[2 * rank:2 * rank + 2])
        expect = sum(([i * 10 + rank] * (rank + 1) for i in range(n)), [])
        assert got["a2a"].tolist() == expect
        assert got["a2a_splits"].tolist() == [rank + 1] * n


# ---------------------------------------------------------------------------
# The stall inspector (twins of tests/test_utils.py:83-130).
# ---------------------------------------------------------------------------


def test_stall_inspector_warns(caplog):
    si = StallInspector(warning_time=0.0)
    si.record_uncached_tensor("grad/w", rank=0)
    si.record_uncached_tensor("grad/w", rank=2)
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch.stall"):
        stalled = si.check(world_size=4)
    assert stalled == ["grad/w"]
    assert "missing ranks: [1, 3]" in caplog.text
    si.remove_tensor("grad/w")
    assert si.check(world_size=4) == []


def test_stall_inspector_shutdown():
    si = StallInspector(warning_time=0.0, shutdown_time=1e-6)
    si.record_uncached_tensor("t", 0)
    time.sleep(0.01)
    with pytest.raises(RuntimeError, match="stalled"):
        si.check(world_size=2)


def test_eager_stall_watchdog_fires(monkeypatch, caplog):
    monkeypatch.setattr(eager, "_world", lambda: 2)
    monkeypatch.setattr(
        eager, "_stall", StallInspector(warning_time=0.05, local_view=True))
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch.stall"):
        with eager._observed("EAGER_ALLREDUCE"):
            time.sleep(0.2)
    assert "has not completed" in caplog.text
    assert "missing ranks" not in caplog.text


def test_eager_stall_watchdog_quiet_on_fast_ops(monkeypatch, caplog):
    monkeypatch.setattr(eager, "_world", lambda: 2)
    monkeypatch.setattr(
        eager, "_stall", StallInspector(warning_time=5.0, local_view=True))
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch.stall"):
        with eager._observed("EAGER_ALLREDUCE"):
            pass
    assert "has not completed" not in caplog.text


def test_stall_knobs_are_the_references(monkeypatch):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu.utils.stall import StallInspector as JStall

    monkeypatch.setenv("HVDTPU_STALL_CHECK_TIME_SECONDS", "7")
    monkeypatch.setenv("HVDTPU_STALL_SHUTDOWN_TIME_SECONDS", "9")
    a, b = StallInspector(), JStall()
    assert (a.warning_time, a.shutdown_time, a.enabled) == (
        b.warning_time, b.shutdown_time, b.enabled) == (7.0, 9.0, True)
    monkeypatch.setenv("HVDTPU_STALL_CHECK_DISABLE", "1")
    assert not StallInspector().enabled and not JStall().enabled
    from horovod_tpu_torch.utils import env

    assert (env.DEFAULT_STALL_WARNING_SECS, env.DEFAULT_CYCLE_TIME_MS,
            env.DEFAULT_CACHE_CAPACITY) == (
        jenv.DEFAULT_STALL_WARNING_SECS, jenv.DEFAULT_CYCLE_TIME_MS,
        jenv.DEFAULT_CACHE_CAPACITY)


# ---------------------------------------------------------------------------
# Metric names against the JAX package's.
# ---------------------------------------------------------------------------


@pytest.fixture
def planes():
    from horovod_tpu.obs import registry as jreg

    for reg in (reg_mod, jreg):
        reg._registry.reset()
        reg._enabled = None
        reg.enable()
    yield reg_mod.metrics(), jreg.metrics()
    for reg in (reg_mod, jreg):
        reg._registry.reset()
        reg._enabled = None


def _names(reg):
    snap = reg.snapshot()
    return {k for part in ("counters", "gauges", "histograms")
            for k in snap[part]}


def test_eager_and_stall_names_are_the_references(planes, jeager,
                                                  monkeypatch):
    from horovod_tpu.utils.stall import StallInspector as JStall

    port, ref = planes
    x = np.ones(4, np.float32)
    for kind in ("allreduce", "allgather", "broadcast", "reducescatter"):
        args = (eager.Sum,) if kind in ("allreduce",) else ()
        jargs = (jeager.Sum,) if kind in ("allreduce",) else ()
        getattr(eager, kind)(torch.from_numpy(x), *args)
        getattr(jeager, kind)(x, *jargs)
    eager.barrier()
    jeager.barrier()
    for si in (StallInspector(warning_time=0.0), JStall(warning_time=0.0)):
        si.record_uncached_tensor("grad/w", 0)
        si.check(world_size=2)
    assert _names(port) == _names(ref)
    assert "eager.EAGER_ALLREDUCE.ms" in _names(port)
    assert {"stall.pending", "stall.max_age_s",
            "stall.age_s.grad/w"} <= _names(port)


def test_eager_dispatch_chaos_site_fires():
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.exceptions import HorovodInternalError

    chaos._reset_for_tests()
    chaos.plan("eager.dispatch:timeout@n=1")
    try:
        with pytest.raises(HorovodInternalError, match="injected"):
            eager.allreduce(torch.ones(2), eager.Sum)
        assert torch.equal(eager.allreduce(torch.ones(2), eager.Sum),
                           torch.ones(2))
    finally:
        chaos._reset_for_tests()
