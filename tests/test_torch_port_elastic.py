"""The port's elastic state and run loop (horovod_tpu_torch.elastic), twins
of tests/test_elastic.py, plus what the port adds on its own state:
``TrainState`` saves ZeRO-1 state in its canonical form and restores it
repacked for another world (4 -> 2 on gloo, spawned), ``sync`` on a gloo
world of 2, a guard escalation recovered by ``run``, and the worker entry
points: no-ops outside an elastic launch, live against a rendezvous
server inside one.

The JAX package's elastic objects behave alike on the same script: the
ObjectState and run-loop twins run both packages' and compare.
"""

import numpy as np
import pytest
import torch

from horovod_tpu import elastic as jelastic
from horovod_tpu.exceptions import HorovodInternalError as JInternal
from horovod_tpu.exceptions import HostsUpdatedInterrupt as JHosts
from horovod_tpu_torch import chaos, context, elastic
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.elastic import worker
from horovod_tpu_torch.exceptions import (
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.guard import GuardConfig
from horovod_tpu_torch.parallel import dp

import torch_fault_ranks as ranks

BOTH = [(elastic, HorovodInternalError, HostsUpdatedInterrupt),
        (jelastic, JInternal, JHosts)]
IDS = ["port", "reference"]


@pytest.fixture(autouse=True)
def _clean():
    chaos._reset_for_tests()
    yield
    chaos._reset_for_tests()


@pytest.fixture
def world8_if_reference(request):
    """The reference's elastic objects need an initialized world."""
    pkg = request.node.callspec.params["pkg"][0]
    if pkg is jelastic:
        import horovod_tpu as hvd
        from conftest import cpu_devices

        hvd.init(devices=cpu_devices(8))
        yield
        hvd.shutdown()
    else:
        yield


@pytest.mark.parametrize("pkg", BOTH, ids=IDS)
def test_object_state_save_restore(pkg, world8_if_reference):
    el = pkg[0]
    state = el.ObjectState(epoch=3, lr=0.1)
    state.epoch = 7
    state.restore()
    assert state.epoch == 3
    state.epoch = 9
    state.save()
    state.restore()
    assert state.epoch == 9


@pytest.mark.parametrize("pkg", BOTH, ids=IDS)
def test_object_state_sync_single_process(pkg, world8_if_reference):
    state = pkg[0].ObjectState(epoch=5, extras={"a": [1, 2]})
    state.sync()
    assert state.epoch == 5
    assert state.extras == {"a": [1, 2]}


def test_train_state_save_restore():
    params = {"w": torch.ones(3, requires_grad=True)}
    state = elastic.TrainState(params=params, opt_state=None, epoch=0)
    with torch.no_grad():
        params["w"].zero_()
    state.restore()
    torch.testing.assert_close(state.params["w"].detach(), torch.ones(3))
    # Written back into the live tensor, which still requires grad.
    assert state.params["w"] is params["w"] and params["w"].requires_grad


def test_train_state_replaces_a_reshaped_attribute():
    state = elastic.TrainState(params={"w": torch.ones(3)}, opt_state=None)
    state.params = {"w": torch.zeros(5)}
    state.restore()
    assert state.params["w"].shape == (3,)


@pytest.mark.parametrize("pkg", BOTH, ids=IDS)
def test_elastic_run_restores_on_internal_error(pkg, world8_if_reference):
    el, internal, _ = pkg
    state = el.ObjectState(attempts=0)
    calls = {"n": 0}

    @el.run
    def train(st):
        calls["n"] += 1
        st.attempts += 1
        if calls["n"] < 3:
            st.commit()
            raise internal("collective failed")
        return st.attempts

    # Each failure restores the last committed value then retries.
    result = train(state)
    assert calls["n"] == 3
    assert result == state.attempts == 3


@pytest.mark.parametrize("pkg", BOTH, ids=IDS)
def test_elastic_run_hosts_updated_keeps_state(pkg, world8_if_reference):
    el, _, hosts = pkg
    state = el.ObjectState(progress=0)
    calls = {"n": 0}

    @el.run
    def train(st):
        calls["n"] += 1
        st.progress += 10
        if calls["n"] == 1:
            raise hosts(skip_sync=True)
        return st.progress

    # HostsUpdated keeps (does not restore) current state.
    assert train(state) == 20


@pytest.mark.parametrize("pkg", BOTH, ids=IDS)
def test_elastic_run_reset_limit(pkg, world8_if_reference):
    el, internal, _ = pkg
    state = el.ObjectState(x=0)

    @el.run
    def train(st):
        raise internal("always fails")

    with pytest.raises(RuntimeError, match="reset limit"):
        train(state, reset_limit=2)


@pytest.mark.parametrize("pkg", BOTH, ids=IDS)
def test_commit_raises_on_host_update(pkg, world8_if_reference):
    el, _, hosts = pkg
    state = el.ObjectState(x=1)
    state.on_hosts_updated(timestamp=123.0, update_res=None)
    with pytest.raises(hosts):
        state.commit()
    state.commit()  # the same timestamp is old news now


def test_reset_callbacks_run_on_reset():
    state = elastic.ObjectState(x=1)
    seen = []
    state.register_reset_callbacks([lambda: seen.append(1)])

    @elastic.run
    def train(st):
        if not seen:
            raise HorovodInternalError("once")
        return "done"

    assert train(state) == "done" and seen == [1]


def test_worker_entry_points_are_noops_outside_a_launch(monkeypatch):
    """Outside a launch the entry points do nothing; inside one (a live
    RendezvousServer on port 0) ``publish_clean_exit`` writes
    ``exit/<host>`` and a state registers with the notification
    manager's watcher."""
    from horovod_tpu_torch.runner.http_server import RendezvousServer

    monkeypatch.delenv("HVDTPU_ELASTIC", raising=False)
    assert not worker.in_elastic_world()
    worker.publish_clean_exit()
    assert worker.notification_manager.init() is False
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    manager = worker.WorkerNotificationManager()
    monkeypatch.setattr(worker, "notification_manager", manager)
    monkeypatch.setattr(elastic.state, "notification_manager", manager)
    try:
        monkeypatch.setenv("HVDTPU_ELASTIC", "1")
        monkeypatch.setenv("HVDTPU_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HVDTPU_RENDEZVOUS_PORT", str(port))
        monkeypatch.setenv("HVDTPU_HOST_ID", "hostA")
        assert worker.in_elastic_world()
        worker.publish_clean_exit()
        assert server.scope_items("exit") == {"hostA": b"0"}
        state = elastic.ObjectState(x=1)
        assert state in set(manager._listeners)
        assert manager._thread is not None and manager._thread.daemon
    finally:
        manager.stop()
        server.stop()


def test_train_state_snapshots_zero1_state_canonical():
    step, opt = ranks._zero1_step()
    ts = dp.init_state({k: torch.from_numpy(v)
                        for k, v in ranks.elastic_params().items()}, opt)
    ts, _ = step(ts, torch.ones(2, 4))
    est = elastic.TrainState(params=ts.params, opt_state=ts.opt_state,
                             step=ts.step)
    assert isinstance(est._saved_state["opt_state"], topt.CanonicalOptState)
    want = [b.clone() for b in est.opt_state.inner.mu.buffers]
    ts, _ = step(ts, torch.ones(2, 4) * 3)  # uncommitted
    est.opt_state = ts.opt_state
    est.restore()
    assert isinstance(est.opt_state, topt.ShardedOptState)
    for a, b in zip(want, est.opt_state.inner.mu.buffers):
        assert torch.equal(a, b)


def test_guard_escalation_restores_the_last_commit():
    """max_skips NaN steps escalate out of the guarded step; the elastic
    loop restores the commit before the storm and finishes, ending where a
    clean run over the same batches ends, bit for bit."""
    batches = ranks.regression_batches(8)

    def run(storm):
        step, opt = dp.make_train_step(
            ranks.regression_loss, topt.fused_adamw(0.05), sharded=True,
            fused_update=True, guard=GuardConfig(max_skips=2, audit_every=0),
            device="cpu")
        ts = dp.init_state({k: torch.from_numpy(v) for k, v in
                            ranks.regression_params().items()}, opt,
                           guard=True)
        if storm:
            chaos.plan("grad.nan:nan@step=4;n=2", seed=1)
        est = elastic.TrainState(params=ts.params, opt_state=ts.opt_state,
                                 step=ts.step, guard=ts.guard)
        attempts = []

        @elastic.run
        def train(st):
            while int(st.step) < len(batches):
                x, y = batches[int(st.step)]
                cur = dp.TrainState(st.params, st.opt_state, st.step,
                                    None, st.guard)
                new, _ = step(cur, (torch.from_numpy(x),
                                    torch.from_numpy(y)))
                attempts.append(int(new.step))
                st.opt_state, st.step, st.guard = (new.opt_state, new.step,
                                                   new.guard)
                if int(new.guard.consecutive) == 0:
                    st.commit()
            return st

        out = train(est)
        chaos.clear()
        return out, attempts, step.guard_runtime

    clean, clean_attempts, _ = run(False)
    storm, storm_attempts, rt = run(True)
    assert rt.escalations == 1
    assert storm_attempts.count(3) == 3  # two skips at step 4, then restore
    for k in clean.params:
        assert torch.equal(clean.params[k], storm.params[k])
    assert int(storm.step) == int(clean.step) == len(batches)


def test_zero1_state_restores_at_another_world_size(tmp_path):
    store2 = str(tmp_path / "store2")
    out = context.spawn_gloo(4, ranks.elastic_resize, store2)
    assert out[2] == {"left": True} and out[3] == {"left": True}
    for r in out[:2]:
        assert r["world"] == 2
        assert r["canon_equal"], "canonical state changed across 4 -> 2"
        assert r["params_equal"] and r["params_are_live"]
        assert r["stepped"] == 3 and r["loss_finite"]


def test_sync_takes_rank_0s_state_on_a_world_of_2():
    out = context.spawn_gloo(2, ranks.elastic_sync)
    for k in out[0]["params"]:
        np.testing.assert_array_equal(out[0]["params"][k],
                                      out[1]["params"][k])
    assert out[0]["epoch"] == out[1]["epoch"] == 10
    assert all(r["params_are_live"] for r in out)
    for a, b in zip(out[0]["canon"], out[1]["canon"]):
        np.testing.assert_array_equal(a, b)
