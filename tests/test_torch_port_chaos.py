"""The port's chaos plane (horovod_tpu_torch.chaos) held against the JAX
package's: tests/test_chaos.py's TestSchedule, TestArming,
TestWorkerStepSite and TestCkptSite have twins here, plus the serving
sites of tests/test_decode.py::TestDecodeChaos and ``serve.request``.

The schedule is held against the reference's parser on the same specs:
the same rules, the same fires at the same occurrences, the same seeded
streams. The sites the port does not have yet (``eager.dispatch``,
``publish.delta``) parse and are reached by nothing. The launcher's half
(TestRetry, TestKVSite, TestBlacklistCooldown, TestHeartbeat and the
worker-fault soak scenarios) came with the elastic launcher, and the
``serve.dispatch`` twins of tests/test_serve.py::TestServeChaosSites
with it.
"""

import os
import time

import numpy as np
import pytest
import torch

from horovod_tpu import chaos as jchaos
from horovod_tpu.chaos.schedule import parse as jparse
from horovod_tpu_torch import chaos
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.chaos.schedule import ChaosSpecError, SITES, parse


@pytest.fixture(autouse=True)
def _disarm():
    """Every test starts and ends with nothing armed (and the env latch
    reset, so a monkeypatched HVDTPU_CHAOS is honoured)."""
    chaos._reset_for_tests()
    yield
    chaos._reset_for_tests()


# ---- schedule grammar ---------------------------------------------------


FULL = ("kv.request:drop@after=1;n=6, worker.step:crash@step=4;host=h2,"
        "worker.step:slow=0.25@rank=1, ckpt.write:corrupt@step=5;spawn=0,"
        "eager.dispatch:delay=0.2@p=0.1;every=2")


class TestSchedule:
    def test_catalog_is_the_reference_catalog(self):
        assert SITES == jchaos.SITES

    def test_parse_full_grammar(self):
        p = parse(FULL, seed=3)
        assert len(p.rules) == 5
        kinds = sorted(r.kind for r in p.rules)
        assert kinds == ["corrupt", "crash", "delay", "drop", "slow"]
        j = jparse(FULL, seed=3)
        assert [(r.site, r.kind, r.value, r.conds) for r in p.rules] == [
            (r.site, r.kind, r.value, r.conds) for r in j.rules]

    @pytest.mark.parametrize(
        "bad",
        [
            "nosuchsite:drop",  # unknown site
            "kv.request:corrupt",  # action illegal for site
            "kv.request",  # no action
            "worker.step:slow",  # value-carrying action without value
            "kv.request:drop@p=1.5",  # probability out of range
            "kv.request:drop@bogus=1",  # unknown condition
            "kv.request:drop@step",  # condition without a value
            "",  # empty schedule
        ],
    )
    def test_parse_rejects(self, bad):
        with pytest.raises(ChaosSpecError):
            parse(bad)
        with pytest.raises(jchaos.ChaosSpecError):
            jparse(bad)

    def test_step_and_n_conditions(self):
        p = parse("eager.dispatch:timeout@step=3")
        fires = [p.match("eager.dispatch", {}) is not None for _ in range(5)]
        assert fires == [False, False, True, False, False]
        p = parse("eager.dispatch:timeout@after=2;n=2")
        fires = [p.match("eager.dispatch", {}) is not None for _ in range(5)]
        assert fires == [False, True, True, False, False]

    def test_every_condition_uses_ctx_step(self):
        p = parse("ckpt.write:corrupt@every=2")
        fires = [
            p.match("ckpt.write", {"step": s}) is not None
            for s in (1, 2, 3, 4, 7, 8)
        ]
        assert fires == [False, True, False, True, False, True]

    def test_identity_filters_do_not_consume_occurrences(self):
        p = parse("worker.step:crash@step=2;host=h1")
        assert p.match("worker.step", {"host": "h2"}) is None
        assert p.match("worker.step", {"host": "h2"}) is None
        assert p.match("worker.step", {"host": "h1"}) is None  # its step 1
        assert p.match("worker.step", {"host": "h1"}) is not None

    def test_probabilistic_rules_replay_with_seed(self):
        a = parse("eager.dispatch:delay=0.01@p=0.4", seed=11)
        b = parse("eager.dispatch:delay=0.01@p=0.4", seed=11)
        fa = [a.match("eager.dispatch", {}) is not None for _ in range(64)]
        fb = [b.match("eager.dispatch", {}) is not None for _ in range(64)]
        assert fa == fb
        assert any(fa) and not all(fa)

    @pytest.mark.parametrize("seed", [0, 11, 1234])
    def test_fires_and_streams_are_the_reference(self, seed):
        spec = ("eager.dispatch:delay=0.01@p=0.4,"
                "ckpt.write:corrupt@every=3;n=4,"
                "worker.step:slow=0.1@after=5;rank=1")
        p, j = parse(spec, seed=seed), jparse(spec, seed=seed)
        rs = np.random.RandomState(seed)
        for i in range(60):
            site = ("eager.dispatch", "ckpt.write", "worker.step")[i % 3]
            ctx = {"step": i, "rank": int(rs.randint(0, 2))}
            a, b = p.match(site, dict(ctx)), j.match(site, dict(ctx))
            assert (a is None) == (b is None), (i, site)
            if a is not None:
                assert (a.kind, a.value) == (b.kind, b.value)
                assert a.rng.random() == b.rng.random()

    def test_spawn_filter_reads_env(self, monkeypatch):
        monkeypatch.setenv("HVDTPU_SPAWN_ROUND", "1")
        chaos.plan("worker.step:crash@step=1;spawn=0")
        # crash would os._exit -- its NOT firing is the assertion.
        assert chaos.action("worker.step", step=1) is None
        monkeypatch.setenv("HVDTPU_SPAWN_ROUND", "0")
        act = chaos.action("worker.step", step=1)
        assert act is not None and act.kind == "crash"


# ---- arming & the disabled fast path ------------------------------------


class TestArming:
    def test_disabled_by_default(self, monkeypatch):
        monkeypatch.delenv("HVDTPU_CHAOS", raising=False)
        chaos._reset_for_tests()
        assert not chaos.enabled()
        assert chaos.act("kv.request") is None

    def test_env_arming(self, monkeypatch):
        monkeypatch.setenv("HVDTPU_CHAOS", "eager.dispatch:timeout@step=1")
        chaos._reset_for_tests()
        assert chaos.enabled()
        act = chaos.action("eager.dispatch")
        assert act is not None and act.kind == "timeout"
        assert chaos.fired == {"eager.dispatch": 1}

    def test_env_seed_arms_the_streams(self, monkeypatch):
        monkeypatch.setenv("HVDTPU_CHAOS", "eager.dispatch:delay=0@p=0.5")
        monkeypatch.setenv("HVDTPU_CHAOS_SEED", "9")
        chaos._reset_for_tests()
        fires = [chaos.action("eager.dispatch") is not None
                 for _ in range(32)]
        ref = jparse("eager.dispatch:delay=0@p=0.5", seed=9)
        assert fires == [ref.match("eager.dispatch", {}) is not None
                         for _ in range(32)]

    def test_env_arming_rejects_typos(self, monkeypatch):
        monkeypatch.setenv("HVDTPU_CHAOS", "kv.request:dorp")
        chaos._reset_for_tests()
        with pytest.raises(ChaosSpecError):
            chaos.enabled()

    def test_clear_disarms(self):
        chaos.plan("eager.dispatch:timeout")
        assert chaos.enabled()
        chaos.clear()
        assert not chaos.enabled()
        assert chaos.act("eager.dispatch") is None

    def test_unknown_site_raises_at_the_site(self):
        chaos.plan("eager.dispatch:timeout")
        with pytest.raises(ChaosSpecError):
            chaos.action("no.such.site")

    def test_generic_delay_runs_inline(self):
        chaos.plan("serve.request:delay=0.05")
        t0 = time.monotonic()
        assert chaos.act("serve.request") is None
        assert time.monotonic() - t0 >= 0.05

    def test_sites_are_noops_when_unarmed(self):
        from horovod_tpu_torch.serve.dispatcher import Dispatcher

        d = Dispatcher(batch_size=2, batch_timeout_ms=1.0)
        fut = d.submit(np.ones(3, np.float32))
        assert not fut.done() and d.n_submitted == 1
        d.close()


# ---- worker.step site ---------------------------------------------------


class TestWorkerStepSite:
    def test_slow_commit_straggles(self):
        from horovod_tpu_torch.elastic.state import ObjectState

        st = ObjectState(x=1)
        chaos.plan("worker.step:slow=0.15@step=2")
        t0 = time.monotonic()
        st.commit()  # step 1: no fault
        fast = time.monotonic() - t0
        t0 = time.monotonic()
        st.commit()  # step 2: injected straggle
        slow = time.monotonic() - t0
        assert slow >= 0.15 and slow > fast
        assert chaos.fired == {"worker.step": 1}


# ---- ckpt.write site + restore fallback ---------------------------------


class TestCkptSite:
    def _state(self, i):
        return {"w": torch.full((64,), float(i)), "step": np.int64(i)}

    def test_corrupt_write_detected_and_walked_back(self, tmp_path):
        d = str(tmp_path)
        ckpt.save_checkpoint(d, self._state(1), step=1)
        chaos.plan("ckpt.write:corrupt@step=2")
        ckpt.save_checkpoint(d, self._state(2), step=2)
        chaos.clear()
        restored = ckpt.restore_checkpoint(d, self._state(0))
        assert int(restored["step"]) == 1
        assert any(".corrupt" in n for n in os.listdir(d))

    def test_truncate_write_detected(self, tmp_path):
        d = str(tmp_path)
        ckpt.save_checkpoint(d, self._state(3), step=3)
        chaos.plan("ckpt.write:truncate@step=4")
        ckpt.save_checkpoint(d, self._state(4), step=4)
        chaos.clear()
        assert ckpt.verify_step_dir(os.path.join(d, "step_4"))
        assert not ckpt.verify_step_dir(os.path.join(d, "step_3"))

    def test_other_steps_write_clean(self, tmp_path):
        d = str(tmp_path)
        chaos.plan("ckpt.write:corrupt@step=9")
        for s in (1, 2):
            ckpt.save_checkpoint(d, self._state(s), step=s)
            assert not ckpt.verify_step_dir(os.path.join(d, f"step_{s}"))
        assert chaos.fired == {}


# ---- serving sites ------------------------------------------------------


class TestServeRequestSite:
    def test_drop_rejects_at_the_door(self):
        from horovod_tpu_torch.serve.dispatcher import (
            Dispatcher,
            ServeRequestDropped,
        )

        d = Dispatcher(batch_size=2, batch_timeout_ms=1.0)
        chaos.plan("serve.request:drop@step=2")
        d.submit(np.ones(3, np.float32))
        with pytest.raises(ServeRequestDropped, match="chaos"):
            d.submit(np.ones(3, np.float32))
        d.submit(np.ones(3, np.float32))
        assert d.n_submitted == 2
        d.close()

    def test_pool_answers_every_request_that_got_in(self):
        from horovod_tpu_torch.serve import ServePool
        from horovod_tpu_torch.serve.dispatcher import ServeRequestDropped

        chaos.plan("serve.request:drop@every=3")
        pool = ServePool(lambda p, b: b * p["w"], {"w": torch.full((1,), 2.0)},
                         device="cpu", batch_size=4).start()
        try:
            futs, dropped = [], 0
            for i in range(9):
                try:
                    futs.append((i, pool.submit(np.full(3, i, np.float32))))
                except ServeRequestDropped:
                    dropped += 1
            for i, f in futs:
                np.testing.assert_array_equal(np.asarray(f.result(timeout=30)),
                                              np.full(3, 2.0 * i))
        finally:
            pool.stop()
        assert dropped == 3 and len(futs) == 6


class TestServeDispatchSite:
    """Twins of tests/test_serve.py::TestServeChaosSites' dispatch tests:
    the pool's workers reach ``serve.dispatch`` before every leased batch
    (an ``error`` fails the batch back to the queue, a ``timeout``
    abandons the lease for the reaper) and every request is answered."""

    @staticmethod
    def _pool(request_timeout_secs):
        from horovod_tpu_torch.serve import ServePool

        return ServePool(lambda p, b: b * p["scale"],
                         {"scale": torch.tensor(2.0)}, device="cpu",
                         workers=2, batch_size=4, batch_timeout_ms=2.0,
                         request_timeout_secs=request_timeout_secs).start()

    def test_dispatch_error_requeues_to_survivor(self):
        chaos.plan("serve.dispatch:error@n=1")
        pool = self._pool(5.0)
        try:
            futs = [pool.submit(torch.full((2,), float(i))) for i in range(6)]
            for i, f in enumerate(futs):
                np.testing.assert_allclose(
                    np.asarray(f.result(timeout=10.0)), 2.0 * i)
            assert pool.dispatcher.n_requeued > 0
        finally:
            pool.stop()
        assert chaos.fired.get("serve.dispatch") == 1

    def test_dispatch_timeout_reaped_and_answered(self):
        chaos.plan("serve.dispatch:timeout@n=1")
        pool = self._pool(0.3)
        try:
            futs = [pool.submit(torch.full((2,), float(i))) for i in range(4)]
            for i, f in enumerate(futs):
                np.testing.assert_allclose(
                    np.asarray(f.result(timeout=10.0)), 2.0 * i)
            assert pool.dispatcher.n_requeued > 0
        finally:
            pool.stop()
        assert chaos.fired.get("serve.dispatch") == 1


def _decode_engine(**kw):
    from horovod_tpu_torch.serve import CacheLM, CacheLMConfig, DecodeEngine

    cfg = CacheLMConfig(vocab=32, n_layers=2, n_heads=2, head_dim=8,
                        max_positions=256)
    model = CacheLM(cfg, block_size=8)
    base = dict(workers=1, rows=2, kv_blocks=32, kv_block_size=8,
                max_seq_len=64, device="cpu")
    base.update(kw)
    return DecodeEngine(model, model.init_params(0, device="cpu"), **base)


class TestDecodeChaos:
    def test_site_in_catalog(self):
        assert SITES["serve.decode"] == ("crash", "delay")

    def test_crash_kills_worker_streams_resume(self):
        clean = _decode_engine(workers=2).start()
        try:
            want = [clean.submit([1 + i, 2], 16).result(timeout=60)
                    for i in range(4)]
        finally:
            clean.stop()
        chaos.plan("serve.decode:crash@step=3;n=1")
        eng = _decode_engine(workers=2).start()
        try:
            futs = [eng.submit([1 + i, 2], 16) for i in range(4)]
            outs = [f.result(timeout=60) for f in futs]
            assert all(len(o) == 16 for o in outs)
            assert eng.n_requeued > 0
            assert eng.n_workers == 1  # the victim is gone
        finally:
            eng.stop()
        assert [list(o) for o in outs] == [list(o) for o in want]
        assert chaos.fired == {"serve.decode": 1}

    def test_delay_stalls_but_completes(self):
        chaos.plan("serve.decode:delay=0.005@every=2")
        eng = _decode_engine().start()
        try:
            assert len(eng.submit([3, 3], 8).result(timeout=30)) == 8
        finally:
            eng.stop()
        assert chaos.fired["serve.decode"] >= 3


# ---- the launcher's sites (A13b): retry, kv.request, cooldown, leases -----


class TestRetry:
    def test_retry_call_recovers(self):
        from horovod_tpu_torch.utils.retry import retry_call

        calls = []

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert retry_call(fn, attempts=4, base=0.01) == "ok"
        assert len(calls) == 3

    def test_retry_call_exhausts(self):
        from horovod_tpu_torch.utils.retry import retry_call

        def fn():
            raise OSError("always")

        with pytest.raises(OSError):
            retry_call(fn, attempts=3, base=0.01)

    def test_should_retry_filter_raises_immediately(self):
        from horovod_tpu_torch.utils.retry import retry_call

        calls = []

        def fn():
            calls.append(1)
            raise OSError("fatal")

        with pytest.raises(OSError):
            retry_call(fn, attempts=5, base=0.01,
                       should_retry=lambda e: False)
        assert len(calls) == 1

    def test_backoff_grows_and_caps(self):
        from horovod_tpu_torch.utils.retry import Backoff

        b = Backoff(base=0.1, cap=0.5, factor=2.0, jitter=0.0)
        assert [b.next_delay() for _ in range(4)] == [0.1, 0.2, 0.4, 0.5]
        b.reset()
        assert b.next_delay() == 0.1

    def test_backoff_jitter_bounded(self):
        import random

        from horovod_tpu_torch.utils.retry import Backoff

        b = Backoff(base=1.0, cap=1.0, jitter=0.5, rng=random.Random(0))
        for _ in range(32):
            assert 0.5 <= b.next_delay() <= 1.0


class TestKVSite:
    def _server(self, secret=None):
        from horovod_tpu_torch.runner.http_server import (
            RendezvousClient,
            RendezvousServer,
        )

        server = RendezvousServer("127.0.0.1", secret=secret)
        port = server.start()
        return server, RendezvousClient("127.0.0.1", port, timeout=5,
                                        secret=secret)

    def test_drop_recovered_by_retry(self):
        server, client = self._server()
        try:
            chaos.plan("kv.request:drop@n=2")
            client.put("sc", "k", b"v")
            assert client.get("sc", "k") == b"v"
            assert chaos.fired["kv.request"] == 2
            assert client.retries_seen == 2
        finally:
            server.stop()

    def test_injected_5xx_recovered_by_retry(self):
        server, client = self._server()
        try:
            chaos.plan("kv.request:error@n=2")
            client.put("sc", "k", b"v")
            assert client.get("sc", "k") == b"v"
        finally:
            server.stop()

    def test_outage_beyond_retries_raises(self):
        import urllib.error

        server, client = self._server()
        try:
            chaos.plan("kv.request:drop@n=50")
            with pytest.raises(urllib.error.URLError):
                client.put("sc", "k", b"v")
        finally:
            server.stop()

    def test_404_is_an_answer_not_a_retry(self):
        server, client = self._server()
        try:
            t0 = time.monotonic()
            assert client.get("sc", "missing") is None
            assert time.monotonic() - t0 < 0.5
        finally:
            server.stop()

    def test_retried_put_not_rejected_as_replay(self):
        server, client = self._server(secret="s7")
        try:
            chaos.plan("kv.request:drop@n=2")
            client.put("sc", "k", b"v")
            assert client.get("sc", "k") == b"v"
        finally:
            server.stop()


class TestBlacklistCooldown:
    def _mgr(self, cooldown):
        from horovod_tpu_torch.runner.elastic_driver import (
            FixedHosts,
            HostManager,
        )

        return HostManager(FixedHosts({"a": 1, "b": 1}), cooldown=cooldown)

    def test_permanent_without_cooldown(self):
        mgr = self._mgr(0.0)
        mgr.update_available_hosts()
        mgr.blacklist("a")
        mgr.update_available_hosts()
        assert mgr.current_hosts == {"b": 1}
        assert mgr.is_blacklisted("a")

    def test_cooldown_readmits_on_probation(self):
        mgr = self._mgr(0.2)
        mgr.update_available_hosts()
        mgr.blacklist("a")
        mgr.update_available_hosts()
        assert mgr.current_hosts == {"b": 1}
        assert mgr.is_blacklisted("a")
        time.sleep(0.25)
        assert not mgr.is_blacklisted("a")
        assert mgr.update_available_hosts()
        assert mgr.current_hosts == {"a": 1, "b": 1}
        assert mgr.host_health() == {"a": 1}
        assert mgr.readmissions == 1

    def test_repeat_offender_cooldown_doubles(self):
        mgr = self._mgr(0.2)
        mgr.update_available_hosts()
        mgr.blacklist("a")
        time.sleep(0.25)
        assert not mgr.is_blacklisted("a")
        mgr.blacklist("a")
        time.sleep(0.25)
        assert mgr.is_blacklisted("a")
        time.sleep(0.2)
        assert not mgr.is_blacklisted("a")
        assert mgr.host_health() == {"a": 2}

    def test_env_knob_default(self, monkeypatch):
        from horovod_tpu_torch.runner.elastic_driver import (
            FixedHosts,
            HostManager,
        )

        monkeypatch.setenv("HVDTPU_BLACKLIST_COOLDOWN", "0.2")
        mgr = HostManager(FixedHosts({"a": 1}))
        mgr.update_available_hosts()
        mgr.blacklist("a")
        assert mgr.is_blacklisted("a")
        time.sleep(0.25)
        assert not mgr.is_blacklisted("a")


class _FakeProc:
    def __init__(self):
        self.killed = False

    def kill(self, grace=5.0):
        self.killed = True


class TestHeartbeat:
    def test_worker_beats_and_pause_stops_them(self, monkeypatch):
        from horovod_tpu_torch.elastic import worker as ew
        from horovod_tpu_torch.runner.http_server import RendezvousServer

        server = RendezvousServer("127.0.0.1")
        port = server.start()
        hb = ew._Heartbeat()
        try:
            monkeypatch.setenv("HVDTPU_ELASTIC", "1")
            monkeypatch.setenv("HVDTPU_RENDEZVOUS_ADDR", "127.0.0.1")
            monkeypatch.setenv("HVDTPU_RENDEZVOUS_PORT", str(port))
            monkeypatch.setenv("HVDTPU_HEARTBEAT_SECS", "0.05")
            assert hb.start("hostX")
            deadline = time.time() + 5.0
            while time.time() < deadline:
                if server.scope_items("heartbeat").get("hostX"):
                    break
                time.sleep(0.02)
            first = float(server.scope_items("heartbeat")["hostX"])
            hb.pause()
            time.sleep(0.2)
            paused = float(server.scope_items("heartbeat")["hostX"])
            time.sleep(0.2)
            still = float(server.scope_items("heartbeat")["hostX"])
            assert first > 0 and paused == still and hb.beats > 0
        finally:
            hb.stop()
            server.stop()

    def test_heartbeat_disabled_by_knob(self, monkeypatch):
        from horovod_tpu_torch.elastic import worker as ew

        monkeypatch.setenv("HVDTPU_HEARTBEAT_SECS", "0")
        assert not ew._Heartbeat().start("hostY")

    def test_driver_lease_expiry_blacklists(self, monkeypatch):
        from horovod_tpu_torch.runner.elastic_driver import (
            ElasticDriver,
            ElasticJob,
            FixedHosts,
        )

        monkeypatch.setenv("HVDTPU_HEARTBEAT_TIMEOUT_SECS", "0.2")
        driver = ElasticDriver(FixedHosts({"a": 1, "b": 1}))
        job = ElasticJob(["true"], driver)
        assert job.server.start()
        a, b = _FakeProc(), _FakeProc()
        try:
            job._assignment = {"a": 0, "b": 1}
            job._procs = {"a": a, "b": b}
            job.server.put("heartbeat", "a", b"beat-from-skewed-clock")
            assert job._check_leases() is False
            time.sleep(0.25)
            assert job._check_leases() is True
            assert a.killed and not b.killed
            assert "a" not in job._procs and "b" in job._procs
            assert driver.host_manager.is_blacklisted("a")
            assert job.lease_expiries == 1
            job.server.put("heartbeat", "b", b"beat-1")
            assert job._check_leases() is False
            time.sleep(0.25)
            job.server.put("heartbeat", "b", b"beat-2")
            assert job._check_leases() is False
        finally:
            job.server.stop()

    def test_stale_beat_from_previous_incarnation_ignored(self, monkeypatch):
        from horovod_tpu_torch.runner.elastic_driver import (
            ElasticDriver,
            ElasticJob,
            FixedHosts,
        )

        monkeypatch.setenv("HVDTPU_HEARTBEAT_TIMEOUT_SECS", "0.2")
        job = ElasticJob(["true"], ElasticDriver(FixedHosts({"a": 1})))
        job.server.start()

        class NeverKill:
            def kill(self, grace=5.0):
                raise AssertionError("respawned worker must not be killed")

        try:
            job.server.put("heartbeat", "a", b"predecessor-beat")
            job._assignment = {"a": 0}
            job._procs = {"a": NeverKill()}
            job._hb_baseline = {"a": b"predecessor-beat"}
            time.sleep(0.25)
            assert job._check_leases() is False
            job.server.put("heartbeat", "a", b"fresh-beat")
            assert job._check_leases() is False
        finally:
            job.server.stop()


# ---- end to end: the worker-fault soak scenarios ---------------------------


@pytest.mark.parametrize("scenario",
                         ["crash", "hang", "kv_outage", "ckpt", "straggler"])
def test_worker_fault_scenario(scenario):
    """Twins of test_crash_recover_scenario_fast and of the worker-fault
    half of test_full_chaos_soak: each fault fires in a gloo world of
    loopback hosts under the port's elastic driver, and the job ends rc=0
    at the exact step count with the analytic final parameters."""
    from horovod_tpu_torch.tools import chaos_soak as soak

    res = soak.run_scenario(scenario, steps=5, timeout=90.0)
    assert soak.check_invariants(res, steps=5) == []
