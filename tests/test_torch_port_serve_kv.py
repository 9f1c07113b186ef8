"""Serving over the rendezvous KV, the driver's guard reports and the
decode soak, held against the JAX package's: twins of
tests/test_serve.py::TestKVTransport and ::TestServeSoak,
tests/test_guard.py::TestDriverGuardReports and
tests/test_decode.py::TestDecodeSoak.

The KV transport's worker loop runs the inference function on the device
it is given (``device="cpu"`` here); the serve soak runs two serving
worker processes under the port's elastic driver on loopback hosts, one
hard-killed at its second leased batch (``serve.dispatch:crash``), and
answers every request; the decode soak kills a decode worker
mid-sequence. A message written by either package's coordinator is read
by the other's worker loop: the schema is shared.
"""

import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.serve import kv as jskv
from horovod_tpu_torch import chaos
from horovod_tpu_torch import checkpoint as ckptlib
from horovod_tpu_torch.elastic.scale import QueueDepthPolicy
from horovod_tpu_torch.runner.http_server import (
    RendezvousClient,
    RendezvousServer,
)
from horovod_tpu_torch.serve import ServePool
from horovod_tpu_torch.serve import kv as skv
from horovod_tpu_torch.serve.dispatcher import Dispatcher


@pytest.fixture(autouse=True)
def _disarm():
    chaos._reset_for_tests()
    yield
    chaos._reset_for_tests()


# ---- the KV transport --------------------------------------------------


class TestKVTransport:
    def _stack(self):
        server = RendezvousServer()
        server.start()
        return server, RendezvousClient("127.0.0.1", server.port)

    @pytest.mark.parametrize("coordinator", ["port", "reference"])
    def test_kv_serve_round_trip_and_timeout_recovery(self, coordinator):
        """hostB swallows its first batch (the hung-worker model); the
        lease times out, re-queues and hostA answers it. The coordinator
        of either package drives the port's worker loops."""
        server, client = self._stack()
        d = Dispatcher(batch_size=4, batch_timeout_ms=10.0,
                       request_timeout_secs=1.0, max_attempts=10)
        mod = skv if coordinator == "port" else jskv
        coord = mod.KVServeCoordinator(server, d, poll_secs=0.02).start()
        chaos.plan("serve.dispatch:timeout@n=1;host=hostB")
        threads = [
            threading.Thread(
                target=skv.kv_worker_serve_loop,
                args=(lambda b: b * 2.0 + 1.0,),
                kwargs=dict(client=client, host_id=h, poll_secs=0.02,
                            device="cpu"),
                daemon=True)
            for h in ("hostA", "hostB")
        ]
        for t in threads:
            t.start()
        try:
            futs = [d.submit(np.full(3, float(i), np.float32))
                    for i in range(12)]
            for i, f in enumerate(futs):
                got = np.asarray(f.result(timeout=30.0))
                assert np.allclose(got, 2.0 * i + 1.0), (i, got)
            assert d.n_resolved == 12
            assert d.n_requeued > 0
            assert chaos.fired.get("serve.dispatch") == 1
        finally:
            coord.stop(shutdown_workers=True)
            for t in threads:
                t.join(timeout=5.0)
            server.stop()


# ---- C12: a respawned worker serves only the leases addressed to it ----------


def _stale_then_respawn(coordinator_mod, request_timeout=0.5):
    """A dead incarnation of hostA announced itself and was leased two
    batches it never answered; the driver retired its announcement (what
    the elastic driver does when it reaps or blacklists a host); then the
    respawn starts. Returns the dispatcher, the respawn's served lease ids,
    the lease ids written to the dead incarnation, and the ids of every
    lease message in hostA's scope."""
    server = RendezvousServer()
    server.start()
    client = RendezvousClient("127.0.0.1", server.port)
    d = Dispatcher(batch_size=4, batch_timeout_ms=5.0,
                   request_timeout_secs=request_timeout, max_attempts=10)
    coord = coordinator_mod.KVServeCoordinator(server, d,
                                               poll_secs=0.02).start()
    served = []
    thread = None
    try:
        server.put(skv.SCOPE_CTL, "ready/hostA", repr(time.time()).encode())
        futs = [d.submit(np.full(3, float(i), np.float32))
                for i in range(8)]
        deadline = time.time() + 20.0
        while (len(server.scope_items(skv.scope_in("hostA"))) < 2
               and time.time() < deadline):
            time.sleep(0.01)

        def lease_ids():
            return {json.loads(raw)["lease"] for raw in
                    server.scope_items(skv.scope_in("hostA")).values()}

        stale = lease_ids()
        assert len(stale) == 2, stale
        server.delete(skv.SCOPE_CTL, "ready/hostA")
        thread = threading.Thread(
            target=skv.kv_worker_serve_loop, args=(lambda b: b * 2.0,),
            kwargs=dict(client=client, host_id="hostA", poll_secs=0.02,
                        device="cpu",
                        on_batch=lambda rec: served.append(rec.get("lease"))),
            daemon=True)
        thread.start()
        for i, f in enumerate(futs):
            got = np.asarray(f.result(timeout=30.0))
            assert np.allclose(got, 2.0 * i), (i, got)
        return d, served, stale, lease_ids()
    finally:
        coord.stop(shutdown_workers=True)
        if thread is not None:
            thread.join(timeout=5.0)
        server.stop()


class TestStaleLeases:
    """ROADMAP C12: a respawned KV serving worker used to replay every
    lease ever written to its scope, the dead incarnation's included."""

    def test_respawn_serves_only_leases_addressed_to_it(self):
        d, served, stale, all_leases = _stale_then_respawn(skv)
        assert d.n_resolved == 8
        # The dead incarnation's two leases re-queued through the lease
        # timeout, and the respawn answered them under new leases.
        assert d.n_requeued >= 8
        assert not set(served) & stale, (served, stale)
        assert len(served) == len(all_leases - stale), (served, all_leases)

    def test_worker_answers_the_reference_coordinator(self):
        """The JAX package's coordinator sends no ready stamp: the port's
        worker serves its messages as before the repair (it replays the
        stale ones too, the fault the reference keeps)."""
        d, served, stale, all_leases = _stale_then_respawn(jskv)
        assert d.n_resolved == 8
        assert set(served) == all_leases

    def test_driver_retires_a_reaped_hosts_announcement(self):
        """``ElasticJob._blacklist`` (and the reaping of an exit) deletes
        ``serve_ctl/ready/<host>``; other hosts keep theirs."""
        from types import SimpleNamespace

        from horovod_tpu_torch.runner import elastic_driver as ed

        server = RendezvousServer()
        server.start()
        try:
            for h in ("hostA", "hostB"):
                server.put(skv.SCOPE_CTL, f"ready/{h}", b"1.0")
            job = ed.ElasticJob.__new__(ed.ElasticJob)
            job.server = server
            job._ordered = ["hostA", "hostB"]
            hm = ed.HostManager(ed.FixedHosts({"hostA": 1, "hostB": 1}))
            job.driver = SimpleNamespace(host_manager=hm)
            job._blacklist("hostA")
            assert sorted(server.scope_items(skv.SCOPE_CTL)) == [
                "ready/hostB"]
            assert job._ordered == ["hostB"]
        finally:
            server.stop()


# ---- serving under the elastic driver, and the in-process soak --------------


class TestServeSoak:
    def test_serve_scenario_zero_dropped_requests(self):
        """A serving worker hard-killed mid-flight under the port's
        elastic driver: zero dropped requests, response count and values
        equal to the fault-free run's, and the host respawns from
        blacklist probation."""
        from horovod_tpu_torch.tools import chaos_soak as soak

        res = soak.run_serve_scenario("serve", timeout=60.0)
        assert soak.check_serve_invariants(res) == []

    def test_multiworker_rescale_under_load(self):
        """In-process pool under sustained load with an autoscaling policy,
        a rolling hot-swap landing mid-traffic and a corrupted follow-up
        hot-swap: every request answered, values from both weight
        versions, and the corrupt target rolled back while serving."""
        d = tempfile.mkdtemp()

        def save(value, step):
            ckptlib.save_checkpoint(d, {"scale": torch.tensor(value)},
                                    step=step, force=True)

        save(2.0, 1)
        policy = QueueDepthPolicy(min_workers=1, max_workers=3, high=2.0,
                                  low=0.5, cooldown_secs=0.0)

        def infer(p, batch):
            time.sleep(0.01)
            return batch * p["scale"]

        pool = ServePool(
            infer, ckpt_dir=d, ckpt_target={"scale": torch.zeros(())},
            workers=1, batch_size=4, batch_timeout_ms=1.0,
            request_timeout_secs=10.0, ckpt_poll_secs=0.05,
            policy=policy, autoscale=True, device="cpu",
        ).start()
        try:
            futs = [pool.submit(torch.ones(2)) for _ in range(40)]
            save(3.0, 2)
            futs += [pool.submit(torch.ones(2)) for _ in range(40)]
            vals = {float(np.asarray(f.result(timeout=30.0))[0])
                    for f in futs}
            assert vals <= {2.0, 3.0}, vals
            t0 = time.time()
            while not pool.swap_log and time.time() - t0 < 10.0:
                time.sleep(0.05)
            assert pool.swap_log, "hot-swap never landed"
            assert np.allclose(
                np.asarray(pool.submit(torch.ones(2)).result(10.0)), 3.0)
            save(9.0, 3)
            path = os.path.join(d, "step_3")
            for root, _, files in os.walk(path):
                for f in sorted(files):
                    if f != ckptlib.MANIFEST_NAME:
                        with open(os.path.join(root, f), "r+b") as fh:
                            fh.seek(0)
                            b = fh.read(1)
                            fh.seek(0)
                            fh.write(bytes([b[0] ^ 0xFF]))
            futs = [pool.submit(torch.ones(2)) for _ in range(20)]
            t0 = time.time()
            while (not any(".corrupt" in n for n in os.listdir(d))
                   and time.time() - t0 < 10.0):
                time.sleep(0.05)
            assert any(".corrupt" in n for n in os.listdir(d))
            for f in futs:
                assert np.allclose(np.asarray(f.result(timeout=30.0)), 3.0)
            assert np.allclose(
                np.asarray(pool.submit(torch.ones(2)).result(10.0)), 3.0)
            assert all(s != 3 for _, s, _, _ in pool.swap_log)
        finally:
            pool.stop()


class TestDecodeSoak:
    def test_decode_scenario_survives(self):
        from horovod_tpu_torch.tools import chaos_soak as soak

        res = soak.run_decode_scenario(timeout=90.0)
        assert soak.check_decode_invariants(res) == []
        assert res["requeued"] > 0
        assert len(res["answered"]) == res["streams"]


# ---- driver-side divergence reports -----------------------------------------


class FakeProc:
    killed = False

    def kill(self, grace=5.0):
        self.killed = True


class TestDriverGuardReports:
    def _job(self, monkeypatch, blacklist_after="2"):
        from horovod_tpu_torch.runner.elastic_driver import (
            ElasticDriver,
            ElasticJob,
            FixedHosts,
        )

        monkeypatch.setenv("HVDTPU_GUARD_BLACKLIST_AFTER", blacklist_after)
        driver = ElasticDriver(FixedHosts({"a": 1, "b": 1}))
        job = ElasticJob(["true"], driver)
        job.server.start()
        return job, driver

    def test_first_report_penalizes_without_killing(self, monkeypatch):
        job, driver = self._job(monkeypatch)
        proc = FakeProc()
        try:
            job._assignment = {"a": 0, "b": 1}
            job._procs = {"b": proc}
            job.server.put("guard", "divergent/b", b"1")
            assert job._check_guard_reports() is False
            assert driver.host_manager.host_health() == {"b": 1}
            assert not proc.killed
            assert not driver.host_manager.is_blacklisted("b")
            assert job._check_guard_reports() is False
            assert driver.host_manager.host_health() == {"b": 1}
            assert job.guard_report_events == 1
        finally:
            job.server.stop()

    def test_repeat_offender_is_killed_and_blacklisted(self, monkeypatch):
        job, driver = self._job(monkeypatch)
        proc = FakeProc()
        try:
            job._assignment = {"a": 0, "b": 1}
            job._procs = {"b": proc}
            job.server.put("guard", "divergent/b", b"1")
            job._check_guard_reports()
            job.server.put("guard", "divergent/b", b"2")
            assert job._check_guard_reports() is True
            assert proc.killed
            assert driver.host_manager.is_blacklisted("b")
            assert driver.host_manager.host_health()["b"] >= 2
        finally:
            job.server.stop()

    def test_respawned_reporter_still_strikes(self, monkeypatch):
        job, driver = self._job(monkeypatch)
        proc = FakeProc()
        try:
            job._assignment = {"a": 0, "b": 1}
            job._procs = {"b": proc}
            job.server.put("guard", "divergent/b", b"1:4")
            job._check_guard_reports()
            assert driver.host_manager.host_health() == {"b": 1}
            job.server.put("guard", "divergent/b", b"1:9")
            assert job._check_guard_reports() is True
            assert proc.killed and driver.host_manager.is_blacklisted("b")
        finally:
            job.server.stop()

    def test_penalize_lengthens_a_later_cooldown(self):
        from horovod_tpu_torch.runner.elastic_driver import (
            FixedHosts,
            HostManager,
        )

        hm = HostManager(FixedHosts({"a": 1}), cooldown=10.0)
        hm.penalize("a")
        assert hm.host_health() == {"a": 1}
        assert not hm.is_blacklisted("a")
        hm.blacklist("a")
        health = hm._blacklist["a"]
        assert health.strikes == 2
        assert health.until - time.time() > 15.0

    def test_audit_reports_a_minority_host_over_the_kv(self, monkeypatch):
        """The worker half: the audit's default report channel writes
        ``guard/divergent/<host>`` = ``count:step`` into the elastic KV,
        the value the driver's strike tally reads."""
        from horovod_tpu_torch.guard.audit import ConsistencyAuditor

        server = RendezvousServer("127.0.0.1")
        port = server.start()
        try:
            monkeypatch.setenv("HVDTPU_ELASTIC", "1")
            monkeypatch.setenv("HVDTPU_RENDEZVOUS_ADDR", "127.0.0.1")
            monkeypatch.setenv("HVDTPU_RENDEZVOUS_PORT", str(port))
            crcs = iter([[1, 2, 1]])
            aud = ConsistencyAuditor(
                rank=0, host_id="a",
                allgather_object=lambda d: [
                    {"rank": r, "host": h, "crc": c}
                    for r, (h, c) in enumerate(zip("abc", next(crcs)))],
                broadcast_leaf=lambda t, root, name: t)
            tree = {"w": torch.ones(2)}
            aud.audit(tree, step=7)
            assert server.scope_items("guard") == {"divergent/b": b"1:7"}
        finally:
            server.stop()
