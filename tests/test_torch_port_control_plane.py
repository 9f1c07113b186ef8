"""The port's control plane held against the JAX package's: twins of
tests/test_control_plane.py -- the durable KV journal, the rendezvous
server's handlers under attack and concurrency, reconnect epochs, the
driver's crash-adoption state, the preemption-grace hooks and the three
control-plane soak scenarios -- plus the journal's format parity: a
journal written by either package's ``ControlPlaneJournal`` recovers to
the same store in the other, a torn tail included.

The soak scenarios run the port's ``horovod_tpu_torch.tools.chaos_soak``
(gloo worlds of CPU processes on loopback hosts, ~10 s each).
"""

import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from horovod_tpu.runner.journal import ControlPlaneJournal as JJournal
from horovod_tpu_torch.runner.http_server import (
    EPOCH_HEADER,
    RendezvousClient,
    RendezvousServer,
)
from horovod_tpu_torch.runner.journal import (
    ControlPlaneJournal,
    _frame,
    _unframe,
)


@pytest.fixture()
def jdir(tmp_path):
    return str(tmp_path / "journal")


# ---- journal: framing, replay, compaction -------------------------------


class TestJournal:
    def test_roundtrip(self, jdir):
        j = ControlPlaneJournal(jdir)
        j.record_put("s1", "a", b"v1")
        j.record_put("s1", "b", b"\x00\xffbinary")
        j.record_put("s2", "x", b"old")
        j.record_put("s2", "x", b"new")
        j.record_delete("s1", "b")
        j.record_delete_scope("gone")
        j.record_driver({"round": 3, "secret": "abc"})
        j.close()
        store, driver = ControlPlaneJournal(jdir).recover()
        assert store == {"s1": {"a": b"v1"}, "s2": {"x": b"new"}}
        assert driver == {"round": 3, "secret": "abc"}

    def test_clear_and_empty(self, jdir):
        j = ControlPlaneJournal(jdir)
        j.record_put("s", "k", b"v")
        j.record_clear()
        j.record_put("t", "k2", b"w")
        store, driver = j.recover()
        assert store == {"t": {"k2": b"w"}}
        assert driver is None
        s2, d2 = ControlPlaneJournal(jdir + "_none").recover()
        assert s2 == {} and d2 is None

    def test_compaction_equivalence(self, jdir):
        j = ControlPlaneJournal(jdir)
        j.record_put("s", "a", b"1")
        j.record_driver({"round": 0})
        j.compact({"s": {"a": b"1"}}, {"round": 0})
        assert j.records_since_compact == 0 and j.compactions == 1
        j.record_put("s", "b", b"2")
        store, driver = j.recover()
        assert store == {"s": {"a": b"1", "b": b"2"}}
        assert driver == {"round": 0}
        j.record_put("s", "a", b"1")
        store, driver = j.recover()
        assert store == {"s": {"a": b"1", "b": b"2"}}

    def test_torn_tail_recovers_prefix(self, jdir):
        j = ControlPlaneJournal(jdir)
        for i in range(5):
            j.record_put("s", f"k{i}", b"v")
        j.close()
        with open(j.journal_path, "r+") as f:
            content = f.read()
            f.seek(0)
            f.truncate()
            f.write(content[: len(content) - 7])
        j2 = ControlPlaneJournal(jdir)
        store, _ = j2.recover()
        assert set(store["s"]) == {"k0", "k1", "k2", "k3"}
        assert j2.last_recovery == (4, 1)

    def test_fuzz_truncation_never_crashes(self, jdir):
        j = ControlPlaneJournal(jdir)
        records = [("s", f"k{i}", str(i).encode()) for i in range(20)]
        for scope, key, value in records:
            j.record_put(scope, key, value)
        j.close()
        raw = open(j.journal_path, "rb").read()
        offsets = [0]
        for line in raw.split(b"\n")[:-1]:
            offsets.append(offsets[-1] + len(line) + 1)
        rng = random.Random(1234)
        for cut in sorted(rng.sample(range(len(raw) + 1), 40)) + [len(raw)]:
            with open(j.journal_path, "wb") as f:
                f.write(raw[:cut])
            store, _ = ControlPlaneJournal(jdir).recover()
            n_complete = sum(1 for off in offsets[1:] if off - 1 <= cut)
            want = {k: v for _, k, v in records[:n_complete]}
            assert store.get("s", {}) == want, f"cut at {cut}"

    def test_owner_only_permissions(self, jdir):
        j = ControlPlaneJournal(jdir)
        j.record_driver({"secret": "hush"})
        j.compact({}, {"secret": "hush"})
        j.record_put("s", "k", b"v")
        assert os.stat(jdir).st_mode & 0o777 == 0o700
        for name in (j.journal_path, j.snapshot_path):
            assert os.stat(name).st_mode & 0o077 == 0, name

    def test_frame_rejects_bitrot(self):
        line = _frame('{"op":"clear"}')
        assert _unframe(line) == {"op": "clear"}
        assert _unframe(line.replace("clear", "cleaR")) is None
        assert _unframe("garbage") is None
        assert _unframe("0123456z " + '{"op":"clear"}') is None


def _write_history(j):
    j.record_put("s1", "a", b"v1")
    j.record_put("round_2", "assign/h", b"\x00\xff1")
    j.record_driver({"round": 2, "secret": "abc", "blacklist": {}})
    j.compact({"s1": {"a": b"v1"}, "round_2": {"assign/h": b"\x00\xff1"}},
              {"round": 2, "secret": "abc", "blacklist": {}})
    j.record_put("s2", "x", b"old")
    j.record_put("s2", "x", b"new")
    j.record_delete("s1", "a")
    j.record_delete_scope("gone")
    j.record_driver({"round": 3, "secret": "abc", "blacklist": {"h": 1}})
    for i in range(4):
        j.record_put("tail", f"k{i}", str(i).encode())
    j.close()


@pytest.mark.parametrize("writer,reader", [
    ("port", "reference"), ("reference", "port")])
@pytest.mark.parametrize("torn", [False, True])
def test_journal_recovers_across_packages(tmp_path, writer, reader, torn):
    """The same on-disk format: either package recovers the other's
    journal (snapshot + WAL) to the same store and driver state, and a
    torn tail to the same longest valid prefix."""
    d = str(tmp_path / "j")
    cls = {"port": ControlPlaneJournal, "reference": JJournal}
    _write_history(cls[writer](d))
    if torn:
        path = os.path.join(d, "journal.jsonl")
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[:-9])
    store_r, driver_r = cls[reader](d).recover()
    store_w, driver_w = cls[writer](d).recover()
    assert (store_r, driver_r) == (store_w, driver_w)
    assert driver_r == {"round": 3, "secret": "abc", "blacklist": {"h": 1}}
    assert store_r["s2"] == {"x": b"new"} and not store_r.get("s1")
    assert store_r["round_2"] == {"assign/h": b"\x00\xff1"}
    assert sorted(store_r["tail"]) == (["k0", "k1", "k2"] if torn else
                                       ["k0", "k1", "k2", "k3"])


# ---- server: journal replay, restart, epochs, GC ------------------------


class TestDurableServer:
    def test_replay_equivalence(self, jdir):
        srv = RendezvousServer(host="127.0.0.1", journal_dir=jdir)
        port = srv.start()
        cli = RendezvousClient("127.0.0.1", port)
        cli.put("a", "k1", b"v1")
        cli.put("a", "k2", b"v2")
        srv.put("b", "x", b"direct")
        srv.delete("a", "k2")
        before = srv.snapshot_store()
        srv.stop()
        srv2 = RendezvousServer(host="127.0.0.1", journal_dir=jdir)
        srv2.start()
        assert srv2.snapshot_store() == before
        assert srv2.scope_items("a") == {"k1": b"v1"}
        srv2.stop()

    def test_restart_with_and_without_journal(self, jdir):
        srv = RendezvousServer(host="127.0.0.1", journal_dir=jdir)
        port = srv.start()
        cli = RendezvousClient("127.0.0.1", port)
        cli.put("s", "k", b"v")
        e1 = srv.epoch
        e2 = srv.restart(replay=True)
        assert e2 != e1 and srv.port == port
        assert cli.get("s", "k") == b"v"
        assert srv.restarts == 1
        srv.restart(replay=False)
        assert cli.get("s", "k") is None
        srv.stop()

    def test_restart_waits_for_a_port_taken_in_the_gap(self, jdir,
                                                       monkeypatch):
        """C19: a restart closes its listener and binds the same port
        again; a socket opened in that gap by another process (on a busy
        host the kernel hands the freed port out as a connection's source
        port) held it at the rebind, which raised EADDRINUSE and ended the
        elastic driver of the kv_server_crash soak. The rebind now waits
        for the port."""
        import socket

        from horovod_tpu_torch.runner import http_server

        srv = RendezvousServer(host="127.0.0.1", journal_dir=jdir)
        port = srv.start()
        # Direct writes: a request's closed connection would sit in
        # TIME_WAIT on the port, and only a reusing bind passes that.
        srv.put("s", "k", b"v")
        old = srv._server
        real_close = http_server._Server.server_close
        taken = []

        def close_then_take(self):
            real_close(self)
            if self is old:
                s = socket.socket()
                s.bind(("127.0.0.1", port))
                taken.append(s)
                threading.Timer(0.5, s.close).start()

        monkeypatch.setattr(http_server._Server, "server_close",
                            close_then_take)
        t0 = time.monotonic()
        srv.restart(replay=True)
        assert taken and srv.port == port
        assert time.monotonic() - t0 >= 0.4
        assert RendezvousClient("127.0.0.1", port).get("s", "k") == b"v"
        srv.stop()

    def test_heartbeat_scope_not_journaled(self, jdir):
        srv = RendezvousServer(host="127.0.0.1", journal_dir=jdir)
        port = srv.start()
        cli = RendezvousClient("127.0.0.1", port)
        cli.put("heartbeat", "h1", b"beat")
        srv.put("heartbeat", "h2", b"beat")
        cli.put("elastic", "round", b"3")
        srv.compact_journal({"round": 3})
        srv.restart(replay=True)
        assert srv.scope_items("heartbeat") == {}
        assert srv.scope_items("elastic") == {"round": b"3"}
        srv.stop()

    def test_client_reconnect_epoch(self, jdir):
        srv = RendezvousServer(host="127.0.0.1", journal_dir=jdir)
        port = srv.start()
        cli = RendezvousClient("127.0.0.1", port)
        cli.put("s", "k", b"v")
        first = cli.server_epoch
        assert first == srv.epoch
        srv.restart(replay=True)
        assert cli.get("s", "k") == b"v"
        assert cli.server_epoch == srv.epoch != first
        assert cli.reconnects == 1
        srv.stop()

    def test_request_survives_restart_gap(self, jdir):
        srv = RendezvousServer(host="127.0.0.1", secret="shh",
                               journal_dir=jdir)
        port = srv.start()
        cli = RendezvousClient("127.0.0.1", port, secret="shh", retries=50)
        cli.put("s", "k", b"v")
        srv._server.shutdown()
        srv._server.server_close()
        srv._server = None

        def _revive():
            time.sleep(0.5)
            srv.start(port=port)

        t = threading.Thread(target=_revive, daemon=True)
        t.start()
        cli.put("s", "k2", b"v2")
        t.join()
        assert srv.scope_items("s") == {"k": b"v", "k2": b"v2"}
        assert cli.retries_seen > 0
        srv.stop()

    def test_gc_bounds_store_growth(self):
        srv = RendezvousServer(host="127.0.0.1")
        srv.start()
        for n in range(4):
            srv.put(f"round_{n}", "size", b"2")
            srv.put(f"dist_{n}", "store", b"x:1")
        for host in ("a", "b"):
            srv.put("heartbeat", host, b"beat")
            srv.put("preempt", host, b"1")
            srv.put("exit", host, b"0")
            srv.put("guard", f"divergent/{host}", b"1")
        assert srv.gc(3, ["a"]) > 0
        store = srv.snapshot_store()
        assert "round_0" not in store and "round_1" not in store
        assert "round_2" in store and "round_3" in store
        assert "dist_0" not in store and "dist_3" in store
        assert set(store["heartbeat"]) == {"a"}
        assert set(store["preempt"]) == {"a"}
        assert set(store["guard"]) == {"divergent/a"}
        srv.stop()


# ---- HTTP handlers: concurrency + auth ----------------------------------


class TestHandlers:
    def test_concurrent_writers_one_scope(self):
        srv = RendezvousServer(host="127.0.0.1")
        port = srv.start()
        n_threads, n_keys = 8, 25

        def writer(t):
            cli = RendezvousClient("127.0.0.1", port)
            for i in range(n_keys):
                cli.put("shared", f"t{t}_k{i}", f"{t}:{i}".encode())

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        items = srv.scope_items("shared")
        assert len(items) == n_threads * n_keys
        assert items["t3_k7"] == b"3:7"
        srv.stop()

    def _raw(self, port, method, path, headers=None, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=body, method=method,
            headers=headers or {})
        try:
            resp = urllib.request.urlopen(req, timeout=5)
            return resp.status, dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers)

    def test_unsigned_and_malformed_requests_rejected(self):
        from horovod_tpu_torch.runner.secret import (
            DIGEST_HEADER, TS_HEADER, compute_digest, signed_message,
        )

        srv = RendezvousServer(host="127.0.0.1", secret="topsecret")
        port = srv.start()
        code, headers = self._raw(port, "PUT", "/s/k", body=b"v")
        assert code == 403
        assert headers.get(EPOCH_HEADER) == srv.epoch
        code, _ = self._raw(
            port, "PUT", "/s/k",
            headers={DIGEST_HEADER: "ff" * 32, TS_HEADER: repr(time.time())},
            body=b"v")
        assert code == 403
        msg = signed_message("PUT", "/s/k", "", b"v")
        code, _ = self._raw(
            port, "PUT", "/s/k",
            headers={DIGEST_HEADER: compute_digest("topsecret", msg)},
            body=b"v")
        assert code == 403
        assert srv.scope_items("s") == {}
        srv.stop()

    def test_replayed_put_rejected_polled_get_allowed(self):
        from horovod_tpu_torch.runner.secret import (
            DIGEST_HEADER, TS_HEADER, compute_digest, signed_message,
        )

        srv = RendezvousServer(host="127.0.0.1", secret="topsecret")
        port = srv.start()
        ts = repr(time.time())
        digest = compute_digest("topsecret",
                                signed_message("PUT", "/s/k", ts, b"v"))
        hdr = {DIGEST_HEADER: digest, TS_HEADER: ts}
        assert self._raw(port, "PUT", "/s/k", headers=hdr, body=b"v")[0] == 200
        assert self._raw(port, "PUT", "/s/k", headers=hdr, body=b"v")[0] == 403
        ts_g = repr(time.time())
        dg = compute_digest("topsecret",
                            signed_message("GET", "/s/k", ts_g, b""))
        for _ in range(3):
            code, _ = self._raw(port, "GET", "/s/k",
                                headers={DIGEST_HEADER: dg, TS_HEADER: ts_g})
            assert code == 200
        srv.stop()


# ---- driver crash-adoption ----------------------------------------------


class TestAdoption:
    def _make_job(self, jdir, adopt=False):
        from horovod_tpu_torch.runner import elastic_driver as ed

        driver = ed.ElasticDriver(
            ed.FixedHosts({"localhost": 1, "127.0.0.1": 1}), min_np=1)
        return ed.ElasticJob(["true"], driver, journal_dir=jdir, adopt=adopt)

    def test_state_reconstruction(self, jdir):
        job = self._make_job(jdir)
        job.server.start()
        job.driver.host_manager.update_available_hosts()
        job._publish_round(job.driver.host_manager.current_hosts)
        job.driver.host_manager.blacklist("127.0.0.1")
        job._guard_reports["127.0.0.1"] = (b"1:nonce", 1)
        job._completed.add("ghost")
        job._journal_state()
        sec, port, rnd = job.server.secret, job.server.port, job._round
        assignment = dict(job._assignment)
        job.server.stop()

        job2 = self._make_job(jdir, adopt=True)
        assert job2.server.secret == sec
        assert job2._epoch_gen == 1
        job2.server.start(port=int(job2._adopted_state["port"]),
                          store=job2._recovered_store)
        job2._restore_adopted_state()
        assert job2._round == rnd
        assert job2._assignment == assignment
        assert job2._guard_reports["127.0.0.1"] == (b"1:nonce", 1)
        assert job2._completed == {"ghost"}
        assert job2.driver.host_manager.health_snapshot()[
            "127.0.0.1"]["strikes"] == 1
        assert job2.server.port == port
        assert job2.server.scope_items("elastic")["round"] == str(
            rnd).encode()
        job2.server.stop()

    def test_fresh_run_truncates_stale_journal(self, jdir):
        stale = ControlPlaneJournal(jdir)
        stale.record_put("round_9", "size", b"7")
        stale.record_driver({"round": 9, "secret": "old"})
        stale.close()
        job = self._make_job(jdir)
        assert job._adopted_state is None
        job.server.start(store={})
        job.journal.compact({}, None)
        store, driver = ControlPlaneJournal(jdir).recover()
        assert store == {} and driver is None
        job.server.stop()

    def test_adopt_without_state_falls_back_fresh(self, jdir):
        ControlPlaneJournal(jdir).close()
        job = self._make_job(jdir, adopt=True)
        assert job._adopted_state is None
        assert job._epoch_gen == 0

    def test_adopt_requires_journal(self):
        from horovod_tpu_torch.runner import elastic_driver as ed

        driver = ed.ElasticDriver(ed.FixedHosts({"localhost": 1}), min_np=1)
        with pytest.raises(ValueError):
            ed.ElasticJob(["true"], driver, adopt=True)

    def test_adopted_job_poll_and_kill(self):
        from horovod_tpu_torch.runner.api import _AdoptedJob

        proc = subprocess.Popen([sys.executable, "-c",
                                 "import time; time.sleep(60)"])
        try:
            job = _AdoptedJob("h", proc.pid, lambda h: None)
            assert job.poll() is None
            job.kill(grace=2.0)
            proc.wait(timeout=5)
            assert job.poll() == 1
        finally:
            if proc.poll() is None:
                proc.kill()
        done = subprocess.Popen([sys.executable, "-c", "pass"])
        done.wait(timeout=10)
        assert _AdoptedJob("h", done.pid, lambda h: b"0").poll() == 0


# ---- preemption grace ----------------------------------------------------


class TestPreemption:
    @pytest.fixture(autouse=True)
    def _reset(self):
        from horovod_tpu_torch.elastic import worker as ew

        ew._reset_preempt_for_tests()
        old = signal.getsignal(signal.SIGTERM)
        yield
        signal.signal(signal.SIGTERM, old)
        ew._reset_preempt_for_tests()

    def test_sigterm_sets_flag_and_checkpoint_runs_once(self):
        from horovod_tpu_torch.elastic import worker as ew

        calls = []
        ew.register_preempt_callback(lambda: calls.append(1))
        assert ew.install_preemption_handler("hostX")
        assert not ew.preempt_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not ew.preempt_requested() and time.time() < deadline:
            time.sleep(0.01)
        assert ew.preempt_requested()
        assert ew.run_preempt_checkpoint() is True
        assert ew.run_preempt_checkpoint() is False
        assert calls == [1]

    def test_checkpoint_noop_without_notice(self):
        from horovod_tpu_torch.elastic import worker as ew

        calls = []
        ew.register_preempt_callback(lambda: calls.append(1))
        assert ew.run_preempt_checkpoint() is False
        assert calls == []

    def test_checkpoint_retries_transient_oserror(self):
        from horovod_tpu_torch.elastic import worker as ew

        attempts = []

        def flaky():
            attempts.append(1)
            if len(attempts) < 2:
                raise OSError("disk hiccup")

        ew.register_preempt_callback(flaky)
        ew._preempt_flag.set()
        assert ew.run_preempt_checkpoint() is True
        assert len(attempts) == 2
        ew._reset_preempt_for_tests()
        broken = []
        ew.register_preempt_callback(
            lambda: (_ for _ in ()).throw(OSError("fs down")))
        ew.register_preempt_callback(lambda: broken.append("still ran"))
        ew._preempt_flag.set()
        assert ew.run_preempt_checkpoint() is True
        assert broken == ["still ran"]

    def test_commit_takes_priority_checkpoint(self, tmp_path):
        from horovod_tpu_torch import checkpoint as ckptlib
        from horovod_tpu_torch import elastic
        from horovod_tpu_torch.elastic import worker as ew

        state = elastic.ObjectState(step=7, w=torch.ones(2))
        cdir = str(tmp_path / "pc")
        before = ckptlib.priority_checkpoints
        ew.register_preempt_callback(
            lambda: ckptlib.priority_checkpoint(
                cdir, {"step": torch.tensor(state.step)}, step=state.step))
        ew._preempt_flag.set()
        state.commit()
        assert ckptlib.all_steps(cdir) == [7]
        assert ckptlib.verify_step_dir(os.path.join(cdir, "step_7")) == []
        assert ckptlib.priority_checkpoints == before + 1

    def test_driver_consumes_preempt_flag(self, jdir):
        from horovod_tpu_torch.runner import elastic_driver as ed

        driver = ed.ElasticDriver(
            ed.FixedHosts({"localhost": 1, "127.0.0.1": 1}), min_np=1)
        job = ed.ElasticJob(["true"], driver, journal_dir=jdir)
        job.server.start()
        job.driver.host_manager.update_available_hosts()
        job._publish_round(job.driver.host_manager.current_hosts)
        assert job._round == 0
        job.server.put("preempt", "127.0.0.1", b"now")
        assert job._check_preemptions() is True
        assert "127.0.0.1" in job._preempted
        assert job._check_preemptions() is False
        job._publish_round(job.driver.host_manager.current_hosts)
        assert "127.0.0.1" not in job._assignment
        assert job._assignment == {"localhost": 0}
        assert not job.driver.host_manager.host_health()
        job.server.stop()


# ---- env knobs -----------------------------------------------------------


class TestKnobs:
    def test_journal_compact_bytes_floor(self, monkeypatch):
        from horovod_tpu_torch.utils import env as _env

        monkeypatch.setenv("HVDTPU_JOURNAL_COMPACT_BYTES", "1")
        assert _env.journal_compact_bytes() == 4096
        monkeypatch.setenv("HVDTPU_JOURNAL_COMPACT_BYTES", "65536")
        assert _env.journal_compact_bytes() == 65536

    def test_preempt_cooldown_floor(self, monkeypatch):
        from horovod_tpu_torch.utils import env as _env

        monkeypatch.setenv("HVDTPU_PREEMPT_COOLDOWN_SECS", "0")
        assert _env.preempt_cooldown_secs() == 1.0
        monkeypatch.setenv("HVDTPU_PREEMPT_COOLDOWN_SECS", "120")
        assert _env.preempt_cooldown_secs() == 120.0


# ---- the three control-plane soak scenarios -------------------------------


@pytest.mark.parametrize("scenario",
                         ["preempt", "kv_server_crash", "driver_crash"])
def test_control_plane_soak(scenario):
    """Each control-plane scenario end to end: rc=0, exact step counts,
    bit-identical analytic finals, zero healthy-worker restarts through
    the control-plane outage, blacklist history kept across adoption,
    graceful shrink on preemption."""
    from horovod_tpu_torch.tools import chaos_soak as soak

    res = soak.run_scenario(scenario, steps=6, timeout=90.0)
    assert soak.check_invariants(res, steps=6) == []
