"""The port's schedule certification (``horovod_tpu_torch/analysis/
certify.py``) held against the JAX package's, and its preflight over the
port's rendezvous KV.

* The digest recipe and ``CERT_VERSION`` are the reference's: the same
  entries, world and wire give the same digest in both packages, and the
  reference's ``diff_certs`` reads a port cert as its own.
* Two builds with equal knobs give equal digests; a build at another
  fusion threshold gives ``diff_certs``'s first divergent index.
* ``publish_and_verify`` over a ``RendezvousServer`` with two loopback
  hosts passes on equal certs, raises ``CertMismatchError`` under
  ``raise`` and warns (and counts ``cert.mismatch``) under ``warn`` on
  unequal ones, and times out bounded when a host never publishes.
* The step's preflight: a no-op outside an elastic world, and under an
  elastic world (a stubbed ``cert_channel``) it runs once, on the first
  call, and again after a call it failed; an autotune retrace rebuild
  re-certifies under ``retrace<n>``.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from horovod_tpu.analysis import certify as jcert
from horovod_tpu_torch import analysis as tan
from horovod_tpu_torch import optimizer as topt
from horovod_tpu_torch.analysis import certify as tcert
from horovod_tpu_torch.analysis import harness as tharness
from horovod_tpu_torch.parallel import dp as tdp


def _cert(**variant):
    return tharness.cert_model("gpt2", **variant)


def test_digest_recipe_is_the_references():
    cert = _cert(sharded=True)
    assert tcert.CERT_VERSION == jcert.CERT_VERSION
    assert tcert._digest(list(cert.entries), cert.world, list(cert.wire)) == \
        jcert._digest(list(cert.entries), cert.world, list(cert.wire)) == \
        cert.digest
    # A port cert round-trips through the reference's own format.
    as_ref = jcert.ScheduleCert.from_dict(cert.to_dict())
    assert jcert.diff_certs(as_ref, as_ref) is None
    assert tcert.ScheduleCert.from_dict(cert.to_dict()).digest == cert.digest


def test_equal_builds_certify_equal_and_a_threshold_change_diverges(
        monkeypatch):
    a = _cert(sharded=True)
    step, state, batch = tharness.build_step("gpt2", sharded=True)
    with tan.simulated_world(8):
        fresh = step.certify(state, batch)  # a record of its own
    assert fresh.digest == a.digest
    assert tan.diff_certs(a, fresh) is None
    # Another fusion threshold splits GPT-2 tiny's one bucket.
    monkeypatch.setenv("HVDTPU_FUSION_THRESHOLD", str(64 * 1024))
    b = _cert(sharded=True)
    assert b.digest != a.digest
    diff = tan.diff_certs(a, b)
    assert diff["reason"] == "entry-mismatch"
    assert diff["first_divergent_index"] == 0
    assert diff["a_entry"]["in"] == ["float32[108032]"]
    ref = jcert.diff_certs(jcert.ScheduleCert.from_dict(a.to_dict()),
                           jcert.ScheduleCert.from_dict(b.to_dict()))
    assert ref == diff


def test_meta_is_not_in_the_digest_and_the_wire_is():
    a = _cert(sharded=True)
    rec = tharness.traced_step("gpt2", sharded=True)[3]
    b = tan.schedule_cert(rec, world=8, wire=list(a.wire), meta={"x": 1})
    assert b.digest == a.digest
    c = tan.schedule_cert(rec, world=8, wire=[["float32", 1]])
    assert c.digest != a.digest
    assert tan.diff_certs(a, c)["reason"] == "wire-mismatch"
    d = tan.schedule_cert(rec, world=4, wire=list(a.wire))
    assert tan.diff_certs(a, d)["reason"] == "world-mismatch"


@pytest.fixture
def kv_server():
    from horovod_tpu_torch.runner.http_server import (RendezvousClient,
                                                      RendezvousServer)

    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    try:
        yield lambda: RendezvousClient("127.0.0.1", port, timeout=5.0)
    finally:
        server.stop()


def _both_hosts(client, certs, mode, timeout=10.0):
    """Two hosts publish and verify at once over one KV; returns each
    host's report or raised exception, and the warnings the two raised
    (caught here: the warnings filters are the process's, not a
    thread's)."""
    out = {}

    def host(name, cert):
        try:
            out[name] = tan.publish_and_verify(client(), 0, name, cert,
                                               n_hosts=2, mode=mode,
                                               timeout=timeout, poll=0.01)
        except tan.CertMismatchError as e:
            out[name] = e

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        threads = [threading.Thread(target=host, args=(f"h{i}", c))
                   for i, c in enumerate(certs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 30)
    return out, [str(w.message) for w in caught]


def test_preflight_over_the_kv_passes_on_equal_certs(kv_server):
    cert = _cert(sharded=True)
    out, warned = _both_hosts(kv_server, [cert, cert], "raise")
    assert not warned
    for name in ("h0", "h1"):
        rep = out[name]
        assert rep["ok"] and rep["mismatch"] is None
        assert rep["hosts"] == {"h0": cert.digest, "h1": cert.digest}


def test_preflight_over_the_kv_raises_on_a_mismatch(kv_server,
                                                    monkeypatch):
    a = _cert(sharded=True)
    monkeypatch.setenv("HVDTPU_FUSION_THRESHOLD", str(64 * 1024))
    b = _cert(sharded=True)
    out, _ = _both_hosts(kv_server, [a, b], "raise")
    for name in ("h0", "h1"):
        err = out[name]
        assert isinstance(err, tan.CertMismatchError)
        assert err.report["mismatch"]["diff"]["first_divergent_index"] == 0
        assert "first divergent schedule index 0" in str(err)


def test_preflight_over_the_kv_warns_and_counts_under_warn(kv_server,
                                                           monkeypatch):
    from horovod_tpu_torch.obs import registry

    a = _cert(sharded=True)
    monkeypatch.setenv("HVDTPU_FUSION_THRESHOLD", str(64 * 1024))
    b = _cert(sharded=True)
    registry._registry.reset()
    registry._enabled = None
    try:
        registry.enable()
        out, warned = _both_hosts(kv_server, [a, b], "warn")
        for name in ("h0", "h1"):
            rep = out[name]
            assert rep["ok"] is False and rep["mismatch"] is not None
        assert sum("cert preflight" in w for w in warned) == 2
        snap = registry.metrics().snapshot()
        assert snap["counters"]["cert.mismatch"] == 2
    finally:
        registry._registry.reset()
        registry._enabled = None


def test_preflight_times_out_bounded_when_a_host_is_missing(kv_server):
    cert = _cert(sharded=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = tan.publish_and_verify(kv_server(), 1, "h0", cert, n_hosts=2,
                                     mode="warn", timeout=0.3, poll=0.05)
    assert rep["ok"] is False and rep["n_published"] == 1
    assert any("exchange incomplete" in str(w.message) for w in caught)
    with pytest.raises(tan.CertMismatchError, match="exchange incomplete"):
        tan.publish_and_verify(kv_server(), 2, "h0", cert, n_hosts=2,
                               mode="raise", timeout=0.2, poll=0.05)


def test_channel_tags_namespace_rebuilds(kv_server):
    cert = _cert(sharded=True)
    ch = tan.KVCertChannel(kv_server(), "h0", 3, 1)
    assert ch.preflight(cert, mode="raise")["round"] == "3"
    assert ch.preflight(cert, tag="retrace1", mode="raise")["round"] == \
        "3.retrace1"
    assert sorted(kv_server().keys("cert")) == ["3.retrace1/h0", "3/h0"]


def test_cert_mode_knob_matches_the_reference(monkeypatch):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.utils import env as tenv

    for val in (None, "raise", "off", "1", "warn"):
        if val is None:
            monkeypatch.delenv("HVDTPU_CERT", raising=False)
        else:
            monkeypatch.setenv("HVDTPU_CERT", val)
        assert tenv.cert_mode() == jenv.cert_mode()
        assert tenv.cert_timeout_secs() == jenv.cert_timeout_secs()
    monkeypatch.setenv("HVDTPU_CERT", "error")
    with pytest.raises(ValueError, match="HVDTPU_CERT"):
        tenv.cert_mode()


# -- the step's preflight ------------------------------------------------------


def _regression_step(**kw):
    rs = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rs.standard_normal((8, 4)).astype(
        np.float32))}
    batch = torch.from_numpy(rs.standard_normal((4, 8)).astype(np.float32))
    step, opt = tdp.make_train_step(lambda p, b: (b @ p["w"]).square().mean(),
                                    topt.adamw(1e-2), device="cpu", **kw)
    return step, tdp.init_state(params, opt), batch


class _Channel:
    def __init__(self, fail_first=False):
        self.calls = []
        self.fail_first = fail_first

    def preflight(self, cert, tag="", mode=None):
        self.calls.append((cert.digest, tag, mode))
        if self.fail_first and len(self.calls) == 1:
            raise tan.CertMismatchError({"round": 0, "mismatch": {
                "host": "h1", "diff": {"first_divergent_index": 0}}})
        return {"ok": True}


def test_step_preflight_is_a_no_op_outside_an_elastic_world():
    from horovod_tpu_torch.elastic import worker

    assert worker.cert_channel() is None
    step, state, batch = _regression_step()
    assert step.preflight(state, batch) is None
    state, _ = step(state, batch)
    assert step._cert_latch["done"]


def test_step_preflight_runs_on_the_first_call_and_after_a_failure(
        monkeypatch):
    from horovod_tpu_torch.elastic import worker

    channel = _Channel(fail_first=True)
    monkeypatch.setattr(worker, "cert_channel", lambda: channel)
    monkeypatch.setenv("HVDTPU_CERT", "raise")
    step, state, batch = _regression_step()
    w0 = state.params["w"].detach().clone()
    with pytest.raises(tan.CertMismatchError):
        step(state, batch)
    assert torch.equal(state.params["w"], w0)  # nothing dispatched
    state, _ = step(state, batch)  # verifies again, then runs
    state, _ = step(state, batch)  # latched: no third preflight
    assert [c[1:] for c in channel.calls] == [("", "raise"), ("", "raise")]
    assert channel.calls[0][0] == step.certify(state, batch).digest
    assert int(state.step) == 2


def test_step_preflight_runs_again_in_every_round_it_joins(monkeypatch):
    # A rejoin is where ranks drift apart: the survivors re-certify with
    # the respawned, or the respawned would wait for their certs.
    from horovod_tpu_torch.elastic import worker

    channel = _Channel()
    joined = {"round": 0}
    monkeypatch.setattr(worker, "cert_channel", lambda: channel)
    monkeypatch.setattr(worker, "current_round", lambda: joined["round"])
    step, state, batch = _regression_step()
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    joined["round"] = 1
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    assert len(channel.calls) == 2


def test_an_autotune_rebuild_recertifies_under_a_tag(monkeypatch):
    from horovod_tpu_torch import tune as ttune
    from horovod_tpu_torch.elastic import worker

    channel = _Channel()
    monkeypatch.setattr(worker, "cert_channel", lambda: channel)
    snapshot = dict(__import__("os").environ)
    try:
        cfg = ttune.AutotuneConfig(window_steps=1, warmup_steps=0,
                                   max_trials=3, patience=3, seed=1)
        step, state, batch = _regression_step(autotune=cfg)
        for _ in range(4):
            state, _ = step(state, batch)
    finally:
        import os

        os.environ.clear()
        os.environ.update(snapshot)
    tags = [c[1] for c in channel.calls]
    assert tags[0] == "" and step._n_retraces >= 1
    assert tags[1:] == [f"retrace{i + 1}" for i in range(step._n_retraces)]
