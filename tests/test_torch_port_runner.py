"""The port's launcher (horovod_tpu_torch.runner) held against the JAX
package's: twins of tests/test_runner.py, test for test, plus the wire and
format parity the two packages share.

* Wire parity: a port ``RendezvousClient`` against a reference
  ``RendezvousServer`` and the reverse, under one job secret.
* Equal outputs of ``parse_hosts``, ``get_host_assignments`` (heterogeneous
  slots too), the config-file layer, the secret's digests and
  ``nics.choose_common`` on the same inputs.

Differences, each with its twin here: a launch is one process per slot
(``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` from the slot);
the two-host world is a gloo world bootstrapped over the KV (the
reference's twin forms its native world); ``run`` ships module-level
functions with the standard library's pickle and refuses a closure;
``--check-build`` reports torch, the card toolchain and the
``torch.distributed`` backends; ``--timeline-*`` map to the timeline's
knobs and ``--autotune`` arms the autotuner.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import pytest

from horovod_tpu.runner import config_parser as jconfig
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import http_server as jhttp
from horovod_tpu.runner import nics as jnics
from horovod_tpu.runner import secret as jsecret
from horovod_tpu_torch.runner import api
from horovod_tpu_torch.runner import config_parser, nics, secret
from horovod_tpu_torch.runner.elastic_driver import (
    ElasticDriver,
    FixedHosts,
    HostDiscoveryScript,
    HostManager,
    run_elastic,
)
from horovod_tpu_torch.runner.hosts import (
    HostInfo,
    get_host_assignments,
    parse_hosts,
)
from horovod_tpu_torch.runner.http_server import (
    RendezvousClient,
    RendezvousServer,
)
from horovod_tpu_torch.runner.launch import (
    _args_to_env,
    build_parser,
    run_commandline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_DISCOVERY = mock.patch(
    "horovod_tpu_torch.runner.elastic_driver.DISCOVER_HOSTS_FREQUENCY_SECS",
    0.01)


def _slots(assignments):
    return [(s.hostname, s.rank, s.local_rank, s.cross_rank, s.size,
             s.local_size, s.cross_size) for s in assignments]


# ---- hosts ---------------------------------------------------------------


def test_parse_hosts():
    hosts = parse_hosts("a:4,b:2, c")
    assert [(h.hostname, h.slots) for h in hosts] == [("a", 4), ("b", 2),
                                                      ("c", 1)]


def test_host_assignments_ranks():
    slots = get_host_assignments(parse_hosts("a:2,b:2"), min_np=4)
    assert [(s.rank, s.hostname, s.local_rank, s.cross_rank)
            for s in slots] == [(0, "a", 0, 0), (1, "a", 1, 0),
                                (2, "b", 0, 1), (3, "b", 1, 1)]
    assert all(s.size == 4 for s in slots)
    assert all(s.cross_size == 2 for s in slots)


def test_host_assignments_min_np_error():
    with pytest.raises(ValueError):
        get_host_assignments(parse_hosts("a:2"), min_np=4)


def test_host_assignments_heterogeneous_cross_rank():
    slots = get_host_assignments(parse_hosts("a:1,b:2"), min_np=3)
    by = {(s.hostname, s.local_rank): s for s in slots}
    assert by[("b", 1)].cross_rank == 0
    assert by[("b", 1)].cross_size == 1
    assert by[("a", 0)].cross_rank == 0
    assert by[("b", 0)].cross_rank == 1
    assert by[("b", 0)].cross_size == 2


@pytest.mark.parametrize("spec,min_np,max_np", [
    ("a:4,b:2, c", 1, None), ("a:2,b:2", 4, None), ("a:1,b:2", 3, None),
    ("x:3,y:1,z:2", 2, 5), ("h", 1, None)])
def test_hosts_and_assignments_equal_the_reference(spec, min_np, max_np):
    mine, ref = parse_hosts(spec), jhosts.parse_hosts(spec)
    assert [(h.hostname, h.slots) for h in mine] == [
        (h.hostname, h.slots) for h in ref]
    a = get_host_assignments(mine, min_np, max_np)
    b = jhosts.get_host_assignments(ref, min_np, max_np)
    assert _slots(a) == _slots(b)
    assert [s.to_response_string() for s in a] == [
        s.to_response_string() for s in b]


# ---- rendezvous KV --------------------------------------------------------


def test_rendezvous_kv_roundtrip():
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    try:
        client = RendezvousClient("127.0.0.1", port, timeout=5)
        assert client.get("scope", "missing") is None
        client.put("scope", "k1", b"hello")
        assert client.get("scope", "k1") == b"hello"
        assert client.keys("scope") == ["k1"]
        client.put("scope", "k2", b"x" * 10000)
        assert len(client.get("scope", "k2")) == 10000
    finally:
        server.stop()


def test_rendezvous_publishes_slots():
    server = RendezvousServer("127.0.0.1")
    port = server.start()
    try:
        server.init(get_host_assignments(parse_hosts("a:2,b:2"), min_np=4))
        client = RendezvousClient("127.0.0.1", port, timeout=5)
        assert client.get("rank", "0") == b"0:0:0:4:2:2"
        assert client.get("rank", "3") == b"3:1:1:4:2:2"
    finally:
        server.stop()


def test_rendezvous_hmac_auth():
    key = secret.make_secret_key()
    server = RendezvousServer("127.0.0.1", secret=key)
    port = server.start()
    try:
        good = RendezvousClient("127.0.0.1", port, timeout=5, secret=key)
        good.put("s", "k", b"v")
        assert good.get("s", "k") == b"v"
        assert good.keys("s") == ["k"]
        anon = RendezvousClient("127.0.0.1", port, timeout=5, secret="")
        with pytest.raises(urllib.error.HTTPError) as ei:
            anon.get("s", "k")
        assert ei.value.code == 403
        wrong = RendezvousClient("127.0.0.1", port, timeout=5,
                                 secret=secret.make_secret_key())
        with pytest.raises(urllib.error.HTTPError) as ei:
            wrong.put("s", "k2", b"x")
        assert ei.value.code == 403
        assert good.get("s", "k") == b"v"
    finally:
        server.stop()


def _signed_put(port, key, path, body, ts, mod=secret):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="PUT",
        headers={
            mod.DIGEST_HEADER: mod.compute_digest(
                key, mod.signed_message("PUT", path, ts, body)),
            mod.TS_HEADER: ts,
        },
    )
    return urllib.request.urlopen(req, timeout=5).read()


def test_rendezvous_hmac_replay_rejected():
    key = secret.make_secret_key()
    server = RendezvousServer("127.0.0.1", secret=key)
    port = server.start()
    try:
        path, body = "/rounds/round_7", b"host-a,host-b"
        now = repr(time.time())
        _signed_put(port, key, path, body, now)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _signed_put(port, key, path, body, now)
        assert ei.value.code == 403
        with pytest.raises(urllib.error.HTTPError) as ei:
            _signed_put(port, key, path, body, repr(time.time() - 3600.0))
        assert ei.value.code == 403
        good = RendezvousClient("127.0.0.1", port, timeout=5, secret=key)
        good.put("rounds", "round_8", b"host-a")
        assert good.get("rounds", "round_8") == b"host-a"
    finally:
        server.stop()


@pytest.mark.parametrize("direction", ["port-client/reference-server",
                                       "reference-client/port-server"])
def test_client_and_server_of_either_package_interoperate(direction):
    """One job key, a client of one package against the other's server:
    put / get / wait / keys / delete, an unsigned request and a replayed
    PUT rejected, a polled GET allowed."""
    key = secret.make_secret_key()
    if direction.startswith("port-client"):
        server, client_cls = jhttp.RendezvousServer("127.0.0.1",
                                                    secret=key), RendezvousClient
    else:
        server, client_cls = RendezvousServer("127.0.0.1",
                                              secret=key), jhttp.RendezvousClient
    port = server.start()
    try:
        cli = client_cls("127.0.0.1", port, timeout=5, secret=key)
        assert cli.get("s", "missing") is None
        cli.put("s", "a", b"\x00\xffbin")
        cli.put("s", "b", b"2")
        assert cli.get("s", "a") == b"\x00\xffbin"
        assert cli.wait("s", "b", deadline=5) == b"2"
        assert cli.keys("s") == ["a", "b"]
        cli.delete("s", "a")
        assert cli.keys("s") == ["b"]
        assert server.scope_items("s") == {"b": b"2"}
        assert cli.server_epoch == server.epoch
        anon = client_cls("127.0.0.1", port, timeout=5, secret="")
        with pytest.raises(urllib.error.HTTPError) as ei:
            anon.get("s", "b")
        assert ei.value.code == 403
        ts = repr(time.time())
        _signed_put(port, key, "/s/r", b"v", ts)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _signed_put(port, key, "/s/r", b"v", ts, mod=jsecret)
        assert ei.value.code == 403
        ts_g = repr(time.time())
        hdr = {secret.DIGEST_HEADER: secret.compute_digest(
            key, secret.signed_message("GET", "/s/r", ts_g, b"")),
            secret.TS_HEADER: ts_g}
        for _ in range(3):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/s/r",
                                         headers=hdr)
            assert urllib.request.urlopen(req, timeout=5).read() == b"v"
    finally:
        server.stop()


@pytest.mark.parametrize("method,path,ts,body", [
    ("PUT", "/round_3/assign/h", "1700000000.25", b"1"),
    ("GET", "/_scope/elastic", "0.0", b""),
    ("DELETE", "/guard/divergent/x", "12.5", b""),
])
def test_secret_digests_equal_the_reference(method, path, ts, body):
    key = "k" * 64
    msg = secret.signed_message(method, path, ts, body)
    assert msg == jsecret.signed_message(method, path, ts, body)
    assert secret.compute_digest(key, msg) == jsecret.compute_digest(key, msg)
    assert secret.check_digest(key, msg, jsecret.compute_digest(key, msg))
    assert (secret.DIGEST_HEADER, secret.TS_HEADER, secret.ENV_SECRET) == (
        jsecret.DIGEST_HEADER, jsecret.TS_HEADER, jsecret.ENV_SECRET)


# ---- static launches ------------------------------------------------------


def test_launch_job_local_success(tmp_path):
    marker = tmp_path / "ran.txt"
    rc = api.launch_job(
        [sys.executable, "-c",
         f"import os; open(r'{marker}','w').write("
         "os.environ['HVDTPU_PROCESS_ID'])"],
        [HostInfo("localhost", 1)],
    )
    assert rc == 0
    assert marker.read_text() == "0"


def test_launch_job_failure_propagates():
    rc = api.launch_job([sys.executable, "-c", "import sys; sys.exit(3)"],
                        [HostInfo("localhost", 1)])
    assert rc == 3


def test_launch_job_env_injection(tmp_path):
    out = tmp_path / "env.txt"
    rc = api.launch_job(
        [sys.executable, "-c",
         "import os; open(r'%s','w').write("
         "os.environ['HVDTPU_RENDEZVOUS_PORT']+' '+"
         "os.environ['HVDTPU_NUM_PROCESSES']+' '+os.environ['X_EXTRA'])"
         % out],
        [HostInfo("localhost", 1)],
        extra_env={"X_EXTRA": "42"},
    )
    assert rc == 0
    port, nproc, extra = out.read_text().split()
    assert int(port) > 0 and nproc == "1" and extra == "42"


def test_launch_job_spawns_one_process_per_slot(tmp_path):
    """The port's difference: every slot is a process, with the slot's
    torch-style rank variables beside the HVDTPU_* block."""
    rc = api.launch_job(
        [sys.executable, "-c",
         "import os, json; e = os.environ; open(os.path.join(r'%s', "
         "e['RANK']), 'w').write(json.dumps([e[k] for k in ('RANK', "
         "'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE', "
         "'HVDTPU_PROCESS_ID', 'HVDTPU_NUM_PROCESSES')]))" % tmp_path],
        parse_hosts("localhost:2,127.0.0.1:2"),
    )
    assert rc == 0
    got = sorted(json.loads((tmp_path / str(r)).read_text())
                 for r in range(4))
    assert got == [[str(r), "4", str(r % 2), "2", str(r), "4"]
                   for r in range(4)]


def test_launch_job_reports_failed_host():
    failed = []
    rc = api.launch_job([sys.executable, "-c", "import sys; sys.exit(3)"],
                        [HostInfo("localhost", 1)],
                        on_host_failure=failed.append)
    assert rc == 3
    assert failed == ["localhost"]


def test_output_filename_redirects_worker_logs(tmp_path):
    rc = run_commandline(
        ["-H", "localhost:1", "--output-filename", str(tmp_path), "--",
         sys.executable, "-c",
         "import sys; print('to-out'); print('to-err', file=sys.stderr)"])
    assert rc == 0
    assert (tmp_path / "rank.0" / "stdout").read_text().strip() == "to-out"
    assert (tmp_path / "rank.0" / "stderr").read_text().strip() == "to-err"


# ---- the CLI ----------------------------------------------------------------


def test_cli_parser_flags_to_env():
    args = build_parser().parse_args(
        ["--fusion-threshold-mb", "64", "--cycle-time-ms", "2.5",
         "--no-stall-check", "--", "python", "train.py"])
    env = _args_to_env(args)
    assert env["HVDTPU_FUSION_THRESHOLD"] == str(64 * 1024 * 1024)
    assert env["HVDTPU_CYCLE_TIME"] == "2.5"
    assert env["HVDTPU_STALL_CHECK_DISABLE"] == "1"
    assert args.command[1:] == ["python", "train.py"]
    # The timeline and autotuner flags map to their knobs, as in the JAX
    # package.
    args = build_parser().parse_args(
        ["--timeline-filename", "/tmp/t.json", "--timeline-mark-cycles", "x"])
    env = _args_to_env(args)
    assert env["HVDTPU_TIMELINE"] == "/tmp/t.json"
    assert env["HVDTPU_TIMELINE_MARK_CYCLES"] == "1"
    from horovod_tpu.runner.launch import (
        _args_to_env as ref_args_to_env, build_parser as ref_parser)

    flags = ["--autotune", "--autotune-log-file", "a", "x"]
    env = _args_to_env(build_parser().parse_args(flags))
    assert env["HVDTPU_AUTOTUNE"] == "1"
    assert env["HVDTPU_AUTOTUNE_LOG"] == "a"
    ref = ref_args_to_env(ref_parser().parse_args(flags))
    assert {k: ref[k] for k in ("HVDTPU_AUTOTUNE", "HVDTPU_AUTOTUNE_LOG")} \
        == {k: env[k] for k in ("HVDTPU_AUTOTUNE", "HVDTPU_AUTOTUNE_LOG")}


def test_iface_override(monkeypatch):
    monkeypatch.delenv("HVDTPU_LOCAL_ADDR", raising=False)
    monkeypatch.setenv("HVDTPU_IFACE", "lo")
    assert api._local_addr() == "127.0.0.1"
    monkeypatch.setenv("HVDTPU_IFACE", "no-such-nic0")
    with pytest.raises(RuntimeError, match="no-such-nic0"):
        api._local_addr()
    monkeypatch.setenv("HVDTPU_LOCAL_ADDR", "10.1.2.3")
    assert api._local_addr() == "10.1.2.3"


def test_cli_network_interface_flag_to_env():
    args = build_parser().parse_args(
        ["--network-interface", "ens3", "--", "python", "train.py"])
    assert _args_to_env(args)["HVDTPU_IFACE"] == "ens3"


def test_start_timeout_flag_maps_to_env():
    args = build_parser().parse_args(
        ["--start-timeout", "90", "--log-level", "debug", "x"])
    env = _args_to_env(args)
    assert env["HVT_INIT_TIMEOUT_SECONDS"] == "90"
    assert env["HVT_LOG_LEVEL"] == "debug"


def test_cli_no_command_errors():
    assert run_commandline([]) == 2


def test_cli_static_local_run(tmp_path):
    marker = tmp_path / "cli.txt"
    rc = run_commandline(
        ["-H", "localhost:1", "--",
         sys.executable, "-c", f"open(r'{marker}','w').write('ok')"])
    assert rc == 0
    assert marker.read_text() == "ok"


def test_cli_np_trims_slots(tmp_path):
    rc = run_commandline(
        ["-np", "3", "-H", "localhost:2,127.0.0.1:2", "--", sys.executable,
         "-c", "import os; open(os.path.join(r'%s', os.environ['RANK']), "
         "'w').write(os.environ['WORLD_SIZE'])" % tmp_path])
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["0", "1", "2"]
    assert {(tmp_path / n).read_text() for n in "012"} == {"3"}


def test_check_build_flag(capsys):
    assert run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "Available Frameworks:" in out
    assert "Available Controllers:" in out
    assert "[X] PyTorch" in out
    assert "[X] gloo" in out
    assert "NCCL" in out and "nvcc" in out


WORLD_SCRIPT = """
import os, torch
import horovod_tpu_torch as hvt
from horovod_tpu_torch.ops import collectives as C
hvt.init(device="cpu", backend="gloo")
s = C.allreduce(torch.ones(4), op=C.Sum)
open(r"{out}", "a").write(f"{{hvt.rank()}}/{{hvt.size()}}/{{int(s[0])}}\\n")
hvt.shutdown()
"""


def test_cli_two_local_hosts_form_a_gloo_world(tmp_path, monkeypatch):
    """The launcher's per-slot env reaches ``context.init``: a two-host
    static launch forms a rank 0/1 gloo world over the store rank 0
    published through the KV, with no user wiring (the reference's twin
    forms its native world)."""
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("HVT_DATA_TIMEOUT_SECS", "20")
    out = tmp_path / "world.txt"
    script = tmp_path / "w.py"
    script.write_text(WORLD_SCRIPT.format(out=out))
    rc = run_commandline(["-H", "localhost:1,127.0.0.1:1", "--",
                          sys.executable, str(script)])
    assert rc == 0
    assert sorted(out.read_text().splitlines()) == ["0/2/2", "1/2/2"]


def _rank_and_sum(offset):
    """A module-level function ``run`` ships by name."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import collectives as C

    total = C.allreduce(torch.tensor([hvt.rank() + 1.0], dtype=torch.float64),
                        op=C.Sum)
    return {"rank": hvt.rank(), "sum": float(total[0]), "offset": offset}


def test_programmatic_multihost_run(monkeypatch):
    """Parity: horovod.run -- the function runs on every slot's worker and
    the results come back rank-ordered. The port pickles with the
    standard library: the function is shipped by name, so a closure is
    refused."""
    from horovod_tpu_torch.exceptions import HorovodTpuError

    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([REPO, os.path.dirname(
        os.path.abspath(__file__))]))
    monkeypatch.setenv("HVT_DATA_TIMEOUT_SECS", "20")
    results = api.run(_rank_and_sum, args=(1000,),
                      hosts="localhost:1,127.0.0.1:1", device="cpu")
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["sum"] == 3.0 for r in results)
    assert all(r["offset"] == 1000 for r in results)
    offset = 5
    with pytest.raises(HorovodTpuError, match="module level"):
        api.run(lambda: offset, hosts="localhost:1,127.0.0.1:1")


# ---- config file ------------------------------------------------------------

FULL_CONFIG = """
verbose: true
num-proc: 8
params:
  fusion-threshold-mb: 64
  cycle-time-ms: 2.5
autotune:
  enabled: true
  log-file: at.csv
timeline:
  filename: tl.json
  mark-cycles: true
stall-check:
  enabled: false
  warning-time-seconds: 120
elastic:
  min-np: 2
  max-np: 8
"""


class TestConfigFile:
    def _write(self, tmp_path, text):
        p = tmp_path / "cfg.yaml"
        p.write_text(text)
        return str(p)

    def test_sections_map_to_args(self, tmp_path):
        v = config_parser.read_config_file(self._write(tmp_path, FULL_CONFIG))
        assert v["verbose"] is True
        assert v["num_proc"] == 8
        assert v["fusion_threshold_mb"] == 64
        assert v["cycle_time_ms"] == 2.5
        assert v["autotune"] is True
        assert v["autotune_log_file"] == "at.csv"
        assert v["timeline_filename"] == "tl.json"
        assert v["timeline_mark_cycles"] is True
        assert v["no_stall_check"] is True
        assert v["stall_warning_time_seconds"] == 120
        assert (v["min_np"], v["max_np"]) == (2, 8)

    def test_cli_flags_win_over_file(self, tmp_path):
        path = self._write(
            tmp_path, "params:\n  fusion-threshold-mb: 64\n"
            "  cycle-time-ms: 2.5\n")
        parser = build_parser()
        args = parser.parse_args(
            ["--config-file", path, "--fusion-threshold-mb", "128", "x"])
        config_parser.apply_config_file(args, parser)
        assert args.fusion_threshold_mb == 128
        assert args.cycle_time_ms == 2.5

    def test_non_mapping_rejected(self, tmp_path):
        path = self._write(tmp_path, "- just\n- a\n- list\n")
        with pytest.raises(ValueError, match="mapping"):
            config_parser.read_config_file(path)

    def test_unknown_keys_rejected(self, tmp_path):
        path = self._write(tmp_path,
                           "params:\n  fusion-threshold: 64\nmin-np: 2\n")
        with pytest.raises(ValueError, match="fusion-threshold"):
            config_parser.read_config_file(path)

    def test_quoted_numbers_coerced(self, tmp_path):
        path = self._write(
            tmp_path, 'num-proc: "8"\nparams:\n  fusion-threshold-mb: "64"\n')
        parser = build_parser()
        args = parser.parse_args(["--config-file", path, "x"])
        config_parser.apply_config_file(args, parser)
        assert args.num_proc == 8
        assert args.fusion_threshold_mb == 64

    def test_empty_section_tolerated(self, tmp_path):
        path = self._write(tmp_path, "params:\nverbose: true\n")
        assert config_parser.read_config_file(path)["verbose"] is True

    @pytest.mark.parametrize("text", [
        FULL_CONFIG, "params:\nverbose: true\n",
        'num-proc: "8"\nparams:\n  fusion-threshold-mb: "64"\n',
        "elastic:\n  reset-limit: 3\n  host-discovery-script: d.sh\n"])
    def test_values_and_overlay_equal_the_reference(self, tmp_path, text):
        from horovod_tpu.runner.launch import build_parser as jbuild

        path = self._write(tmp_path, text)
        assert config_parser.read_config_file(path) == \
            jconfig.read_config_file(path)
        argv = ["--config-file", path, "--cycle-time-ms", "9", "x"]
        mine, ref = build_parser(), jbuild()
        a, b = mine.parse_args(argv), ref.parse_args(argv)
        config_parser.apply_config_file(a, mine)
        jconfig.apply_config_file(b, ref)
        assert vars(a) == vars(b)


# ---- elastic driver (reference test_elastic_driver.py patterns) --------------


def test_host_manager_blacklist():
    mgr = HostManager(FixedHosts({"a": 2, "b": 2}))
    mgr.update_available_hosts()
    assert mgr.current_hosts == {"a": 2, "b": 2}
    mgr.blacklist("a")
    mgr.update_available_hosts()
    assert mgr.current_hosts == {"b": 2}
    assert mgr.is_blacklisted("a")
    assert mgr.blacklist_events == 1


def test_host_manager_change_detection():
    disc = FixedHosts({"a": 2})
    mgr = HostManager(disc)
    assert mgr.update_available_hosts() is True
    assert mgr.update_available_hosts() is False
    disc.set({"a": 2, "b": 2})
    assert mgr.update_available_hosts() is True


def test_discovery_script(tmp_path):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho host-a:4\necho host-b:4\n")
    script.chmod(0o755)
    disc = HostDiscoveryScript(str(script))
    assert disc.find_available_hosts_and_slots() == {"host-a": 4,
                                                     "host-b": 4}


@FAST_DISCOVERY
def test_elastic_driver_membership_updates():
    disc = FixedHosts({"a": 2})
    driver = ElasticDriver(disc, min_np=1)
    driver.start()
    try:
        assert driver.wait_for_available_slots(1, timeout=5) == {"a": 2}
        disc.set({"a": 2, "b": 2})
        assert driver.wait_for_available_slots(4, timeout=5) == {"a": 2,
                                                                 "b": 2}
    finally:
        driver.stop()


@FAST_DISCOVERY
def test_run_elastic_retries_then_succeeds():
    calls = []

    def fake_launcher(command, hosts, extra_env=None):
        calls.append([h.hostname for h in hosts])
        return 1 if len(calls) < 3 else 0

    rc = run_elastic(["train"], discovery=FixedHosts({"a": 1}), min_np=1,
                     reset_limit=10, launcher=fake_launcher)
    assert rc == 0
    assert len(calls) == 3


@FAST_DISCOVERY
def test_run_elastic_reset_limit():
    rc = run_elastic(["train"], discovery=FixedHosts({"a": 1}), min_np=1,
                     reset_limit=2, launcher=lambda c, h, extra_env=None: 7)
    assert rc == 7


@FAST_DISCOVERY
def test_run_elastic_blacklists_failed_host():
    disc = FixedHosts({"bad-host": 1, "good-host": 1})
    seen_worlds = []

    def fake_launcher(command, hosts, extra_env=None, on_host_failure=None):
        names = sorted(h.hostname for h in hosts)
        seen_worlds.append(names)
        if "bad-host" in names:
            on_host_failure("bad-host")
            return 1
        return 0

    rc = run_elastic(["train"], discovery=disc, min_np=1, reset_limit=10,
                     launcher=fake_launcher)
    assert rc == 0
    assert "bad-host" in seen_worlds[0]
    assert seen_worlds[-1] == ["good-host"]


def test_worker_notification_manager():
    from horovod_tpu_torch.elastic.worker import WorkerNotificationManager

    server = RendezvousServer("127.0.0.1")
    port = server.start()
    try:
        with mock.patch.dict(os.environ, {
                "HVDTPU_ELASTIC": "1",
                "HVDTPU_RENDEZVOUS_ADDR": "127.0.0.1",
                "HVDTPU_RENDEZVOUS_PORT": str(port),
                "HVDTPU_ELASTIC_POLL_SECS": "0.05"}):
            mgr = WorkerNotificationManager()
            assert mgr.init() is True

            class FakeState:
                def __init__(self):
                    self.events = []

                def on_hosts_updated(self, ts, res):
                    self.events.append(ts)

            st = FakeState()
            mgr.register_listener(st)
            server.put("elastic", "ts", b"123.5")
            deadline = time.time() + 5
            while not st.events and time.time() < deadline:
                time.sleep(0.02)
            assert st.events == [123.5]
            time.sleep(0.2)
            assert st.events == [123.5]
            mgr.stop()
    finally:
        server.stop()


# ---- NIC auto-discovery ------------------------------------------------------

NIC_TABLES = [
    [{"eth0": "10.0.0.1", "eth1": "192.168.1.1", "docker0": "172.17.0.1"},
     {"eth0": "10.0.0.2", "eth1": "192.168.9.2"},
     {"eth0": "10.0.0.3", "wlan0": "192.168.2.3"}],
    [{"zz0": "1.1.1.1", "ens3": "10.0.0.1"},
     {"zz0": "1.1.1.2", "ens3": "10.0.0.2"}],
    [{"eth0": "10.0.0.1"}, {"ib0": "10.1.0.2"}],
    [],
    [{"ib0": "1", "bond0": "2", "enp1s0": "3"}, {"bond0": "4", "ib0": "5"}],
]


def test_nics_choose_common_intersection():
    assert nics.choose_common(NIC_TABLES[0]) == "eth0"
    assert nics.choose_common(NIC_TABLES[1]) == "ens3"
    assert nics.choose_common(NIC_TABLES[2]) == ""
    assert nics.choose_common([]) == ""


@pytest.mark.parametrize("i", range(len(NIC_TABLES)))
def test_nics_choose_common_equals_the_reference(i):
    assert nics.choose_common(NIC_TABLES[i]) == jnics.choose_common(
        NIC_TABLES[i])


def test_nics_list_interfaces_excludes_loopback():
    table = nics.list_interfaces()
    assert "lo" not in table
    for addr in table.values():
        assert not addr.startswith("127.")


def test_nics_driver_worker_kv_roundtrip(monkeypatch):
    server = RendezvousServer(secret="s3")
    port = server.start()
    try:
        tables = {"0": {"eth0": "10.0.0.1", "eth1": "192.168.0.1"},
                  "1": {"eth0": "10.0.0.2", "docker0": "172.17.0.1"}}
        adopted = {}
        envs = {pid: {nics.ENV_AUTOPROBE: "1", "HVDTPU_PROCESS_ID": pid}
                for pid in tables}
        table_for_thread = {}
        monkeypatch.setattr(nics, "list_interfaces",
                            lambda: table_for_thread[threading.get_ident()])

        def worker(pid):
            table_for_thread[threading.get_ident()] = tables[pid]
            client = RendezvousClient("127.0.0.1", port, secret="s3")
            adopted[pid] = nics.worker_report_and_adopt(
                client, deadline_secs=20, env=envs[pid])

        t0 = threading.Thread(target=worker, args=("0",))
        t0.start()
        time.sleep(0.3)
        t1 = threading.Thread(target=worker, args=("1",))
        t1.start()
        chosen = nics.driver_autoprobe(server, n_procs=2, deadline_secs=20)
        t0.join(timeout=30)
        t1.join(timeout=30)
        assert chosen == "eth0"
        assert adopted == {"0": "eth0", "1": "eth0"}
        assert envs["0"][nics.ENV_IFACE] == "eth0"
        assert envs["1"][nics.ENV_IFACE] == "eth0"
    finally:
        server.stop()


def test_nics_partial_reports_publish_empty_fallback():
    server = RendezvousServer(secret="s4")
    port = server.start()
    try:
        client = RendezvousClient("127.0.0.1", port, secret="s4")
        client.put(nics.SCOPE, f"{nics.REPORT_PREFIX}0",
                   json.dumps({"eth0": "10.0.0.1"}).encode())
        chosen = nics.driver_autoprobe(server, n_procs=2, deadline_secs=0.5)
        assert chosen == ""
        assert server.scope_items(nics.SCOPE)[nics.CHOSEN_KEY] == b""
    finally:
        server.stop()


def test_nics_manual_override_and_disabled(monkeypatch):
    monkeypatch.delenv(nics.ENV_AUTOPROBE, raising=False)
    assert nics.worker_report_and_adopt(client=None) is None
    monkeypatch.setenv(nics.ENV_AUTOPROBE, "1")
    monkeypatch.setenv(nics.ENV_IFACE, "ethX")
    assert nics.worker_report_and_adopt(client=None) == "ethX"


def test_launch_job_autoprobe_gating(monkeypatch):
    captured = []

    class FakeJob:
        def __init__(self, hostname, cmd, env, output_dir=None, rank=0):
            self.hostname = hostname
            captured.append(env)

        def poll(self):
            return 0

        def terminate(self):
            pass

    monkeypatch.setattr(api, "_Job", FakeJob)
    hosts = parse_hosts("localhost:1,127.0.0.1:1")
    assert api.launch_job(["true"], hosts, poll_interval=0.01) == 0
    assert all("HVDTPU_NIC_AUTOPROBE" not in env for env in captured)
    assert all(env["HVDTPU_LOCAL_ADDR"] == "127.0.0.1" for env in captured)
    captured.clear()
    remote = parse_hosts("nodeA:1,nodeB:1")
    assert api.launch_job(["true"], remote, poll_interval=0.01) == 0
    assert all(env.get("HVDTPU_NIC_AUTOPROBE") == "1" for env in captured)
    captured.clear()
    monkeypatch.setenv("HVDTPU_IFACE", "lo")
    assert api.launch_job(["true"], remote, poll_interval=0.01) == 0
    assert all("HVDTPU_NIC_AUTOPROBE" not in env for env in captured)
