"""The port's Ray integration (horovod_tpu_torch.ray) held against the JAX
package's (horovod_tpu.ray), on the CPU, without a Ray cluster.

Twins of ``tests/test_ray.py``: the coordinator's rank topology (the
port's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` equal
to the reference's ``HVT_RANK``/``HVT_SIZE``/``HVT_LOCAL_RANK``/
``HVT_LOCAL_SIZE`` on the same registrations, the ``HVDTPU_*`` block the
same), the rendezvous round trip -- here carried through: two ranks
started with the coordinator's environment form the world with
``horovod_tpu_torch.init`` and ``native.init`` -- node-table discovery
with the ``GPU`` resource where the reference counts ``TPU``, the no-ray
errors and the elastic executor's retries. Exact comparisons throughout.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import pytest

import horovod_tpu.ray as jray
from horovod_tpu_torch import ray as tray
from horovod_tpu_torch.runner.api import (
    ENV_COORDINATOR,
    ENV_HOSTNAMES,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ENV_RENDEZVOUS_ADDR,
    ENV_RENDEZVOUS_PORT,
)
from horovod_tpu_torch.runner.elastic_driver import FixedHosts

import torch_spark_ranks as R

TESTS = os.path.dirname(os.path.abspath(__file__))
PORT_OF_REF = {"RANK": "HVT_RANK", "WORLD_SIZE": "HVT_SIZE",
               "LOCAL_RANK": "HVT_LOCAL_RANK",
               "LOCAL_WORLD_SIZE": "HVT_LOCAL_SIZE"}


@pytest.mark.parametrize("hosts", [
    ["a", "a", "b", "b"], ["a", "b", "a", "b"], ["h1"], ["x", "y", "y", "z"],
])
def test_coordinator_topology_is_the_references(hosts):
    t, j = tray.Coordinator(), jray.Coordinator()
    for rank, host in enumerate(hosts):
        t.register(host, rank)
        j.register(host, rank)
    assert (t.world_size, t.hoststring) == (j.world_size, j.hoststring)
    got, want = t.finalize_registration(), j.finalize_registration()
    assert set(got) == set(want) == set(range(len(hosts)))
    for r in got:
        for port_key, ref_key in PORT_OF_REF.items():
            assert got[r][port_key] == want[r][ref_key], (r, port_key)
        for key in (ENV_COORDINATOR, ENV_PROCESS_ID, ENV_NUM_PROCESSES,
                    ENV_HOSTNAMES):
            assert got[r][key] == want[r][key], (r, key)
        assert got[r][ENV_PROCESS_ID] == got[r]["RANK"]
        assert not any(k.startswith("HVT_") for k in got[r])


def test_register_and_topology():
    c = tray.Coordinator()
    for rank, host in enumerate(["a", "a", "b", "b"]):
        c.register(host, rank)
    assert c.world_size == 4
    assert c.hoststring == "a:2,b:2"
    env = c.finalize_registration()
    assert [env[r]["RANK"] for r in range(4)] == ["0", "1", "2", "3"]
    assert [env[r]["LOCAL_RANK"] for r in range(4)] == ["0", "1", "0", "1"]
    for e in env.values():
        assert e["WORLD_SIZE"] == "4" and e["LOCAL_WORLD_SIZE"] == "2"
        assert e[ENV_COORDINATOR] == "a"
        assert e[ENV_NUM_PROCESSES] == "4"


def test_rendezvous_round_trip_forms_the_world(tmp_path):
    """Two ranks started with ``establish_rendezvous`` + the coordinator's
    per-rank env form one world: the torch.distributed group
    (``horovod_tpu_torch.init``) and the runtime (``native.init``) both
    over the driver's KV, and one collective on each sums the ranks."""
    c = tray.Coordinator()
    c.register("localhost", 0)
    c.register("localhost", 1)
    env_by_rank = c.finalize_registration()
    rdv = c.establish_rendezvous()
    try:
        assert int(rdv[ENV_RENDEZVOUS_PORT]) > 0 and rdv[ENV_RENDEZVOUS_ADDR]
        procs = []
        for r in range(2):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("HVT_", "HVDTPU_", "RANK",
                                        "WORLD_SIZE", "LOCAL_", "MASTER_"))}
            env.update(rdv, **env_by_rank[r], PYTHONPATH=R.REPO,
                       OMP_NUM_THREADS="1", HVT_DATA_TIMEOUT_SECS="60")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "torch_spark_ranks.py"),
                 "coordinator_rank", str(tmp_path / f"r{r}.json")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        outs = [p.communicate(timeout=180)[0].decode(errors="replace")
                for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-3000:]
    finally:
        c.shutdown()
    recs = [json.loads((tmp_path / f"r{r}.json").read_text())
            for r in range(2)]
    for r, rec in enumerate(recs):
        assert (rec["rank"], rec["size"]) == (r, 2)
        assert (rec["native_rank"], rec["native_size"]) == (r, 2)
        assert rec["local_rank"] == r
        assert rec["dist_sum"] == [3.0] * 3 and rec["rt_sum"] == [3.0] * 2
    assert c.rendezvous is None


def _node(host, alive=True, **resources):
    return {"Alive": alive, "NodeManagerHostname": host,
            "Resources": resources}


def _tpu_table(nodes):
    """The same node table with each GPU count under the reference's
    TPU resource."""
    return [dict(n, Resources={("TPU" if k == "GPU" else k): v
                               for k, v in n["Resources"].items()})
            for n in nodes]


@pytest.mark.parametrize("case", ["preferred", "divisors", "cpu_only"])
def test_discovery_counts_gpus_as_the_reference_counts_tpus(case):
    nodes = [_node("g1", GPU=4, CPU=96), _node("c1", CPU=8),
             _node("dead", alive=False, GPU=4), _node("g2", GPU=8, CPU=9),
             {"Alive": True, "NodeManagerAddress": "10.0.0.5",
              "Resources": {"GPU": 2}}]
    kw, jkw, want = {
        "preferred": ({}, {}, {"g1": 4, "c1": 8, "g2": 8, "10.0.0.5": 2}),
        "divisors": ({"gpus_per_slot": 4, "cpus_per_slot": 2},
                     {"tpus_per_slot": 4, "cpus_per_slot": 2},
                     {"g1": 1, "c1": 4, "g2": 2}),
        "cpu_only": ({"use_gpu": False}, {"use_tpu": False},
                     {"g1": 96, "c1": 8, "g2": 9}),
    }[case]
    got = tray.RayHostDiscovery.hosts_from_nodes(nodes, **kw)
    assert got == want
    assert got == jray.RayHostDiscovery.hosts_from_nodes(_tpu_table(nodes),
                                                         **jkw)


def test_without_ray_every_placement_raises_cleanly():
    if tray.ray_available():
        pytest.skip("ray installed: covers the no-ray path")
    ex = tray.RayExecutor(tray.RaySettings(), num_workers=2)
    with pytest.raises(ImportError, match="ray"):
        ex.start()
    for call in (ex.execute, ex.run, ex.execute_single):
        with pytest.raises(ImportError, match="ray"):
            call(lambda *_: 0)
    with pytest.raises(ImportError, match="ray"):
        tray.RayHostDiscovery().find_available_hosts_and_slots()
    with pytest.raises(ImportError, match="ray"):
        tray.NodeColocator(node_rank=0, num_slots=1,
                           world_size=1).create_workers()
    ex.shutdown()  # nothing placed: a no-op


def test_executor_settings():
    with pytest.raises(ValueError, match="num_workers"):
        tray.RayExecutor()
    ex = tray.RayExecutor(num_hosts=3, num_workers_per_host=2, use_gpu=True)
    assert ex.num_workers == 6 and ex.settings.gpus_per_worker == 1
    assert tray.RayExecutor(num_workers=2).settings.gpus_per_worker == 0


def test_elastic_settings_factory():
    s = tray.ElasticRayExecutor.create_settings(min_np=2, max_np=4,
                                                reset_limit=3)
    assert (s.min_np, s.max_np, s.reset_limit) == (2, 4, 3)
    ex = tray.ElasticRayExecutor(s)
    assert isinstance(ex.discovery, tray.RayHostDiscovery)
    assert (ex.min_np, ex.max_np, ex.reset_limit) == (2, 4, 3)


@pytest.mark.parametrize("side", ["port", "ref"])
def test_elastic_retries_then_succeeds(side):
    mod = tray if side == "port" else jray
    s = mod.ElasticRayExecutor.create_settings(min_np=1, reset_limit=5)
    ex = mod.ElasticRayExecutor(s, discovery=FixedHosts({"h1": 2}))
    calls = []

    def fake_launch(hosts_map, worker_fn):
        calls.append(dict(hosts_map))
        if len(calls) < 3:
            raise RuntimeError("worker died")
        return [worker_fn() for _ in range(sum(hosts_map.values()))]

    ex.start()
    try:
        with mock.patch.object(ex, "_launch_world", fake_launch):
            out = ex.run(lambda: 42)
    finally:
        ex.shutdown()
    assert out == [42, 42]
    assert calls == [{"h1": 2}] * 3


def test_elastic_reset_limit():
    s = tray.ElasticRayExecutor.create_settings(min_np=1, reset_limit=2)
    ex = tray.ElasticRayExecutor(s, discovery=FixedHosts({"h1": 1}))
    ex.start()
    try:
        with mock.patch.object(ex, "_launch_world",
                               side_effect=RuntimeError("worker died")) as m:
            with pytest.raises(RuntimeError, match="died"):
                ex.run(lambda: 0)
        assert m.call_count == 2
    finally:
        ex.shutdown()
    assert ex.driver is None
