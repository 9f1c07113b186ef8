"""chaos_soak -- scripted fault schedules over the port's elastic launcher.

The port of the JAX package's ``tools/chaos_soak.py`` (and of its test
harness, ``tests/elastic_harness.py``: :func:`run_elastic_scenario`).
Each training scenario runs a small deterministic elastic job -- gloo
worlds of CPU processes, one per loopback "host" (``localhost``,
``127.0.0.1``, ...) -- whose per-step update is a pure function of the
step number, so the final parameters are world-size- and
restart-invariant, under one armed ``HVDTPU_CHAOS`` schedule, and
:func:`check_invariants` asserts the recovery invariants:

* the job finishes rc=0 without human intervention;
* every finishing rank reaches exactly the target step count;
* the final parameters equal the analytic fault-free value bit for bit
  (no step lost, none applied twice);
* scenario-specific evidence that the fault fired and the intended
  recovery path absorbed it.

===================  ====================================================
``crash``            a worker hard-exits mid-commit -> the survivor's
                     collective raises ``HorovodInternalError``, the
                     driver blacklists and republishes, the survivor
                     restores its last commit and rejoins
``hang``             a worker freezes (heartbeat included) -> lease
                     expiry kills and blacklists it mid-round
``kv_outage``        every 3rd KV request fails -> client retries and
                     guarded polling absorb it; nobody restarts
``ckpt``             the newest checkpoint is bit-rotted and the only
                     worker dies -> the restore quarantines it and falls
                     back a step; the blacklist cooldown re-admits the
                     host
``straggler``        one rank is slow every step -> the job completes
                     with no false failure
``preempt``          a real SIGTERM eviction notice -> priority
                     checkpoint, drain through a shrunken round,
                     departed, never blacklisted
``kv_server_crash``  the KV listener is torn down hard (repeatedly) and
                     re-listened from the journal -> zero restarts
``driver_crash``     the driver dies in round 2; an ``adopt=True``
                     driver replays the journal, re-attaches the live
                     workers by pid and finishes the job
``serve``            a KV-transport serving worker is hard-killed
                     mid-flight -> its leases re-queue (zero dropped),
                     the host respawns from probation
``decode``           a token-level decode worker is killed
                     mid-sequence -> its streams resume on the survivor,
                     token-identical to the fault-free run
===================  ====================================================

Not ported yet: ``quant`` and ``silent`` (A13c), ``stream`` and
``autotune`` (A14). Every scenario runs under a hard wall-clock
deadline; on timeout the harness records log tails and the KV plane's
round state and tears the wedged job down instead of hanging.

Usage::

    python -m horovod_tpu_torch.tools.chaos_soak            # all scenarios
    python -m horovod_tpu_torch.tools.chaos_soak --scenario crash --steps 6
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import stat
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_STEPS = 8
LEARNING_RATE = 0.1
GRAD = 0.5  # allreduce(full(0.5)) / size == 0.5 at any world size

# The harness's speed-ups over the launcher's own settings: fast
# notification polls (1 s by default), a short data-plane timeout (a dead
# peer fails the survivors' collectives fast; 300 s by default) and a
# 0.1 s host discovery interval in the driver (1 s by default). The tests
# run with them; ``fast=False`` runs a job as ``hvdtpu-run-torch`` would.
FAST_ENV = {
    "HVDTPU_ELASTIC_POLL_SECS": "0.1",
    "HVT_DATA_TIMEOUT_SECS": "10",
}
FAST_DISCOVERY_SECS = 0.1

# The env every scenario's workers get: the speed-ups and the repository
# importable.
BASE_ENV = dict(FAST_ENV, PYTHONPATH=REPO, PYTHONUNBUFFERED="1",
                OMP_NUM_THREADS="1")


def _base_env(workdir: str, fast: bool) -> Dict[str, str]:
    env = {k: v for k, v in BASE_ENV.items() if fast or k not in FAST_ENV}
    env["HVDTPU_TEST_WORKDIR"] = workdir
    return env


def _discovery_interval(ed, fast: bool):
    """The driver's discovery interval cut to FAST_DISCOVERY_SECS, or left
    at its own when not ``fast``."""
    if not fast:
        return contextlib.nullcontext()
    return mock.patch.object(ed, "DISCOVER_HOSTS_FREQUENCY_SECS",
                             FAST_DISCOVERY_SECS)


# ---- the harness (tests/elastic_harness.py's twin) ------------------------

# Worker-script preamble giving every scenario log()/set_hosts() plus the
# workdir/host identity env contract.
WORKER_PRELUDE = '''
import json, os, sys, time
import numpy as np
import torch

torch.set_num_threads(1)
workdir = os.environ["HVDTPU_TEST_WORKDIR"]
host_id = os.environ["HVDTPU_HOST_ID"]


def log(rec):
    with open(os.path.join(workdir, "progress.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\\n")


def set_hosts(lines):
    tmp = os.path.join(workdir, "hosts.txt.tmp")
    with open(tmp, "w") as f:
        f.write("\\n".join(lines) + "\\n")
    os.replace(tmp, os.path.join(workdir, "hosts.txt"))
'''


def _write_discovery(workdir: str, hosts: List[str]) -> str:
    with open(os.path.join(workdir, "hosts.txt"), "w") as f:
        f.write("\n".join(hosts) + "\n")
    disco = os.path.join(workdir, "discover.sh")
    with open(disco, "w") as f:
        f.write(f"#!/bin/sh\ncat {workdir}/hosts.txt\n")
    os.chmod(disco, os.stat(disco).st_mode | stat.S_IEXEC)
    return disco


def read_records(workdir: str) -> List[dict]:
    """The workers' ``progress.jsonl`` records (a torn last line, left by
    a crash, is skipped)."""
    records: List[dict] = []
    progress = os.path.join(workdir, "progress.jsonl")
    if os.path.exists(progress):
        with open(progress) as f:
            for line in f:
                try:
                    records.append(json.loads(line))
                except ValueError:
                    pass
    return records


def run_elastic_scenario(
    workdir: str,
    worker_body: str,
    *,
    initial_hosts: List[str],
    extra_env: Optional[Dict[str, str]] = None,
    driver_env: Optional[Dict[str, str]] = None,
    timeout: float = 180.0,
    reset_limit: int = 10,
    chaos: Optional[str] = None,
    chaos_seed: int = 0,
    drain_timeout: float = 15.0,
    job_ref: Optional[dict] = None,
    min_np: int = 1,
    journal_dir: Optional[str] = None,
    fast: bool = True,
) -> Tuple[Optional[int], List[dict]]:
    """Run ``WORKER_PRELUDE + worker_body`` under the elastic launcher
    (``run_elastic`` on a thread, discovery from a ``hosts.txt`` the
    workers may rewrite). ``chaos`` arms a schedule in every worker;
    ``driver_env`` reaches the in-process driver; below ``min_np`` slots
    the driver holds the round until discovery brings hosts back;
    ``journal_dir`` makes the control plane durable; ``fast=False`` drops
    the speed-ups (:data:`FAST_ENV`, :data:`FAST_DISCOVERY_SECS`).
    Returns ``(rc, progress_records)``; raises AssertionError when the job outlives
    ``timeout`` (after tearing it down) or the driver raised."""
    from ..runner import elastic_driver as ed

    disco = _write_discovery(workdir, initial_hosts)
    worker_py = os.path.join(workdir, "worker.py")
    with open(worker_py, "w") as f:
        f.write(WORKER_PRELUDE + worker_body)
    env = _base_env(workdir, fast)
    env.update(extra_env or {})
    if chaos is not None:
        env["HVDTPU_CHAOS"] = chaos
        env["HVDTPU_CHAOS_SEED"] = str(chaos_seed)
    result: dict = {}
    job_ref = {} if job_ref is None else job_ref

    def _run():
        try:
            with mock.patch.dict(os.environ, driver_env or {}), \
                    _discovery_interval(ed, fast):
                result["rc"] = ed.run_elastic(
                    [sys.executable, worker_py],
                    discovery_script=disco,
                    min_np=min_np,
                    reset_limit=reset_limit,
                    extra_env=env,
                    verbose=True,
                    output_dir=os.path.join(workdir, "logs"),
                    drain_timeout=drain_timeout,
                    job_ref=job_ref,
                    journal_dir=journal_dir,
                )
        except BaseException as exc:  # surface driver bugs, not rc=None
            result["exc"] = exc

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    t.join(timeout=timeout)
    if t.is_alive():
        diag = timeout_diagnostics(workdir, job_ref.get("job"))
        teardown_job(job_ref.get("job"))
        t.join(timeout=10.0)
        raise AssertionError(
            f"elastic job did not finish in {timeout:.0f}s: "
            f"{json.dumps(diag)[:4000]}")
    if "exc" in result:
        raise AssertionError(
            f"elastic driver raised: {result['exc']!r}"
        ) from result["exc"]
    return result.get("rc"), read_records(workdir)


def timeout_diagnostics(workdir: str, job=None, tail_bytes: int = 3000):
    """Evidence for a blown deadline: each worker log's tail and the KV
    plane's round, heartbeat and guard state."""
    diag: dict = {"logs": {}, "kv": {}}
    logs = os.path.join(workdir, "logs")
    if os.path.isdir(logs):
        for rank_dir in sorted(os.listdir(logs)):
            for stream in ("stdout", "stderr"):
                path = os.path.join(logs, rank_dir, stream)
                try:
                    with open(path, "rb") as f:
                        f.seek(0, os.SEEK_END)
                        f.seek(max(0, f.tell() - tail_bytes))
                        diag["logs"][f"{rank_dir}/{stream}"] = f.read(
                        ).decode(errors="replace")
                except OSError:
                    pass
    if job is not None and getattr(job.server, "_server", None) is not None:
        for scope in ("elastic", "heartbeat", "guard", "preempt", "exit"):
            diag["kv"][scope] = {
                k: v.decode(errors="replace")
                for k, v in job.server.scope_items(scope).items()}
        diag["round"] = job._round
        diag["procs"] = sorted(job._procs)
    return diag


def teardown_job(job) -> None:
    """Kill a wedged job's workers and stop its driver and KV server."""
    if job is None:
        return
    try:
        job._terminate_all()
    except Exception:  # noqa: BLE001 - best effort on a wedged job
        pass
    try:
        job.driver.stop()
        job.server.stop()
    except Exception:  # noqa: BLE001
        pass


# ---- the analytic training worker ----------------------------------------

# Per-step update is a pure function of the step, checkpointed every step
# by rank 0, resumable from disk when a full restart loses in-memory
# state. Every rank exits at the target step (the blocking collectives
# keep them in lockstep).
WORKER = '''
import horovod_tpu_torch as hvt
from horovod_tpu_torch import checkpoint as ckptlib
from horovod_tpu_torch import elastic
from horovod_tpu_torch.elastic import worker as _ew
from horovod_tpu_torch.ops import collectives as C

STEPS = int(os.environ["HVDTPU_TEST_SOAK_STEPS"])
CKDIR = os.path.join(workdir, "ckpt")

hvt.init(device="cpu", backend="gloo")
state = elastic.ObjectState(step=0, w=torch.zeros(4, dtype=torch.float64))
try:
    target = {"step": torch.tensor(0), "w": torch.zeros(4, dtype=torch.float64)}
    restored = ckptlib.restore_checkpoint(CKDIR, target)
    state.step = int(restored["step"])
    state.w = restored["w"]
    state.save()
    log({"host": host_id, "resumed_at": state.step})
except FileNotFoundError:
    pass


def _priority_ckpt():
    ckptlib.priority_checkpoint(
        os.path.join(workdir, "preempt_ckpt"),
        {"step": torch.tensor(state.step), "w": state.w.clone()},
        step=int(state.step),
    )
    log({"host": host_id, "preempt_ckpt": int(state.step)})


# Preemption grace: the first commit after a SIGTERM notice writes a
# manifest-verified priority checkpoint of THIS worker's state.
_ew.register_preempt_callback(_priority_ckpt)


@elastic.run
def train(st):
    while st.step < STEPS:
        g = C.allreduce(torch.full((4,), %(grad)r), op=C.Sum)
        st.w = st.w - %(lr)r * (g.double() / hvt.size())
        st.step += 1
        if hvt.rank() == 0:
            ckptlib.save_checkpoint(
                CKDIR, {"step": torch.tensor(st.step), "w": st.w.clone()},
                step=st.step, keep=STEPS + 1,
            )
        log({"host": host_id, "rank": hvt.rank(), "size": hvt.size(),
             "step": st.step})
        st.commit()
    return st.step


train(state)
from horovod_tpu_torch import chaos as _chaos

log({"host": host_id, "rank": hvt.rank(), "final_step": state.step,
     "final_w": [float(x) for x in state.w], "fired": dict(_chaos.fired)})
hvt.shutdown()
''' % {"grad": GRAD, "lr": LEARNING_RATE}


def _scenarios(steps: int) -> Dict[str, dict]:
    mid = max(2, steps // 2)
    two = ["localhost:1", "127.0.0.1:1"]
    return {
        "baseline": {"hosts": two, "chaos": None, "env": {}},
        "crash": {
            "hosts": two,
            "chaos": f"worker.step:crash@step={mid};host=127.0.0.1;spawn=0",
            "env": {},
        },
        "hang": {
            "hosts": two,
            "chaos": f"worker.step:hang@step={mid};host=127.0.0.1;spawn=0",
            # A tight lease, so expiry (not the drain deadline) catches
            # the frozen worker; the survivor's collective times out.
            "env": {"HVDTPU_HEARTBEAT_SECS": "0.2",
                    "HVDTPU_HEARTBEAT_TIMEOUT_SECS": "2.0",
                    "HVT_DATA_TIMEOUT_SECS": "6"},
        },
        "kv_outage": {
            "hosts": two,
            # Every 3rd KV request fails at every worker: retries and
            # guarded polling must absorb it -- no restarts.
            "chaos": "kv.request:drop@every=3;n=60",
            "env": {},
        },
        "ckpt": {
            "hosts": ["localhost:1"],
            "chaos": (f"ckpt.write:corrupt@step={mid};spawn=0,"
                      f"worker.step:crash@step={mid};spawn=0"),
            "env": {"HVDTPU_BLACKLIST_COOLDOWN": "1.0"},
        },
        "straggler": {
            "hosts": two,
            "chaos": "worker.step:slow=0.25@host=127.0.0.1",
            "env": {},
        },
        "preempt": {
            "hosts": two,
            # SIGTERM at the victim's 2nd commit, every commit paced
            # 0.3 s: the shrink round lands with steps to spare.
            "chaos": ("worker.step:slow=0.3,"
                      "worker.preempt:sigterm@step=2;host=127.0.0.1;spawn=0"),
            "env": {},
        },
        "kv_server_crash": {
            "hosts": two,
            "chaos": "worker.step:slow=0.1",
            "driver_chaos": "kv.server:restart@after=3;every=3;n=3",
            "journal": True,
            "env": {},
        },
    }


SCENARIO_NAMES = [n for n in _scenarios(DEFAULT_STEPS) if n != "baseline"] + [
    "serve", "decode", "driver_crash"]


def run_scenario(name: str, steps: int = DEFAULT_STEPS,
                 workdir: Optional[str] = None, timeout: float = 120.0,
                 seed: int = 0) -> dict:
    """Run one scenario; returns a result dict (no assertions -- the
    caller checks it with :func:`check_invariants`)."""
    from .. import chaos as _chaos

    if name in ("serve", "serve_baseline"):
        return run_serve_scenario(name, workdir=workdir, timeout=timeout,
                                  seed=seed)
    if name in ("decode", "decode_baseline"):
        return run_decode_scenario(name, timeout=timeout, seed=seed)
    if name == "driver_crash":
        return run_driver_crash_scenario(steps=steps, workdir=workdir,
                                         timeout=timeout, seed=seed)
    spec = _scenarios(steps).get(name)
    if spec is None:
        raise ValueError(
            f"unknown scenario {name!r} (choose from "
            f"{', '.join(['baseline'] + SCENARIO_NAMES)})")
    workdir = workdir or tempfile.mkdtemp(prefix=f"chaos_{name}_")
    env = {"HVDTPU_TEST_SOAK_STEPS": str(steps)}
    env.update(spec["env"])
    job_ref: dict = {}
    journal_dir = os.path.join(workdir, "journal") if spec.get(
        "journal") else None
    if spec.get("driver_chaos"):
        # The kv.server / driver.crash sites live in the in-process
        # driver's run loop.
        _chaos.plan(spec["driver_chaos"], seed=seed)
    result: dict = {}
    timed_out = False
    try:
        result["rc"], _ = run_elastic_scenario(
            workdir, WORKER, initial_hosts=spec["hosts"], extra_env=env,
            driver_env=spec["env"], timeout=timeout, chaos=spec["chaos"],
            chaos_seed=seed, drain_timeout=30.0, job_ref=job_ref,
            journal_dir=journal_dir)
    except AssertionError as e:
        timed_out = "did not finish" in str(e)
        result["exc"] = str(e)[:8000]
    finally:
        if spec.get("driver_chaos"):
            _chaos.clear()
    job = job_ref.get("job")
    ckdir = os.path.join(workdir, "ckpt")
    return {
        "scenario": name,
        "steps": steps,
        "workdir": workdir,
        "timed_out": timed_out,
        "rc": result.get("rc"),
        "exc": None if timed_out else result.get("exc"),
        "diagnostics": result.get("exc") if timed_out else None,
        "records": read_records(workdir),
        "quarantined": (sorted(n for n in os.listdir(ckdir)
                               if ".corrupt" in n)
                        if os.path.isdir(ckdir) else []),
        "host_health": (job.driver.host_manager.host_health()
                        if job is not None else {}),
        "kv_restarts": job.server.restarts if job is not None else 0,
        "rescale_events": job.rescale_events if job is not None else 0,
        "lease_expiries": job.lease_expiries if job is not None else 0,
    }


def run_driver_crash_scenario(steps: int = DEFAULT_STEPS,
                              workdir: Optional[str] = None,
                              timeout: float = 150.0, seed: int = 0) -> dict:
    """Driver death and crash-adoption, with history to lose: a worker
    crashes at commit 2 and is blacklisted (cooldown 1 s) and respawned on
    probation into round 2; the ``driver.crash`` site kills the driver in
    round 2 (cleanup suppressed: the workers are orphaned and block on the
    KV); a fresh ``adopt=True`` driver replays the journal -- same secret,
    port, round and blacklist ledger -- re-attaches the live workers by
    journaled pid and finishes the job without restarting anything
    healthy."""
    from .. import chaos as _chaos
    from ..runner import elastic_driver as ed

    steps = max(steps, 8)
    workdir = workdir or tempfile.mkdtemp(prefix="chaos_driver_crash_")
    journal_dir = os.path.join(workdir, "journal")
    disco = _write_discovery(workdir, ["localhost:1", "127.0.0.1:1"])
    worker_py = os.path.join(workdir, "worker.py")
    with open(worker_py, "w") as f:
        f.write(WORKER_PRELUDE + WORKER)
    driver_env = {"HVDTPU_BLACKLIST_COOLDOWN": "1.0"}
    env = dict(_base_env(workdir, True), HVDTPU_TEST_SOAK_STEPS=str(steps),
               **driver_env)
    # First match wins: the narrow crash rule precedes the pacing.
    env["HVDTPU_CHAOS"] = ("worker.step:crash@step=2;host=127.0.0.1;spawn=0,"
                           "worker.step:slow=0.3")
    env["HVDTPU_CHAOS_SEED"] = str(seed)
    result: dict = {}
    job_ref: dict = {}
    deadline = time.time() + timeout

    def _run(adopt: bool, key: str):
        try:
            with mock.patch.dict(os.environ, driver_env), \
                    _discovery_interval(ed, True):
                result[key] = ed.run_elastic(
                    [sys.executable, worker_py], discovery_script=disco,
                    min_np=1, reset_limit=10, extra_env=env, verbose=True,
                    output_dir=os.path.join(workdir, "logs"),
                    drain_timeout=30.0, job_ref=job_ref,
                    journal_dir=journal_dir, adopt=adopt)
        except BaseException as exc:  # noqa: BLE001
            result[f"{key}_exc"] = repr(exc)

    _chaos.plan("driver.crash:crash@step=2;n=1", seed=seed)
    t1 = threading.Thread(target=_run, args=(False, "rc1"), daemon=True)
    t1.start()
    t1.join(timeout=max(5.0, deadline - time.time()))
    _chaos.clear()
    timed_out = t1.is_alive()
    if timed_out:
        teardown_job(job_ref.get("job"))
        t1.join(timeout=10.0)
    job2 = None
    if not timed_out:
        job_ref.clear()
        t2 = threading.Thread(target=_run, args=(True, "rc"), daemon=True)
        t2.start()
        t2.join(timeout=max(5.0, deadline - time.time()))
        timed_out = t2.is_alive()
        job2 = job_ref.get("job")
        if timed_out:
            teardown_job(job2)
            t2.join(timeout=10.0)
    return {
        "scenario": "driver_crash",
        "steps": steps,
        "workdir": workdir,
        "timed_out": timed_out,
        "rc": result.get("rc"),
        "exc": result.get("rc_exc"),
        "crash_exc": result.get("rc1_exc"),  # must name DriverCrashed
        "records": read_records(workdir),
        "quarantined": [],
        "diagnostics": (timeout_diagnostics(workdir, job2)
                        if timed_out else None),
        "adopted_hosts": list(job2.adopted_hosts) if job2 else [],
        "adopted_epoch": job2._epoch_gen if job2 else None,
        "host_health": (job2.driver.host_manager.host_health()
                        if job2 else {}),
        "kv_restarts": 0,
    }


# ---- serving over the KV ---------------------------------------------------

SERVE_WORKER = '''
import horovod_tpu_torch as hvt
from horovod_tpu_torch import checkpoint as ckptlib
from horovod_tpu_torch.elastic import worker as ew
from horovod_tpu_torch.serve import kv as skv

rank, size = ew.join_world()
# Manifest-verified weight load: every serving worker restores its own
# copy, as one host's replica would.
state, ckpt_step, _ = ckptlib.hot_swap_restore(
    os.path.join(workdir, "ckpt"),
    {"scale": torch.tensor(0.0), "bias": torch.tensor(0.0)},
)
scale, bias = state["scale"], state["bias"]
log({"host": host_id, "serve_joined": rank, "size": size,
     "ckpt_step": ckpt_step,
     "spawn": int(os.environ.get("HVDTPU_SPAWN_ROUND", "0"))})
served = skv.kv_worker_serve_loop(
    lambda b: b * scale + bias, host_id=host_id, poll_secs=0.05,
    device="cpu", on_batch=lambda rec: log(dict(rec, kind="serve_batch")),
)
log({"host": host_id, "serve_done": served})
ew.heartbeat_stop()
sys.exit(0)
'''

SERVE_REQUESTS = 32


def run_kv_serving(workdir: str, worker_body: str, requests, *,
                   hosts=("localhost:1", "127.0.0.1:1"),
                   extra_env: Optional[Dict[str, str]] = None,
                   batch_size: int = 4, request_timeout: float = 2.0,
                   trickle: float = 0.05, timeout: float = 120.0,
                   fast: bool = True) -> dict:
    """Serving worker processes (``WORKER_PRELUDE + worker_body``, each
    ending in ``kv_worker_serve_loop``) under the elastic driver on
    ``hosts`` (blacklist cooldown 1 s, so a killed host respawns), a
    :class:`~..serve.kv.KVServeCoordinator` on the driver's rendezvous
    server, and ``requests`` submitted once every worker announced itself
    ready: the first half at once, the rest ``trickle`` seconds apart.
    ``fast=False`` drops the harness's speed-ups, as in
    :func:`run_elastic_scenario`.
    Returns the answers by request index, the failures, the requeues, the
    wall of the requests (first submit to last answer), the driver's rc
    and the workers' records."""
    from ..runner import elastic_driver as ed
    from ..serve import kv as skv
    from ..serve.dispatcher import Dispatcher

    disco = _write_discovery(workdir, list(hosts))
    worker_py = os.path.join(workdir, "worker.py")
    with open(worker_py, "w") as f:
        f.write(WORKER_PRELUDE + worker_body)
    cooldown = {"HVDTPU_BLACKLIST_COOLDOWN": "1.0"}
    env = dict(_base_env(workdir, fast), **cooldown)
    env.update(extra_env or {})
    with mock.patch.dict(os.environ, cooldown):
        driver = ed.ElasticDriver(ed.HostDiscoveryScript(disco), min_np=1)
    job = ed.ElasticJob([sys.executable, worker_py], driver, extra_env=env,
                        verbose=True, output_dir=os.path.join(workdir, "logs"),
                        drain_timeout=30.0)
    result: dict = {}

    def _run():
        try:
            with mock.patch.dict(os.environ, cooldown), \
                    _discovery_interval(ed, fast):
                result["rc"] = job.run()
        except BaseException as exc:  # noqa: BLE001 - reported below
            result["exc"] = repr(exc)

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    answered: Dict[int, list] = {}
    errors: Dict[int, str] = {}
    dispatcher = Dispatcher(batch_size=batch_size, batch_timeout_ms=30.0,
                            request_timeout_secs=request_timeout,
                            max_attempts=10)
    coord, wall = None, None
    try:
        t0 = time.time()
        while getattr(job.server, "_server", None) is None:
            if time.time() - t0 > 30 or not t.is_alive():
                raise RuntimeError("rendezvous server never started")
            time.sleep(0.05)
        coord = skv.KVServeCoordinator(job.server, dispatcher,
                                       poll_secs=0.02).start()
        while len(coord.ready_workers()) < len(hosts):
            if time.time() - t0 > timeout or not t.is_alive():
                raise RuntimeError("the serving workers never became ready")
            time.sleep(0.05)
        t1 = time.perf_counter()
        futs = {}
        for i, r in enumerate(requests):
            futs[i] = dispatcher.submit(r)
            time.sleep(0.0 if i < len(requests) // 2 else trickle)
        deadline = time.time() + timeout
        for i, f in futs.items():
            try:
                answered[i] = [float(x) for x in np.asarray(
                    f.result(timeout=max(1.0, deadline - time.time())))]
            except Exception as e:  # noqa: BLE001 - recorded as evidence
                errors[i] = repr(e)
        wall = time.perf_counter() - t1
    except Exception as exc:  # noqa: BLE001
        result.setdefault("exc", repr(exc))
    finally:
        if coord is not None:
            coord.stop(shutdown_workers=True)
        elif getattr(job.server, "_server", None) is not None:
            job.server.put("serve_ctl", "shutdown", b"1")
    t.join(timeout=60.0)
    timed_out = t.is_alive()
    diagnostics = None
    if timed_out:
        diagnostics = timeout_diagnostics(workdir, job)
        teardown_job(job)
        t.join(timeout=10.0)
    return {"timed_out": timed_out, "rc": result.get("rc"),
            "exc": result.get("exc"), "diagnostics": diagnostics,
            "answered": answered, "errors": errors,
            "requeued": dispatcher.n_requeued, "wall_s": wall,
            "records": read_records(workdir)}


def run_serve_scenario(name: str = "serve", requests: int = SERVE_REQUESTS,
                       workdir: Optional[str] = None, timeout: float = 120.0,
                       seed: int = 0) -> dict:
    """A 2-host elastic serving pool over the KV transport under
    closed-loop load, one worker hard-killed mid-flight (``serve``; the
    fault-free twin is ``serve_baseline``)."""
    import torch

    from .. import checkpoint as ckptlib

    workdir = workdir or tempfile.mkdtemp(prefix=f"chaos_{name}_")
    # The weights the pool serves (x -> 2x + 1), manifest-verified at
    # every worker's load.
    ckptlib.save_checkpoint(
        os.path.join(workdir, "ckpt"),
        {"scale": torch.tensor(2.0), "bias": torch.tensor(1.0)},
        step=1, force=True,
    )
    env = {}
    if name == "serve":
        # Hard-kill 127.0.0.1's first incarnation at its 2nd leased batch.
        env["HVDTPU_CHAOS"] = "serve.dispatch:crash@step=2;host=127.0.0.1;spawn=0"
        env["HVDTPU_CHAOS_SEED"] = str(seed)
    res = run_kv_serving(
        workdir, SERVE_WORKER,
        [np.full(3, float(i), np.float32) for i in range(requests)],
        extra_env=env, timeout=timeout)
    res.update(scenario=name, workdir=workdir, requests=requests,
               baseline=(run_serve_scenario("serve_baseline",
                                            requests=requests,
                                            timeout=timeout, seed=seed)
                         if name == "serve" else None))
    return res


def check_serve_invariants(res: dict) -> List[str]:
    """Violated invariants for one serve scenario result ([] = ok)."""
    name = res["scenario"]
    if res["timed_out"]:
        return [f"{name}: job did not finish in time"]
    if res.get("exc"):
        return [f"{name}: harness raised {res['exc']}"]
    problems: List[str] = []
    if res["rc"] != 0:
        problems.append(f"{name}: job rc={res['rc']}, wanted 0")
    n = res["requests"]
    if res["errors"]:
        problems.append(
            f"{name}: {len(res['errors'])} request(s) failed/dropped: "
            f"{dict(list(res['errors'].items())[:3])}")
    if len(res["answered"]) != n:
        problems.append(f"{name}: {len(res['answered'])}/{n} requests "
                        "answered")
    joined = [r for r in res["records"] if "serve_joined" in r]
    if not joined:
        problems.append(f"{name}: no serving worker ever joined")
    elif any(r.get("ckpt_step") != 1 for r in joined):
        problems.append(f"{name}: a worker served without the "
                        "manifest-verified step-1 checkpoint")
    for i, v in res["answered"].items():
        want = 2.0 * i + 1.0
        if any(abs(x - want) > 1e-6 for x in v):
            problems.append(f"{name}: request {i} answered {v}, wanted "
                            f"{want}")
            break
    if name == "serve":
        base = res.get("baseline") or {}
        problems.extend(check_serve_invariants(base))
        if base and len(res["answered"]) != len(base.get("answered", {})):
            problems.append(
                f"serve: answered {len(res['answered'])} vs fault-free "
                f"{len(base.get('answered', {}))}")
        if res["requeued"] == 0:
            problems.append("serve: nothing was re-queued -- the crash did "
                            "not land mid-flight")
        spawns = {r["spawn"] for r in res["records"]
                  if r.get("host") == "127.0.0.1" and "spawn" in r}
        if 0 not in spawns:
            problems.append("serve: 127.0.0.1's first incarnation never "
                            "joined")
        victim_done = [r for r in res["records"]
                       if r.get("host") == "127.0.0.1" and "serve_done" in r]
        if not (len(spawns) > 1 or victim_done):
            problems.append("serve: the killed host neither respawned nor "
                            "finished cleanly")
    return problems


# ---- decode (in-process) ---------------------------------------------------

DECODE_STREAMS = 8
DECODE_MAX_NEW = 24


def run_decode_scenario(name: str = "decode", streams: int = DECODE_STREAMS,
                        timeout: float = 90.0, seed: int = 0) -> dict:
    """An in-process :class:`~..serve.engine.DecodeEngine` (2 decode
    workers, paged KV pools, on the CPU) under streaming load, one worker
    killed by ``serve.decode:crash`` mid-sequence (``decode``; the
    fault-free twin is ``decode_baseline``)."""
    from .. import chaos as chaos_mod
    from ..serve import CacheLM, CacheLMConfig, DecodeEngine

    cfg = CacheLMConfig(vocab=32, n_layers=2, n_heads=2, head_dim=8,
                        max_positions=256)
    model = CacheLM(cfg, block_size=8)
    params = model.init_params(seed, device="cpu")
    chaos_mod._reset_for_tests()
    if name == "decode":
        # Kill whichever worker reaches its 4th round first: by then both
        # hold mid-flight streams (8 streams over 2 x 2 rows).
        chaos_mod.plan("serve.decode:crash@step=4;n=1", seed=seed)
    eng = DecodeEngine(model, params, workers=2, rows=2, kv_blocks=32,
                       kv_block_size=8, max_seq_len=64, device="cpu")
    result: dict = {}
    answered: Dict[int, list] = {}
    errors: Dict[int, str] = {}

    def _run():
        try:
            eng.start()
            futs = {}
            for i in range(streams):
                futs[i] = eng.submit([1 + (i % 5), 2, (3 * i) % 7],
                                     DECODE_MAX_NEW)
                time.sleep(0.0 if i < streams // 2 else 0.01)
            deadline = time.time() + timeout
            for i, f in futs.items():
                try:
                    answered[i] = list(
                        f.result(timeout=max(1.0, deadline - time.time())))
                except Exception as e:  # noqa: BLE001 - evidence
                    errors[i] = repr(e)
            result["rc"] = 0
        except BaseException as exc:  # noqa: BLE001
            result["exc"] = repr(exc)

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    t.join(timeout=timeout + 30.0)
    timed_out = t.is_alive()
    workers_left = eng.n_workers
    if timed_out:
        eng.stop(drain=False)
        t.join(timeout=10.0)
    else:
        eng.stop()
    chaos_mod._reset_for_tests()
    return {
        "scenario": name,
        "timed_out": timed_out,
        "rc": result.get("rc"),
        "exc": result.get("exc"),
        "streams": streams,
        "answered": answered,
        "errors": errors,
        "requeued": eng.n_requeued,
        "finished": eng.n_finished,
        "workers_left": workers_left,
        "baseline": (run_decode_scenario("decode_baseline", streams=streams,
                                         timeout=timeout, seed=seed)
                     if name == "decode" else None),
    }


def check_decode_invariants(res: dict) -> List[str]:
    """Violated invariants for one decode scenario result ([] = ok)."""
    name = res["scenario"]
    if res["timed_out"]:
        return [f"{name}: streams did not finish in time"]
    if res.get("exc"):
        return [f"{name}: harness raised {res['exc']}"]
    problems: List[str] = []
    if res["rc"] != 0:
        problems.append(f"{name}: rc={res['rc']}, wanted 0")
    n = res["streams"]
    if res["errors"]:
        problems.append(f"{name}: {len(res['errors'])} stream(s) failed: "
                        f"{dict(list(res['errors'].items())[:3])}")
    if len(res["answered"]) != n:
        problems.append(f"{name}: {len(res['answered'])}/{n} streams "
                        "answered")
    for i, toks in res["answered"].items():
        if len(toks) != DECODE_MAX_NEW:
            problems.append(f"{name}: stream {i} got {len(toks)} tokens, "
                            f"wanted {DECODE_MAX_NEW}")
            break
    if name == "decode":
        base = res.get("baseline") or {}
        problems.extend(check_decode_invariants(base))
        if base and res["answered"] != base.get("answered"):
            diff = [i for i in res["answered"]
                    if res["answered"].get(i) != base.get("answered",
                                                          {}).get(i)]
            problems.append(f"decode: streams {diff[:4]} are not "
                            "token-identical to the fault-free baseline")
        if res["requeued"] == 0:
            problems.append("decode: nothing was re-queued -- the kill did "
                            "not land mid-stream")
        if res.get("workers_left") != 1:
            problems.append(f"decode: {res.get('workers_left')} workers "
                            "left, wanted exactly the 1 survivor")
    return problems


# ---- invariants -------------------------------------------------------------


def _step_seq(records: List[dict], host: str) -> List[int]:
    return [r["step"] for r in records if r.get("host") == host
            and "step" in r]


def check_invariants(res: dict, steps: int = DEFAULT_STEPS) -> List[str]:
    """Violated invariants for one scenario result ([] = survived)."""
    name = res["scenario"]
    steps = res.get("steps", steps)
    if name.startswith("serve"):
        return check_serve_invariants(res)
    if name.startswith("decode"):
        return check_decode_invariants(res)
    if res["timed_out"]:
        return [f"{name}: job did not finish in time: "
                f"{res.get('diagnostics')}"]
    if res.get("exc"):
        return [f"{name}: driver raised {res['exc']}"]
    problems: List[str] = []
    if res["rc"] != 0:
        problems.append(f"{name}: job rc={res['rc']}, wanted 0")
    records = res["records"]
    finals = [r for r in records if "final_step" in r]
    if not finals:
        return problems + [f"{name}: no worker reported a final step"]
    want = -LEARNING_RATE * GRAD * steps
    for r in finals:
        if r["final_step"] != steps:
            problems.append(f"{name}: {r['host']} finished at step "
                            f"{r['final_step']}, wanted {steps}")
        if any(abs(x - want) > 1e-9 for x in r["final_w"]):
            problems.append(f"{name}: {r['host']} final_w={r['final_w']}, "
                            f"wanted all {want}")
    sizes = {r["size"] for r in records if "size" in r}
    if name == "ckpt":
        if not res["quarantined"]:
            problems.append("ckpt: no quarantined .corrupt checkpoint "
                            "directory")
        if not any("resumed_at" in r for r in records):
            problems.append("ckpt: restarted worker never resumed from disk")
    if name in ("crash", "hang"):
        if sizes != {1, 2}:
            problems.append(f"{name}: expected the world to shrink 2->1, saw "
                            f"sizes {sizes}")
        seq = _step_seq(records, "localhost")
        if seq != sorted(seq):
            problems.append(f"{name}: survivor's step sequence regressed")
        if name == "hang" and res.get("lease_expiries", 0) < 1:
            problems.append("hang: no heartbeat lease expired -- the hang "
                            "was not caught by the lease")
    if name == "kv_outage" and not any(
            r.get("fired", {}).get("kv.request") for r in finals):
        problems.append("kv_outage: no KV request failure was injected")
    if name in ("kv_outage", "kv_server_crash"):
        for host in ("localhost", "127.0.0.1"):
            seq = _step_seq(records, host)
            if seq != list(range(1, steps + 1)):
                problems.append(f"{name}: {host} step sequence {seq} shows a "
                                "restart")
        if any("resumed_at" in r for r in records):
            problems.append(f"{name}: a worker restarted from disk")
        if res.get("host_health"):
            problems.append(f"{name}: hosts were struck for a control-plane "
                            f"fault: {res['host_health']}")
    if name == "kv_server_crash" and res.get("kv_restarts", 0) < 1:
        problems.append("kv_server_crash: the KV server was never restarted "
                        "-- the fault did not land")
    if name == "straggler":
        if {r["host"] for r in finals} != {"localhost", "127.0.0.1"}:
            problems.append("straggler: the slow rank was killed instead of "
                            "waited for")
    if name == "preempt":
        if sizes != {1, 2}:
            problems.append(f"preempt: expected the world to shrink 2->1, "
                            f"saw {sizes}")
        if {r["host"] for r in finals} != {"localhost"}:
            problems.append("preempt: the evicted host finished instead of "
                            "draining")
        if not any(r.get("host") == "127.0.0.1" and "preempt_ckpt" in r
                   for r in records):
            problems.append("preempt: the victim never took a priority "
                            "checkpoint")
        if res.get("host_health"):
            problems.append("preempt: the drained host was struck "
                            f"({res['host_health']})")
        from .. import checkpoint as _ckpt

        pdir = os.path.join(res["workdir"], "preempt_ckpt")
        psteps = _ckpt.all_steps(pdir)
        if not psteps:
            problems.append("preempt: no priority checkpoint on disk")
        elif _ckpt.verify_step_dir(os.path.join(pdir,
                                                f"step_{psteps[-1]}")):
            problems.append("preempt: priority checkpoint fails integrity")
    if name == "driver_crash":
        if "DriverCrashed" not in (res.get("crash_exc") or ""):
            problems.append("driver_crash: the driver never crashed "
                            f"({res.get('crash_exc')!r})")
        if not res.get("adopted_hosts"):
            problems.append("driver_crash: the adopter re-attached no live "
                            "workers")
        if res.get("adopted_epoch") != 1:
            problems.append(f"driver_crash: adopted driver epoch "
                            f"{res.get('adopted_epoch')}, wanted 1")
        if res.get("host_health", {}).get("127.0.0.1", 0) < 1:
            problems.append("driver_crash: the victim's blacklist strike did "
                            "not survive the adoption")
        if "localhost" in {r["host"] for r in records if "resumed_at" in r}:
            problems.append("driver_crash: the healthy survivor restarted "
                            "from disk during the driver outage")
    return problems


def run_all(names: Optional[List[str]] = None, steps: int = DEFAULT_STEPS,
            timeout: float = 120.0, seed: int = 0) -> Dict[str, List[str]]:
    """Run scenarios in turn; returns ``{name: problems}``."""
    out: Dict[str, List[str]] = {}
    for name in names or SCENARIO_NAMES:
        res = run_scenario(name, steps=steps, timeout=timeout, seed=seed)
        out[name] = check_invariants(res, steps=steps)
    return out


def main() -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "horovod_tpu_torch.tools.chaos_soak")
    p.add_argument("--scenario", action="append", default=None,
                   choices=["baseline"] + SCENARIO_NAMES)
    p.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    args = p.parse_args()
    out = run_all(args.scenario, steps=args.steps, timeout=args.timeout,
                  seed=args.seed)
    if args.json:
        print(json.dumps(out, indent=1))
    else:
        for name, problems in out.items():
            print(f"{name}: {'ok' if not problems else problems}")
    return 0 if all(not p for p in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
