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
``quant``            int8 + error-feedback training crashes mid-run ->
                     the respawn resumes from the checkpointed TrainState
                     (EF residuals included) and ends bit for bit on the
                     fault-free run (``quant_baseline``)
``silent``           three guarded replicas: ``grad.nan`` skipped on
                     every rank together, one ``grad.bitflip`` localized
                     by the audit and resynced, no corrupted checkpoint,
                     finals bit for bit the fault-free run's
``stream``           a trainer publishes a weight version every step
                     into a decode engine's subscriber while its host is
                     killed (the respawn publishes under a bumped
                     epoch), one publish is torn on the wire and the
                     driver is killed and adopted; afterwards a
                     stale-epoch manifest and a starved stream -> no
                     torn apply, the stale epoch rejected, the
                     checkpoint fallback taken, decode finals token for
                     token the fault-free run's (``stream_baseline``)
``autotune``         the driver's autotune coordinator is killed
                     mid-search; the adopter resumes the search from the
                     journal -> no mixed vector across ranks, the final
                     vector the fault-free run's
===================  ====================================================

Every scenario runs
with the trace plane armed (workers and the in-process driver dump under
``<workdir>/trace``) and the driver's goodput ledger on, under a hard
wall-clock deadline; on timeout the harness records log tails, the KV
plane's round state and the merged flight-recorder timeline, and tears
the wedged job down instead of hanging.

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


@contextlib.contextmanager
def _driver_settings(ed, driver_env: Optional[Dict[str, str]], fast: bool):
    """The in-process driver's env and discovery interval for one scenario,
    held by the scenario's own thread around its job thread's whole life.
    Held by the job thread instead, they outlive a deadline with it: a job
    thread still alive after the teardown kept a hang scenario's 2 s lease
    in ``os.environ`` for every later scenario of the test process, and
    ``patch.dict`` restores its stale copy of the env whenever such a
    thread finally ends."""
    with mock.patch.dict(os.environ, driver_env or {}), \
            _discovery_interval(ed, fast):
        yield


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
    with _driver_settings(ed, driver_env, fast):
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


# Lines of a C++ backtrace (torch's c10 errors): one failed world formation
# prints dozens, and a log's tail would hold nothing else.
_BACKTRACE_LINE = ("frame #", "Exception raised from", "<omitting python")


def _log_tail(path: str, tail_bytes: int) -> str:
    """The last ``tail_bytes`` of a worker log without its C++ backtrace
    lines, so the tail shows every incarnation's last messages."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - 32 * tail_bytes))
        lines = f.read().decode(errors="replace").splitlines(keepends=True)
    kept = "".join(ln for ln in lines
                   if not ln.lstrip().startswith(_BACKTRACE_LINE))
    return kept[-tail_bytes:]


def timeout_diagnostics(workdir: str, job=None, tail_bytes: int = 3000):
    """Evidence for a blown deadline: each worker log's tail (C++
    backtraces left out) and the KV plane's round, heartbeat and guard
    state."""
    diag: dict = {"logs": {}, "kv": {}}
    logs = os.path.join(workdir, "logs")
    if os.path.isdir(logs):
        for rank_dir in sorted(os.listdir(logs)):
            for stream in ("stdout", "stderr"):
                path = os.path.join(logs, rank_dir, stream)
                try:
                    diag["logs"][f"{rank_dir}/{stream}"] = _log_tail(
                        path, tail_bytes)
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


# The quantized-wire convergence worker (the ``quant`` scenario): a tiny
# deterministic training loop through make_train_step on the int8 wire
# with error feedback, checkpointing the whole TrainState (parameters,
# optimizer state, EF residuals) every step. Batches are a pure function of
# the step, so a crashed and resumed run lands on the fault-free run's
# final parameters bit for bit -- which holds only if the EF residuals
# round-trip through the checkpoint.
QUANT_WORKER = """
import horovod_tpu_torch as hvt
from horovod_tpu_torch import checkpoint as ckptlib
from horovod_tpu_torch import elastic
from horovod_tpu_torch.optimizer import Optimizer, ef_residual_norm

STEPS = int(os.environ["HVDTPU_TEST_SOAK_STEPS"])
CKDIR = os.path.join(workdir, "ckpt")
hvt.init(device="cpu", backend="gloo")


def params0():
    rng = np.random.RandomState(0)
    return {"w": torch.tensor(rng.randn(8, 4) * 0.5, dtype=torch.float32),
            "b": torch.zeros(4)}


def loss_fn(p, b):
    x, y = b
    return ((x @ p["w"] + p["b"] - y) ** 2).mean()


def batch_for(step):
    rng = np.random.RandomState(1000 + step)
    return (torch.tensor(rng.randn(16, 8), dtype=torch.float32),
            torch.tensor(rng.randn(16, 4), dtype=torch.float32))


def sgd(lr):
    def update(g, s, p=None):
        return {k: -lr * v for k, v in g.items()}, s
    return Optimizer(lambda p: (), update)


# A coarse block, so the quantization error is large and the residuals
# carry real mass between steps.
step_fn, opt = hvt.make_train_step(
    loss_fn, sgd(0.05), compression=hvt.Compression.int8.with_block(64),
    device="cpu")
box = {"ts": hvt.init_state(params0(), opt)}
state = elastic.ObjectState(step=0)
try:
    box["ts"] = ckptlib.restore_checkpoint(CKDIR, box["ts"])
    state.step = int(box["ts"].step)
    state.save()
    log({"host": host_id, "resumed_at": state.step,
         "resume_residual_norm": ef_residual_norm(box["ts"].opt_state)})
except FileNotFoundError:
    pass


@elastic.run
def train(st):
    while st.step < STEPS:
        ts, loss = step_fn(box["ts"], batch_for(st.step))
        box["ts"] = ts
        st.step = int(ts.step)
        ckptlib.save_checkpoint(CKDIR, ts, step=st.step, keep=STEPS + 1)
        log({"host": host_id, "rank": hvt.rank(), "size": hvt.size(),
             "step": st.step, "loss": float(loss)})
        st.commit()
    return st.step


train(state)
final = box["ts"]
log({"host": host_id, "rank": hvt.rank(), "final_step": int(final.step),
     "final_w": [float(x) for x in final.params["w"].detach().reshape(-1)],
     "final_residual_norm": ef_residual_norm(final.opt_state)})
hvt.shutdown()
"""


# The fail-silent worker (the ``silent`` scenario): a world of 3 where each
# process trains the same deterministic model through
# make_train_step(guard=...), so every replica's state stays bit for bit
# the same. ``grad.nan`` poisons one batch on every rank (the guard skips
# the step on every rank together, the state untouched, and the
# deterministic pipeline retries it); ``grad.bitflip`` flips one seeded bit
# of one rank's parameters after the commit (only the consistency audit
# sees it: the majority vote localizes the rank, the broadcast resync heals
# it, the driver's health scoring records the report). Rank 0 checkpoints
# every committed step after the audit, so no corrupted state reaches disk.
SILENT_WORKER = """
import horovod_tpu_torch as hvt
from horovod_tpu_torch import checkpoint as ckptlib
from horovod_tpu_torch import elastic
from horovod_tpu_torch.guard import GuardConfig
from horovod_tpu_torch.optimizer import Optimizer

STEPS = int(os.environ["HVDTPU_TEST_SOAK_STEPS"])
CKDIR = os.path.join(workdir, "ckpt")
hvt.init(device="cpu", backend="gloo")


def params0():
    rng = np.random.RandomState(0)
    return {"w": torch.tensor(rng.randn(8, 4) * 0.5, dtype=torch.float32),
            "b": torch.zeros(4)}


def loss_fn(p, b):
    x, y = b
    return ((x @ p["w"] + p["b"] - y) ** 2).mean()


def batch_for(step):
    rng = np.random.RandomState(1000 + step)
    return (torch.tensor(rng.randn(16, 8), dtype=torch.float32),
            torch.tensor(rng.randn(16, 4), dtype=torch.float32))


def sgd(lr):
    def update(g, s, p=None):
        return {k: -lr * v for k, v in g.items()}, s
    return Optimizer(lambda p: (), update)


cfg = GuardConfig(max_skips=4, warmup=2, audit_every=1)
step_fn, opt = hvt.make_train_step(loss_fn, sgd(0.05), guard=cfg,
                                   device="cpu")
box = {"ts": hvt.init_state(params0(), opt, guard=True)}
state = elastic.ObjectState(step=0)
try:
    box["ts"] = ckptlib.restore_checkpoint(CKDIR, box["ts"])
    state.step = int(box["ts"].step)
    state.save()
    log({"host": host_id, "resumed_at": state.step})
except FileNotFoundError:
    pass


@elastic.run
def train(st):
    while st.step < STEPS:
        attempt = int(box["ts"].step) + 1
        ts, loss = step_fn(box["ts"], batch_for(int(box["ts"].step)))
        box["ts"] = ts
        lossf = float(loss)
        rec = {"host": host_id, "rank": hvt.rank(), "size": hvt.size(),
               "attempt": attempt, "step": int(ts.step),
               "skipped_total": int(ts.guard.skipped),
               "loss": lossf if np.isfinite(lossf) else None}
        rt = step_fn.guard_runtime
        if rt.last_report is not None and rt.last_report.step == int(ts.step):
            rec["audit"] = rt.last_report.as_record()
            rt.last_report = None
        committed = int(ts.step) > st.step
        st.step = int(ts.step)
        if committed and hvt.rank() == 0:
            # After the audit: a step reaches disk only once the
            # cross-replica checksum round said this rank is clean.
            ckptlib.save_checkpoint(CKDIR, ts, step=st.step,
                                    keep=STEPS + 1, force=True)
        log(rec)
        st.commit()
    return st.step


train(state)
final = box["ts"]
log({"host": host_id, "rank": hvt.rank(), "final_step": int(final.step),
     "final_w": [float(x) for x in final.params["w"].detach().reshape(-1)],
     "skipped_total": int(final.guard.skipped)})
hvt.shutdown()
"""

SILENT_VICTIM = "127.0.0.2"  # rank 1 of the sorted world of 3


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
        # Quantized training and its EF state through a crash and restore:
        # the respawn resumes from the checkpointed TrainState and must
        # land on the fault-free run's final parameters bit for bit
        # (run_scenario("quant") runs both). One host: the crashed host is
        # re-admitted from blacklist probation for the respawn.
        "quant_baseline": {
            "hosts": ["localhost:1"], "chaos": None, "env": {},
            "worker": QUANT_WORKER,
        },
        "quant": {
            "hosts": ["localhost:1"],
            "chaos": f"worker.step:crash@step={mid};spawn=0",
            "env": {"HVDTPU_BLACKLIST_COOLDOWN": "1.0"},
            "worker": QUANT_WORKER,
        },
        # Fail-silent faults (SILENT_WORKER): three loopback hosts, so the
        # audit has a strict majority. grad.nan hits every rank at attempt
        # 2 (the guard skips together and the step is retried);
        # grad.bitflip hits only the victim's parameters after commit mid,
        # and the audit of that step must catch it.
        "silent_baseline": {
            "hosts": ["127.0.0.1:1", "127.0.0.2:1", "127.0.0.3:1"],
            "chaos": None, "env": {}, "worker": SILENT_WORKER,
        },
        "silent": {
            "hosts": ["127.0.0.1:1", "127.0.0.2:1", "127.0.0.3:1"],
            "chaos": ("grad.nan:nan@step=2;n=1,"
                      f"grad.bitflip:bitflip@step={mid};"
                      f"host={SILENT_VICTIM};n=1"),
            "env": {}, "worker": SILENT_WORKER,
        },
    }


SCENARIO_NAMES = [n for n in _scenarios(DEFAULT_STEPS)
                  if not n.endswith("baseline")] + [
    "serve", "decode", "stream", "driver_crash", "autotune"]


# ---- the telemetry planes of a scenario -----------------------------------


def _arm_trace(workdir: str, env: dict) -> str:
    """Arm the trace plane for a scenario: the workers through their env,
    the in-process driver programmatically (its dumps under the
    ``driver`` stem). Every soak run ships flight-recorder evidence."""
    from ..obs import trace as _trace

    trace_dir = os.path.join(workdir, "trace")
    env["HVDTPU_TRACE"] = "1"
    env["HVDTPU_TRACE_DIR"] = trace_dir
    _trace.enable(directory=trace_dir)
    return trace_dir


def _disarm_trace() -> None:
    """Scenario over: dump what the in-process side recorded, then disarm
    and clear the ring, so the next scenario's dumps carry none of this
    one's history."""
    from ..obs import trace as _trace

    _trace.flight_dump("scenario_end")
    _trace.disable()
    _trace.set_role(None)
    _trace.recorder().clear()


def _attach_flight_recorder(diag: Optional[dict], workdir: str) -> dict:
    """Merge the flight-recorder dumps a torn-down job left (workers dump
    on the kill's SIGTERM; a chaos ``hang`` or ``crash`` victim at the
    injection) into one clock-aligned timeline, attached to the deadline
    diagnostics."""
    from ..obs import trace as _trace
    from . import hvdtpu_trace as ht

    diag = diag if diag is not None else {}
    _trace.flight_dump("deadline")
    trace_dir = os.path.join(workdir, "trace")
    out = os.path.join(trace_dir, "merged.json")
    try:
        merged = ht.merge_dir(trace_dir, out=out)
    except Exception as e:  # noqa: BLE001 - diagnostics only
        diag["flight_recorder"] = {"error": repr(e)}
        return diag
    if merged is None:
        diag["flight_recorder"] = {"error": "no flight-recorder dumps"}
        return diag
    diag["flight_recorder"] = {
        "merged": out,
        "files": [os.path.basename(p) for p in ht.discover(trace_dir)],
        "events": len(merged["traceEvents"]),
        "clock_offsets_us": merged["metadata"].get("clock_offsets_us"),
    }
    return diag


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
    if name in ("stream", "stream_baseline"):
        return run_stream_scenario(name, steps=steps, workdir=workdir,
                                   timeout=timeout, seed=seed)
    if name == "autotune":
        return run_autotune_scenario(workdir=workdir, timeout=timeout,
                                     seed=seed)
    spec = _scenarios(steps).get(name)
    if spec is None:
        raise ValueError(
            f"unknown scenario {name!r} (choose from "
            f"{', '.join(['baseline'] + SCENARIO_NAMES)})")
    from ..obs import goodput as _goodput

    workdir = workdir or tempfile.mkdtemp(prefix=f"chaos_{name}_")
    env = {"HVDTPU_TEST_SOAK_STEPS": str(steps)}
    env.update(spec["env"])
    trace_dir = _arm_trace(workdir, env)
    # The in-process driver's goodput ledger: a fault's lost wall-clock
    # must land in its category (crash/hang: rescale_downtime).
    _goodput._reset_for_tests()
    _goodput.enable()
    job_ref: dict = {}
    journal_dir = os.path.join(workdir, "journal") if spec.get(
        "journal") else None
    if spec.get("driver_chaos"):
        # The kv.server / driver.crash sites live in the in-process
        # driver's run loop.
        _chaos.plan(spec["driver_chaos"], seed=seed)
    result: dict = {}
    timed_out = False
    diagnostics = None
    try:
        result["rc"], _ = run_elastic_scenario(
            workdir, spec.get("worker") or WORKER,
            initial_hosts=spec["hosts"], extra_env=env,
            driver_env=spec["env"], timeout=timeout, chaos=spec["chaos"],
            chaos_seed=seed, drain_timeout=30.0, job_ref=job_ref,
            journal_dir=journal_dir)
    except AssertionError as e:
        timed_out = "did not finish" in str(e)
        result["exc"] = str(e)[:8000]
        if timed_out:
            # After the teardown: its SIGTERMs made the wedged workers
            # dump, so the deadline ships a "who was where" timeline.
            diagnostics = _attach_flight_recorder(
                {"error": result["exc"]}, workdir)
    finally:
        if spec.get("driver_chaos"):
            _chaos.clear()
        _disarm_trace()
    job = job_ref.get("job")
    ckdir = os.path.join(workdir, "ckpt")
    res = {
        "scenario": name,
        "steps": steps,
        "workdir": workdir,
        "trace_dir": trace_dir,
        "timed_out": timed_out,
        "rc": result.get("rc"),
        "exc": None if timed_out else result.get("exc"),
        "diagnostics": diagnostics,
        "records": read_records(workdir),
        "quarantined": (sorted(n for n in os.listdir(ckdir)
                               if ".corrupt" in n)
                        if os.path.isdir(ckdir) else []),
        "host_health": (job.driver.host_manager.host_health()
                        if job is not None else {}),
        "kv_restarts": job.server.restarts if job is not None else 0,
        "rescale_events": job.rescale_events if job is not None else 0,
        "lease_expiries": job.lease_expiries if job is not None else 0,
        # The driver's consumed guard divergence reports (silent).
        "guard_reports": ({h: strikes for h, (_, strikes)
                           in job._guard_reports.items()}
                          if job is not None else {}),
        # The driver ledger's attribution of the job's wall-clock.
        "goodput": job.goodput_snapshot() if job is not None else None,
    }
    _goodput._reset_for_tests()
    if name in ("quant", "silent"):
        # The invariant is relative: the same worker, fault-free, must
        # end on the same parameters bit for bit.
        res["baseline"] = run_scenario(f"{name}_baseline", steps=steps,
                                       timeout=timeout, seed=seed)
    return res


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
            result[key] = ed.run_elastic(
                [sys.executable, worker_py], discovery_script=disco,
                min_np=1, reset_limit=10, extra_env=env, verbose=True,
                output_dir=os.path.join(workdir, "logs"),
                drain_timeout=30.0, job_ref=job_ref,
                journal_dir=journal_dir, adopt=adopt)
        except BaseException as exc:  # noqa: BLE001
            result[f"{key}_exc"] = repr(exc)

    _chaos.plan("driver.crash:crash@step=2;n=1", seed=seed)
    with _driver_settings(ed, driver_env, True):
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
            t2 = threading.Thread(target=_run, args=(True, "rc"),
                                  daemon=True)
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
            result["rc"] = job.run()
        except BaseException as exc:  # noqa: BLE001 - reported below
            result["exc"] = repr(exc)

    t = threading.Thread(target=_run, daemon=True)
    with _driver_settings(ed, cooldown, fast):
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
                    raise RuntimeError(
                        "the serving workers never became ready")
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
                except Exception as e:  # noqa: BLE001 - evidence
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


# ---- live weight streaming (the ``stream`` scenario) ------------------------

# The trainer: an elastic world whose "training" is analytic (identical
# bytes from any incarnation at a step), one host publishing every step
# into the driver's KV, rank 0 checkpointing the step for a respawn.
STREAM_WORKER = """
import horovod_tpu_torch as hvt
from horovod_tpu_torch import checkpoint as ckptlib
from horovod_tpu_torch import elastic
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.serve import CacheLM, CacheLMConfig
from horovod_tpu_torch.stream import WeightPublisher

STEPS = int(os.environ["HVDTPU_TEST_SOAK_STEPS"])
SEED = int(os.environ.get("HVDTPU_TEST_STREAM_SEED", "0"))
PUB_HOST = os.environ["HVDTPU_TEST_STREAM_PUB_HOST"]
CKDIR = os.path.join(workdir, "state_ckpt")

_base = CacheLM(CacheLMConfig(vocab=32, n_layers=2, n_heads=2, head_dim=8,
                              max_positions=256),
                block_size=8).init_params(SEED, device="cpu")


def params_at(step):
    # Analytic "training": identical bytes from any incarnation.
    from horovod_tpu_torch.ops.batching import tree_map

    return tree_map(lambda x: x + torch.tensor(0.001, dtype=torch.float32)
                    * step, _base)


hvt.init(device="cpu", backend="gloo")
pub = WeightPublisher(publish_every=1) if host_id == PUB_HOST else None
state = elastic.ObjectState(step=0)
try:
    restored = ckptlib.restore_checkpoint(CKDIR, {"step": torch.tensor(0)})
    state.step = int(restored["step"])
    state.save()
    log({"host": host_id, "resumed_at": state.step})
except FileNotFoundError:
    pass


@elastic.run
def train(st):
    while st.step < STEPS:
        C.allreduce(torch.full((2,), 0.5))
        st.step += 1
        if hvt.rank() == 0:
            ckptlib.save_checkpoint(CKDIR, {"step": torch.tensor(st.step)},
                                    step=st.step, keep=STEPS + 1)
        if pub is not None:
            pub.maybe_publish(params_at(st.step), st.step)
            log({"host": host_id, "step": st.step, "epoch": pub.epoch,
                 "published": pub.n_published,
                 "spawn": int(os.environ.get("HVDTPU_SPAWN_ROUND", "0"))})
        st.commit()
    return st.step


train(state)
if pub is not None:
    pub.flush()
    log({"host": host_id, "publisher_done": state.step,
         "published": pub.n_published, "torn": pub.n_torn_injected})
log({"host": host_id, "final_step": state.step})
hvt.shutdown()
"""

STREAM_VICTIM = "127.0.0.1"  # the publisher host the chaos kills
STREAM_DECODE_STREAMS = 8


class _MemKV:
    """Post-job stand-in for the driver's KV (the real server dies with
    the job): it holds whatever the harness injects, e.g. the stale-epoch
    manifest a dead trainer's late write would have left."""

    def __init__(self):
        self._store: Dict[str, Dict[str, bytes]] = {}
        self._lock = threading.Lock()

    def put(self, scope: str, key: str, value: bytes) -> None:
        with self._lock:
            self._store.setdefault(scope, {})[key] = value

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._store.get(scope, {}))


def _stream_model():
    from ..serve import CacheLM, CacheLMConfig

    return CacheLM(CacheLMConfig(vocab=32, n_layers=2, n_heads=2,
                                 head_dim=8, max_positions=256),
                   block_size=8)


def _stream_params(seed: int, step: int):
    """The harness's twin of the worker's analytic parameters."""
    import torch

    from ..ops.batching import tree_map

    base = _stream_model().init_params(seed, device="cpu")
    return tree_map(lambda x: x + torch.tensor(0.001, dtype=torch.float32)
                    * step, base)


def run_stream_scenario(name: str = "stream", steps: int = DEFAULT_STEPS,
                        workdir: Optional[str] = None,
                        timeout: float = 120.0, seed: int = 0) -> dict:
    """Live weight streaming under faults (``stream``; the fault-free twin
    is ``stream_baseline``): an elastic trainer publishes a version every
    step through the driver's KV into an in-process
    :class:`~..serve.engine.DecodeEngine` (2 workers) through a
    :class:`~..stream.StreamSubscriber`, while the plan kills the
    publisher host at commit 2 (its respawn publishes under a bumped
    epoch), tears one publish of the respawned publisher on the wire
    (``publish.delta:torn``) and kills the driver in round 2 (an
    ``adopt=True`` driver takes the job over). After the job the harness
    injects a stale-epoch manifest and starves the stream into the
    checkpoint fallback. :func:`check_stream_invariants` audits them."""
    from .. import chaos as _chaos
    from .. import checkpoint as ckptlib
    from ..runner import elastic_driver as ed
    from ..serve import DecodeEngine
    from ..stream import StreamSubscriber
    from ..stream import protocol as _sproto

    # The victim must respawn, resume and publish after the adoption for
    # the epoch and torn legs to fire.
    steps = max(steps, 10)
    workdir = workdir or tempfile.mkdtemp(prefix=f"chaos_{name}_")
    journal_dir = os.path.join(workdir, "journal")
    serve_ckpt = os.path.join(workdir, "serve_ckpt")
    disco = _write_discovery(workdir, ["localhost:1", f"{STREAM_VICTIM}:1"])
    worker_py = os.path.join(workdir, "worker.py")
    with open(worker_py, "w") as f:
        f.write(WORKER_PRELUDE + STREAM_WORKER)
    driver_env = {"HVDTPU_BLACKLIST_COOLDOWN": "1.0"}
    env = dict(_base_env(workdir, True), HVDTPU_TEST_SOAK_STEPS=str(steps),
               HVDTPU_TEST_STREAM_SEED=str(seed),
               HVDTPU_TEST_STREAM_PUB_HOST=STREAM_VICTIM, **driver_env)
    if name == "stream":
        # First match wins: the conditioned faults precede the pacing.
        # The second torn publish fires on the RESPAWNED victim's first
        # publish past step 7, on its bumped epoch.
        env["HVDTPU_CHAOS"] = (
            f"publish.delta:torn@step=2;n=1;host={STREAM_VICTIM};spawn=0,"
            f"publish.delta:torn@after=7;n=1;host={STREAM_VICTIM},"
            f"worker.step:crash@step=2;host={STREAM_VICTIM};spawn=0,"
            "worker.step:slow=0.2")
    else:
        env["HVDTPU_CHAOS"] = "worker.step:slow=0.2"  # the same pacing
    env["HVDTPU_CHAOS_SEED"] = str(seed)
    _arm_trace(workdir, env)

    # The serving side, in-process: the engine starts on the step-0
    # parameters; the subscriber follows whichever KV server the live job
    # incarnation owns (the callable is evaluated every poll).
    eng = DecodeEngine(_stream_model(), _stream_params(seed, 0), workers=2,
                       rows=2, kv_blocks=32, kv_block_size=8,
                       max_seq_len=64, device="cpu")
    eng.start()
    job_ref: dict = {}
    kv_override: dict = {}

    def _kv():
        if "kv" in kv_override:
            return kv_override["kv"]
        job = job_ref.get("job")
        return getattr(job, "server", None) if job is not None else None

    sub = StreamSubscriber(eng, kv=_kv, poll_secs=0.05, staleness_secs=1e9,
                           ckpt_dir=serve_ckpt)
    eng.attach_stream(sub)
    sub.start()

    # Mirror the live stream scope into the post-job stand-in, so the
    # server's death with the job cannot strand the last version.
    mem_kv = _MemKV()
    mirror_stop = threading.Event()

    def _mirror():
        while not mirror_stop.is_set():
            server = _kv()
            if server is not None and hasattr(server, "scope_items"):
                try:
                    for k, v in server.scope_items("stream").items():
                        mem_kv.put("stream", k, v)
                except Exception:  # noqa: BLE001 - server mid-death
                    pass
            mirror_stop.wait(0.05)

    mirror_t = threading.Thread(target=_mirror, daemon=True)
    mirror_t.start()
    result: dict = {}
    deadline = time.time() + timeout

    def _run(adopt: bool, key: str):
        try:
            result[key] = ed.run_elastic(
                [sys.executable, worker_py], discovery_script=disco,
                min_np=1, reset_limit=10, extra_env=env, verbose=True,
                output_dir=os.path.join(workdir, "logs"),
                drain_timeout=30.0, job_ref=job_ref,
                journal_dir=journal_dir, adopt=adopt)
        except BaseException as exc:  # noqa: BLE001
            result[f"{key}_exc"] = repr(exc)

    def _phase(adopt: bool, key: str) -> bool:
        t = threading.Thread(target=_run, args=(adopt, key), daemon=True)
        with _driver_settings(ed, driver_env, True):
            t.start()
            t.join(timeout=max(5.0, deadline - time.time()))
            if t.is_alive():
                teardown_job(job_ref.get("job"))
                t.join(timeout=10.0)
                return True
        return False

    adopted_hosts: List[str] = []
    if name == "stream":
        # The original driver, armed to die in round 2 (the round that
        # respawns the struck publisher host), then an adopter.
        _chaos.plan("driver.crash:crash@step=2;n=1", seed=seed)
        timed_out = _phase(False, "rc1")
        _chaos.clear()
        if not timed_out:
            job_ref.clear()
            timed_out = _phase(True, "rc")
            job2 = job_ref.get("job")
            if job2 is not None:
                adopted_hosts = list(job2.adopted_hosts)
    else:
        timed_out = _phase(False, "rc")

    mirror_stop.set()
    mirror_t.join(timeout=5.0)
    kv_override["kv"] = mem_kv
    # The last published version must reach the fleet: the head is
    # written last and nothing overwrites it after the job.
    final_version = None
    if not timed_out:
        t0 = time.time()
        while time.time() - t0 < 30.0:
            with sub._lock:
                final_version = sub._last_version
            if final_version == steps:
                break
            time.sleep(0.05)
    # Decode on the streamed step-N weights: token for token the
    # fault-free twin's.
    answered: Dict[int, list] = {}
    errors: Dict[int, str] = {}
    if not timed_out and final_version == steps:
        futs = {i: eng.submit([1 + (i % 5), 2, (3 * i) % 7], DECODE_MAX_NEW)
                for i in range(STREAM_DECODE_STREAMS)}
        for i, f in futs.items():
            try:
                answered[i] = list(f.result(timeout=60.0))
            except Exception as e:  # noqa: BLE001 - evidence
                errors[i] = repr(e)
    if name == "stream" and not timed_out:
        # A late write from a dead trainer: a manifest from an epoch
        # below every one seen is rejected, never staged.
        mem_kv.put("stream", _sproto.HEAD_KEY, _sproto.frame_manifest(
            version=steps + 7, epoch=-1, step=steps + 7, layout={},
            buckets=[]))
        t0 = time.time()
        while time.time() - t0 < 10.0:
            with sub._lock:
                if sub.n_epoch_rejected > 0:
                    break
            time.sleep(0.05)
        # The trainer is gone: the stream is stale for good. A tight
        # threshold and a newer whole checkpoint must make the subscriber
        # fall back to it through the CheckpointWatcher.
        ckptlib.save_checkpoint(serve_ckpt, _stream_params(seed, steps + 1),
                                step=steps + 1, force=True)
        sub.staleness_secs = 0.3
        t0 = time.time()
        while time.time() - t0 < 15.0:
            with sub._lock:
                if sub.n_fallbacks > 0:
                    break
            time.sleep(0.05)
    diagnostics = None
    if timed_out:
        diagnostics = _attach_flight_recorder(
            timeout_diagnostics(workdir, job_ref.get("job")), workdir)
    _disarm_trace()
    # The evidence before the teardown (stop() drains the workers away).
    with eng._cond:
        engine_version_log = list(eng.stream_version_log)
        worker_version_logs = {n: list(w.version_log)
                               for n, w in eng._workers.items()}
    with sub._lock:
        applied_log = [list(t) for t in sub.applied_log]
        n_torn = sub.n_torn
        n_epoch_rejected = sub.n_epoch_rejected
        n_fallbacks = sub.n_fallbacks
        sub_error = sub.last_error
    eng.stop()  # stops the attached subscriber first
    return {
        "scenario": name,
        "steps": steps,
        "workdir": workdir,
        "timed_out": timed_out,
        "rc": result.get("rc"),
        "exc": result.get("rc_exc"),
        "crash_exc": result.get("rc1_exc"),  # must name DriverCrashed
        "records": read_records(workdir),
        "quarantined": [],
        "diagnostics": diagnostics,
        "adopted_hosts": adopted_hosts,
        "final_version": final_version,
        "applied_log": applied_log,
        "engine_version_log": engine_version_log,
        "worker_version_logs": worker_version_logs,
        "n_torn": n_torn,
        "n_epoch_rejected": n_epoch_rejected,
        "n_fallbacks": n_fallbacks,
        "sub_error": sub_error,
        "answered": answered,
        "errors": errors,
        "baseline": (run_stream_scenario("stream_baseline", steps=steps,
                                         timeout=timeout, seed=seed)
                     if name == "stream" else None),
    }


def check_stream_invariants(res: dict) -> List[str]:
    """Violated invariants of one stream scenario result ([] = ok)."""
    name = res["scenario"]
    if res["timed_out"]:
        return [f"{name}: job did not finish in time"]
    if res.get("exc"):
        return [f"{name}: harness raised {res['exc']}"]
    problems: List[str] = []
    if res["rc"] != 0:
        problems.append(f"{name}: job rc={res['rc']}, wanted 0")
    steps = res["steps"]
    if res.get("final_version") != steps:
        problems.append(
            f"{name}: final applied version {res.get('final_version')}, "
            f"wanted {steps} (last error: {res.get('sub_error')})")
    # No torn apply: every version the engine flipped in, and every one a
    # decode worker decoded under, came through the subscriber's verified
    # all-or-nothing staging.
    applied = {int(v) for v, _ in res["applied_log"]}
    bad = [v for v in res["engine_version_log"] if v not in applied]
    if bad:
        problems.append(f"{name}: engine flipped versions {bad[:4]} the "
                        "subscriber never verified -- a torn set served")
    for worker, versions in res["worker_version_logs"].items():
        bad = [v for v in versions if v not in applied]
        if bad:
            problems.append(f"{name}: decode worker {worker} served "
                            f"unverified versions {bad[:4]}")
    # Within one epoch versions strictly increase (an epoch bump may
    # reset the floor: the trainer resumed from its restored step).
    by_epoch: Dict[int, List[int]] = {}
    last_epoch = None
    for v, e in res["applied_log"]:
        by_epoch.setdefault(int(e), []).append(int(v))
        if last_epoch is not None and e < last_epoch:
            problems.append(f"{name}: applied epoch regressed "
                            f"{last_epoch} -> {e}")
        last_epoch = e
    for e, versions in by_epoch.items():
        if versions != sorted(set(versions)):
            problems.append(f"{name}: versions within epoch {e} not "
                            f"strictly increasing: {versions}")
    if res["errors"]:
        problems.append(f"{name}: {len(res['errors'])} decode stream(s) "
                        f"failed: {dict(list(res['errors'].items())[:3])}")
    if len(res["answered"]) != STREAM_DECODE_STREAMS:
        problems.append(f"{name}: {len(res['answered'])}/"
                        f"{STREAM_DECODE_STREAMS} decode streams answered")
    if name == "stream":
        base = res.get("baseline") or {}
        problems.extend(check_stream_invariants(base))
        if base and res["answered"] != base.get("answered"):
            diff = [i for i in res["answered"] if res["answered"].get(i)
                    != base.get("answered", {}).get(i)]
            problems.append(f"stream: decode streams {diff[:4]} are not "
                            "token-identical to the fault-free baseline")
        if res["n_torn"] < 1:
            problems.append("stream: no torn set was rejected -- the "
                            "injected mid-publish death left no damage")
        if res["n_epoch_rejected"] < 1:
            problems.append("stream: the stale-epoch manifest was never "
                            "rejected")
        if res["n_fallbacks"] < 1:
            problems.append("stream: the starved stream never fell back "
                            "to the CheckpointWatcher path")
        epochs = {int(e) for _, e in res["applied_log"]}
        if len(epochs) < 2:
            problems.append(f"stream: applied epochs {sorted(epochs)} -- "
                            "the respawned publisher's epoch never "
                            "reached the fleet")
        if "DriverCrashed" not in (res.get("crash_exc") or ""):
            problems.append(f"stream: the first driver ended with "
                            f"{res.get('crash_exc')!r}, wanted "
                            "DriverCrashed")
        if not res["adopted_hosts"]:
            problems.append("stream: the adopting driver re-attached no "
                            "workers")
    return problems


# ---- the closed-loop autotuner (the ``autotune`` scenario) ------------------

# The worker half of the tuner against the real journaled KV, scored by a
# deterministic analytic duration (a smooth bowl over the unit knob
# vector) instead of wall time: a fault-free run and a crash-interrupted
# run land on the same final vector only if the search resumes from
# journaled history. A retrace switch arrives as a round republish
# (HostsUpdatedInterrupt at a commit); each rank then logs the bucket
# layout the env the switch wrote gives, which must agree across ranks.
AUTOTUNE_WORKER = """
import horovod_tpu_torch as hvt
from horovod_tpu_torch import elastic
from horovod_tpu_torch import tune
from horovod_tpu_torch.elastic import worker as _ew
from horovod_tpu_torch.ops.batching import pack_spec

hvt.init(device="cpu", backend="gloo")
registry = tune.training_space()  # the driver's space, from the same env
client = tune.AutotuneClient(registry, _ew.tune_config_source(),
                             scorer=tune.WindowScorer())
_LAYOUT_PARAMS = {"w": torch.zeros(256, 64), "b": torch.zeros(64)}
_n_retraces = 0


def fake_ms(vector):
    # A bowl with an interior optimum: the same on every rank and run.
    u = registry.to_unit(vector)
    return 100.0 + 50.0 * sum((ui - 0.35) ** 2 for ui in u)


state = elastic.ObjectState(step=0)


@elastic.run
def train(st):
    global _n_retraces
    while not client.done:
        act = client.step_start()
        if act is not None:
            log({"host": host_id, "rank": hvt.rank(),
                 "trial": client.applied_trial, "at_step": client.step,
                 "vector": client.applied, "retrace": bool(act.retrace)})
            if act.retrace:
                # What a rebuilt step would bucket from the env the
                # lockstep switch just wrote.
                _n_retraces += 1
                _, spec = pack_spec(_LAYOUT_PARAMS)
                log({"host": host_id, "rank": hvt.rank(),
                     "retrace_n": _n_retraces,
                     "retrace_layout": list(spec.padded_sizes())})
        time.sleep(0.02)
        vec = client.applied or registry.canonical(registry.default_vector())
        client.step_end(fake_ms(vec) / 1e3)
        st.step += 1
        st.commit()
    return st.step


train(state)
log({"host": host_id, "rank": hvt.rank(),
     "autotune_final": client.applied, "final_trial": client.applied_trial,
     "steps_run": client.step})
hvt.shutdown()
"""

# A small, fast search, shared by both phases and the fault-free twin so
# their trial histories compare.
AUTOTUNE_SOAK_ENV = {
    "HVDTPU_AUTOTUNE": "1",
    "HVDTPU_AUTOTUNE_WINDOW_STEPS": "2",
    "HVDTPU_AUTOTUNE_WARMUP_STEPS": "1",
    "HVDTPU_AUTOTUNE_MAX_TRIALS": "5",
    "HVDTPU_AUTOTUNE_PATIENCE": "3",
    "HVDTPU_AUTOTUNE_SEED": "20240731",
    # The whole catalog: the categorical arm and the retrace-knob round
    # republish both run.
    "HVDTPU_AUTOTUNE_KNOBS": ("FUSION_THRESHOLD,OVERLAP_STAGGER,"
                              "PREFETCH_DEPTH,COLLECTIVE_LAYOUT"),
}


def run_autotune_scenario(workdir: Optional[str] = None,
                          timeout: float = 120.0, seed: int = 0,
                          crash: bool = True) -> dict:
    """The closed-loop autotuner under a driver crash: a 2-host elastic
    job tunes over the journaled KV (the driver's coordinator, the
    workers' lockstep clients with analytic scores); ``driver.crash``
    kills the driver in round 2 (rounds advance with every retrace
    switch, so mid-search); an ``adopt=True`` driver replays the journal,
    resumes the search from its journaled trial history and takes it to
    convergence. ``crash=False`` is the fault-free twin.
    :func:`check_autotune_invariants` audits both."""
    from .. import chaos as _chaos
    from ..runner import elastic_driver as ed

    workdir = workdir or tempfile.mkdtemp(prefix="chaos_autotune_")
    os.makedirs(workdir, exist_ok=True)  # the twin nests one
    journal_dir = os.path.join(workdir, "journal")
    disco = _write_discovery(workdir, ["localhost:1", "127.0.0.1:1"])
    worker_py = os.path.join(workdir, "worker.py")
    with open(worker_py, "w") as f:
        f.write(WORKER_PRELUDE + AUTOTUNE_WORKER)
    driver_env = dict(AUTOTUNE_SOAK_ENV)
    env = dict(_base_env(workdir, True), **AUTOTUNE_SOAK_ENV)
    _arm_trace(workdir, env)
    result: dict = {}
    job_ref: dict = {}
    deadline = time.time() + timeout

    def _run(adopt: bool, key: str):
        try:
            result[key] = ed.run_elastic(
                [sys.executable, worker_py], discovery_script=disco,
                min_np=1, reset_limit=10, extra_env=env, verbose=True,
                output_dir=os.path.join(workdir, "logs"),
                drain_timeout=30.0, job_ref=job_ref,
                journal_dir=journal_dir, adopt=adopt)
        except BaseException as exc:  # noqa: BLE001
            result[f"{key}_exc"] = repr(exc)

    def _phase(adopt: bool, key: str) -> bool:
        t = threading.Thread(target=_run, args=(adopt, key), daemon=True)
        with _driver_settings(ed, driver_env, True):
            t.start()
            t.join(timeout=max(5.0, deadline - time.time()))
            if t.is_alive():
                teardown_job(job_ref.get("job"))
                t.join(timeout=10.0)
                return True
        return False

    adopted_history_len = None
    if crash:
        _chaos.plan("driver.crash:crash@step=2;n=1", seed=seed)
        timed_out = _phase(False, "rc1")
        _chaos.clear()
        if not timed_out:
            job_ref.clear()
            timed_out = _phase(True, "rc")
            job2 = job_ref.get("job")
            if job2 is not None and job2._adopted_state:
                at = job2._adopted_state.get("autotune") or {}
                adopted_history_len = len(
                    (at.get("search") or {}).get("ys", []))
    else:
        timed_out = _phase(False, "rc")
    job2 = job_ref.get("job")
    diagnostics = None
    if timed_out:
        diagnostics = _attach_flight_recorder(
            timeout_diagnostics(workdir, job2), workdir)
    _disarm_trace()
    tuner = getattr(job2, "_tuner", None) if job2 is not None else None
    res = {
        "scenario": "autotune",
        "workdir": workdir,
        "timed_out": timed_out,
        "rc": result.get("rc"),
        "exc": result.get("rc_exc"),
        "crash_exc": result.get("rc1_exc"),  # must name DriverCrashed
        "records": read_records(workdir),
        "quarantined": [],
        "diagnostics": diagnostics,
        "adopted_history_len": adopted_history_len,
        "final_trials": tuner.search.n_trials if tuner is not None else None,
        "final_vector": (tuner.search.best_vector() if tuner is not None
                         and tuner.search.n_trials else None),
        "kv_restarts": 0,
        "host_health": (job2.driver.host_manager.host_health()
                        if job2 is not None else {}),
        "guard_reports": {},
    }
    if crash:
        # The fault-free twin the final vector must equal.
        res["baseline"] = run_autotune_scenario(
            workdir=os.path.join(workdir, "baseline"),
            timeout=max(30.0, deadline - time.time() + timeout / 2),
            seed=seed, crash=False)
    return res


def check_autotune_invariants(res: dict) -> List[str]:
    """Violated invariants of the autotune scenario ([] = survived)."""
    if res["timed_out"]:
        return ["autotune: job did not finish in time"]
    if res.get("exc"):
        return [f"autotune: driver raised {res['exc']}"]
    problems: List[str] = []
    if res["rc"] != 0:
        problems.append(f"autotune: job rc={res['rc']}, wanted 0")
    finals = [r for r in res["records"] if "autotune_final" in r]
    if not finals:
        return problems + ["autotune: no worker reported a final vector"]
    vectors = {json.dumps(r["autotune_final"], sort_keys=True)
               for r in finals}
    if len(vectors) != 1:
        problems.append(f"autotune: ranks disagree on the final vector: "
                        f"{vectors}")
    base = res.get("baseline")
    if base is not None:
        # A crash mid-search ends on the fault-free run's vector: resumed
        # from the journaled history, never re-learned.
        if "DriverCrashed" not in (res.get("crash_exc") or ""):
            problems.append(f"autotune: the driver never crashed (first "
                            f"phase: {res.get('crash_exc')!r})")
        if not res.get("adopted_history_len"):
            problems.append("autotune: the adopter held no journaled trial "
                            "history -- the search restarted")
        problems.extend(check_autotune_invariants(base))
        base_finals = [r for r in base.get("records", [])
                       if "autotune_final" in r]
        if base_finals:
            want = json.dumps(base_finals[-1]["autotune_final"],
                              sort_keys=True)
            got = json.dumps(finals[-1]["autotune_final"], sort_keys=True)
            if want != got:
                problems.append(f"autotune: the final vector after the "
                                f"crash ({got}) is not the fault-free "
                                f"run's ({want})")
        if (base.get("final_trials") is not None
                and res.get("final_trials") is not None
                and base["final_trials"] != res["final_trials"]):
            problems.append(f"autotune: trial count {res['final_trials']} "
                            f"!= fault-free {base['final_trials']}")
    # No mixed vector: every rank switched each trial at the same step
    # boundary to the same vector.
    by_trial: Dict[int, set] = {}
    for r in res["records"]:
        if "trial" in r and "at_step" in r:
            by_trial.setdefault(r["trial"], set()).add(
                (r["at_step"], json.dumps(r["vector"], sort_keys=True)))
    for trial, switches in sorted(by_trial.items()):
        if len(switches) != 1:
            problems.append(f"autotune: trial {trial} switched unevenly "
                            f"across ranks: {sorted(switches)}")
    # Every lockstep retrace rebuilt the same bucket layout on every rank.
    by_retrace: Dict[int, set] = {}
    for r in res["records"]:
        if "retrace_layout" in r:
            by_retrace.setdefault(r["retrace_n"], set()).add(
                tuple(r["retrace_layout"]))
    for n, layouts in sorted(by_retrace.items()):
        if len(layouts) != 1:
            problems.append(f"autotune: retrace {n} bucketed differently "
                            f"across ranks: {sorted(layouts)}")
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
    if name.startswith("stream"):
        return check_stream_invariants(res)
    if name == "autotune":
        return check_autotune_invariants(res)
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
        # The quant and silent updates are real training steps: their
        # finals are held to the fault-free run's, not to the analytic
        # value.
        if not name.startswith(("quant", "silent")) and any(
                abs(x - want) > 1e-9 for x in r["final_w"]):
            problems.append(f"{name}: {r['host']} final_w={r['final_w']}, "
                            f"wanted all {want}")
    sizes = {r["size"] for r in records if "size" in r}
    if name in ("crash", "hang"):
        gp = res.get("goodput")
        if gp is None:
            problems.append(f"{name}: driver goodput ledger missing")
        elif gp["totals"].get("rescale_downtime", 0.0) <= 0.0:
            problems.append(f"{name}: no rescale_downtime on the driver's "
                            f"ledger ({gp['totals']})")
    if name == "quant":
        problems.extend(_check_quant_invariants(res, finals))
    if name == "silent":
        problems.extend(_check_silent_invariants(res, finals))
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


def _baseline_finals(res: dict, name: str, problems: List[str]):
    base = res.get("baseline") or {}
    finals = [r for r in base.get("records", []) if "final_step" in r]
    if base.get("rc") != 0 or not finals:
        problems.append(f"{name}: fault-free baseline run failed "
                        f"(rc={base.get('rc')})")
        return None
    return finals


def _check_quant_invariants(res: dict, finals: List[dict]) -> List[str]:
    """The crashed and resumed int8 run ends on the fault-free run's
    parameters bit for bit, from a restore whose EF residuals were
    non-zero (they round-tripped through the checkpoint)."""
    problems: List[str] = []
    base = _baseline_finals(res, "quant", problems)
    if base is not None and finals[-1]["final_w"] != base[-1]["final_w"]:
        problems.append(
            "quant: post-crash final params diverge from the fault-free "
            f"baseline ({finals[-1]['final_w']} vs {base[-1]['final_w']}) "
            "-- the optimizer or EF state did not survive the restore")
    resumes = [r for r in res["records"] if "resumed_at" in r]
    if not resumes:
        problems.append("quant: worker never resumed from disk (the crash "
                        "did not fire or the restore was skipped)")
    elif not any((r.get("resume_residual_norm") or 0) > 0 for r in resumes):
        problems.append("quant: resumed EF residuals are all zero -- the "
                        "residual state did not round-trip")
    return problems


def _check_silent_invariants(res: dict, finals: List[dict]) -> List[str]:
    """Every fault fired, each was caught by the defense meant for it, and
    nothing corrupt survived."""
    from .. import checkpoint as _ckpt

    problems: List[str] = []
    base = _baseline_finals(res, "silent", problems)
    if base is not None:
        for r in finals:
            if r["final_w"] != base[-1]["final_w"]:
                problems.append(f"silent: {r['host']} final params diverge "
                                "from the fault-free baseline -- a fault "
                                "escaped the guard")
    # The NaN was screened on every rank, and the step retried (the step
    # totals above still match).
    if not finals or any(r.get("skipped_total", 0) < 1 for r in finals):
        problems.append("silent: a rank never skipped -- grad.nan did not "
                        "fire or the guard let it through")
    audits = [r["audit"] for r in res["records"]
              if r.get("audit", {}).get("diverged")]
    if not audits:
        problems.append("silent: no audit round saw the bitflip divergence")
    else:
        a = audits[0]
        if a.get("minority_hosts") != [SILENT_VICTIM]:
            problems.append(f"silent: audit localized "
                            f"{a.get('minority_hosts')}, wanted "
                            f"[{SILENT_VICTIM!r}]")
        if a.get("healed") != "resync":
            problems.append(f"silent: divergence healed by "
                            f"{a.get('healed')!r}, wanted 'resync'")
    if res.get("guard_reports", {}).get(SILENT_VICTIM, 0) < 1:
        problems.append("silent: the driver never consumed a divergence "
                        "report for the victim")
    if res.get("host_health", {}).get(SILENT_VICTIM, 0) < 1:
        problems.append("silent: the victim carries no health strike")
    if res["quarantined"]:
        problems.append(f"silent: corrupted checkpoints reached disk: "
                        f"{res['quarantined']}")
    ckdir = os.path.join(res["workdir"], "ckpt")
    steps = _ckpt.all_steps(ckdir) if os.path.isdir(ckdir) else []
    if not steps:
        problems.append("silent: no checkpoints were ever committed")
    for step_n in steps:
        bad = _ckpt.verify_step_dir(os.path.join(ckdir, f"step_{step_n}"))
        if bad:
            problems.append(f"silent: committed checkpoint step {step_n} "
                            f"fails integrity: {bad[:2]}")
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
