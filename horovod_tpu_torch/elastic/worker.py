"""Worker side of an elastic launch: notifications and the round (re)join.

The port of the JAX package's ``elastic/worker.py``. Parity:
``horovod/runner/elastic/worker.py`` (``WorkerNotificationService`` /
``WorkerNotificationManager`` -- the channel that delivers the driver's
host-change events to running workers so ``state.commit()`` can raise
``HostsUpdatedInterrupt``).

Workers poll the elastic rendezvous KV (the launcher's HTTP KV server, the
store that also bootstraps the ``torch.distributed`` world). The driver
publishes each membership change as a monotonically increasing timestamp
plus a *round*:

  - ``elastic/ts``                latest membership-change timestamp
  - ``elastic/round``             current round number N
  - ``round_N/ts``                the timestamp that created round N
  - ``round_N/size``              number of worker processes in round N
  - ``round_N/assign/<host_id>``  this host's world rank in round N

A worker joins the current round in ``context.init`` (:func:`join_world`,
which also points the world's store bootstrap at the round's own
``dist_N`` scope), is notified of newer rounds by
:class:`WorkerNotificationManager`, and rejoins on reset
(:func:`rejoin_world`: the world is torn down -- an NCCL world aborted
first -- joined again and re-initialized with the previous mesh's axes).
A worker whose host is absent from the new round has been scaled away and
exits cleanly. Besides: the heartbeat lease, the preemption (SIGTERM)
drain with its priority-checkpoint callbacks, and the clean-exit flag an
adopting driver reads.

Telemetry: :data:`join_retries`, :data:`last_join` (the round, the seconds
the join took and the wall times around it) and the heartbeat's ``beats``,
counted also as ``recovery.join_retries`` and ``recovery.heartbeats``; each
join records ``clock_sync`` observations of the driver's clock (the round's
timestamp and the driver's ``clock/now`` beacon), an ``elastic.join`` span
and the join's wait as ``rescale_downtime`` in the goodput ledger; a
SIGTERM dumps the flight recorder first.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import weakref
from typing import Optional, Tuple

from ..obs import goodput as _goodput
from ..obs import registry as _obs
from ..obs import trace as _trace
from ..utils import env as _env
from ..utils.retry import Backoff

__all__ = [
    "WorkerNotificationManager",
    "current_round",
    "heartbeat_pause",
    "heartbeat_resume",
    "heartbeat_start",
    "heartbeat_stop",
    "in_elastic_world",
    "install_preemption_handler",
    "join_world",
    "notification_manager",
    "preempt_requested",
    "publish_clean_exit",
    "register_preempt_callback",
    "rejoin_world",
    "run_preempt_checkpoint",
]

log = logging.getLogger("horovod_tpu_torch.elastic.worker")

# Env contract with the elastic driver (runner/elastic_driver.py).
ENV_ELASTIC = "HVDTPU_ELASTIC"
ENV_HOST_ID = "HVDTPU_HOST_ID"
ENV_NOTIFY_POLL = "HVDTPU_ELASTIC_POLL_SECS"

_DECOMMISSION_GRACE_SECS = 5.0
# How long a rejoin waits for a round newer than the one it failed in.
_NEW_ROUND_GRACE_SECS = 5.0

# Join telemetry (the registry's recovery.join_retries counts the same).
join_retries = 0  # KV outages and torn round publications ridden out
last_join: dict = {}  # {"round", "rank", "size", "t0", "t1", "secs"}


def _join_timeout() -> float:
    # Must exceed the driver's below-min_np hold (it waits up to 600 s for
    # the world to recover) -- a surviving worker that times out first
    # would die and get blacklisted as if it had failed.
    return float(os.environ.get("HVDTPU_ELASTIC_JOIN_TIMEOUT", "660"))


def _host_id() -> str:
    return os.environ.get(ENV_HOST_ID) or os.uname().nodename


def _kv_client():
    from ..runner.api import kv_client

    return kv_client()


def in_elastic_world() -> bool:
    """True when this process runs under an elastic launcher."""
    return (os.environ.get(ENV_ELASTIC) == "1"
            and bool(os.environ.get("HVDTPU_RENDEZVOUS_ADDR"))
            and bool(os.environ.get("HVDTPU_RENDEZVOUS_PORT")))


# The ts of the round this worker last joined; the notification manager's
# baseline, so an update published between join and watcher start is not
# missed (and one consumed by the join is not re-delivered).
_joined_ts = 0.0
_joined_round = -1
_fresh_join = False  # a join_world_env no context.init has used yet


def _count_retry() -> None:
    global join_retries
    join_retries += 1
    _obs.metrics().counter("recovery.join_retries").inc()


def join_world(timeout: Optional[float] = None, *,
               newer_than: int = -1, grace: float = 0.0) -> Tuple[int, int]:
    """Join the current elastic round: returns ``(rank, size)``.

    Blocks until a round containing this host exists. If the *current*
    round exists but excludes this host, the host was scaled away: wait a
    short grace period (the driver may be mid-publish) and exit 0.
    ``newer_than``/``grace``: for up to ``grace`` seconds, wait for a round
    after ``newer_than`` before joining that one again.
    """
    global _joined_ts, _joined_round, last_join
    if timeout is None:
        timeout = _join_timeout()
    client = _kv_client()
    host_id = _host_id()
    t0 = time.time()
    decommissioned_since: Optional[float] = None
    # Capped exponential backoff with jitter; reset only on progress (a
    # NEW round, or a fresh server identity), so the steady waiting state
    # does not herd the server.
    backoff = Backoff(base=0.05, cap=1.0)
    last_seen_round = -1
    last_epoch = None
    while True:
        try:
            if client.server_epoch != last_epoch:
                last_epoch = client.server_epoch
                backoff.reset()
            round_raw = client.get("elastic", "round")
            if round_raw is not None:
                n = int(round_raw)
                if n != last_seen_round:
                    last_seen_round = n
                    backoff.reset()
                if n <= newer_than and time.time() - t0 < grace:
                    backoff.sleep()
                    continue
                assign = client.get(f"round_{n}", f"assign/{host_id}")
                if assign is not None:
                    size = int(client.wait(f"round_{n}", "size", deadline=30.0))
                    ts = float(client.wait(f"round_{n}", "ts", deadline=30.0))
                    _joined_ts, _joined_round = ts, n
                    # The round ts is the driver's wall clock observed on
                    # this host's: the pair the trace merge recovers this
                    # process's offset from. A respawn may join a round
                    # published long ago, so the driver's poll-tick
                    # beacon is sampled too (the merge keeps the
                    # fresher).
                    _trace.clock_sync(ts, round=n)
                    try:
                        beacon = client.get("clock", "now")
                    except OSError:
                        beacon = None
                    if beacon is not None:
                        _trace.clock_sync(float(beacon), round=n,
                                          source="beacon")
                    t1 = time.time()
                    last_join = {"round": n, "rank": int(assign),
                                 "size": size, "t0": t0, "t1": t1,
                                 "secs": t1 - t0}
                    _trace.complete(
                        "elastic.join", "elastic", t0, t1 - t0,
                        args={"round": n, "rank": int(assign),
                              "size": size},
                    )
                    # The (re)join wait is world-rebuild downtime.
                    _goodput.record_rescale(t0, t1 - t0)
                    install_preemption_handler(host_id)
                    # The world's store address lives in this round's own
                    # scope, so a re-rendezvous never reads the address
                    # of a world torn down in an earlier round.
                    from ..runner.api import ENV_DIST_SCOPE

                    os.environ[ENV_DIST_SCOPE] = f"dist_{n}"
                    log.info(
                        "joined elastic round %d as rank %s/%d",
                        n, assign.decode(), size,
                    )
                    heartbeat_start(host_id)
                    return int(assign), size
                # Current round excludes us -> likely decommissioned.
                if decommissioned_since is None:
                    decommissioned_since = time.time()
                elif (
                    time.time() - decommissioned_since
                    > _DECOMMISSION_GRACE_SECS
                ):
                    if preempt_requested():
                        # Preemption drain, final leg: the priority
                        # checkpoint already ran at the last commit (run
                        # here too for a worker preempted between
                        # commits); flag the clean exit and leave.
                        run_preempt_checkpoint()
                        publish_clean_exit(host_id)
                        log.info(
                            "host %s drained for preemption; exiting",
                            host_id,
                        )
                        sys.exit(0)
                    log.info(
                        "host %s not in round %d; exiting (scaled away)",
                        host_id, n,
                    )
                    publish_clean_exit(host_id)
                    sys.exit(0)
        except TimeoutError as e:
            # Torn round publication: the round pointer exists but
            # size/ts never appeared -- re-read the round until the
            # deadline (a fresh publication supersedes the torn one).
            _count_retry()
            log.warning("round publication incomplete (%s); re-reading", e)
        except OSError as e:
            # Transient KV outage beyond the client's own retries: keep
            # polling until the join deadline -- the driver may be
            # restarting its server, which is recoverable, not fatal.
            _count_retry()
            log.warning("rendezvous unreachable (%s); retrying", e)
        if time.time() - t0 > timeout:
            raise TimeoutError("timed out waiting to join an elastic round")
        backoff.sleep()


def join_world_env(timeout: Optional[float] = None,
                   **kwargs) -> Tuple[int, int]:
    """:func:`join_world`, then the rank variables ``context.init`` reads
    (one process per host: local rank 0 of 1)."""
    global _fresh_join
    rank, size = join_world(timeout, **kwargs)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    _fresh_join = True
    return rank, size


def consume_join() -> bool:
    """True once after :func:`join_world_env`: ``context.init`` then
    forms the world of that join instead of joining again."""
    global _fresh_join
    fresh, _fresh_join = _fresh_join, False
    return fresh


def _mesh_kwargs(prev) -> dict:
    """``context.init``'s mesh arguments that rebuild ``prev``'s axes on
    the world of the moment: the default ``hvd`` axis and the
    hierarchical ``(cross, local)`` pair resize with it; other meshes
    keep their axis sizes (and raise if they no longer cover it)."""
    from .. import context as _ctx

    names = prev.mesh.axis_names
    if names == (_ctx.WORLD_AXIS,):
        return {}
    if names == (_ctx.CROSS_AXIS, _ctx.LOCAL_AXIS):
        return {"hierarchical": True}
    return {"mesh": dict(prev.mesh.shape), "world_axes": prev.world_axes}


def form_world(init, *, newer_than: int = -1,
               grace: float = 0.0):
    """Join the current round and form its world with ``init()``, retried
    within the join deadline; returns what ``init`` returns.

    A world forms only while every rank of the round sits in the same
    attempt: rank 0's store lives as long as its own attempt, so a peer
    that arrives as it times out sees the connection close. That surfaces
    as a failed init, not a corrupted one -- the next attempt re-reads the
    round (which may have advanced) and converges. ``newer_than``/``grace``
    apply to the first join only (see :func:`join_world`)."""
    from .. import context as _ctx
    from ..exceptions import HorovodInternalError, HorovodTpuError

    deadline = time.time() + _join_timeout()
    while True:
        _ctx.shutdown(abort=True)
        join_world_env(timeout=max(1.0, deadline - time.time()),
                       newer_than=newer_than, grace=grace)
        newer_than = -1
        try:
            return init()
        except (HorovodInternalError, HorovodTpuError, RuntimeError) as e:
            if time.time() > deadline:
                raise
            _count_retry()
            log.warning("elastic join attempt failed (%s); retrying", e)
            time.sleep(0.2)


def rejoin_world() -> Tuple[int, int]:
    """Tear the world down and join the (new) current round.

    Called from ``State.reset()`` after a ``HostsUpdatedInterrupt`` or a
    collective failure. The default group and every mesh group go through
    ``context.shutdown(abort=True)`` (an NCCL world is aborted first, so
    a dead peer cannot hang the teardown); the world is initialized again
    with the previous context's device, backend and mesh axes
    (:func:`form_world`). May ``sys.exit(0)`` when this host was removed.
    """
    from .. import context as _ctx

    prev = _ctx.context() if _ctx.is_initialized() else None

    def init():
        if prev is None:
            return last_join["rank"], last_join["size"]
        backend = prev.backend or (
            "nccl" if prev.device.type == "cuda" else "gloo")
        c = _ctx.init(prev.device, backend=backend, **_mesh_kwargs(prev))
        return c.rank, c.size

    # After a failure the driver republishes once it reaps the dead
    # worker: joining the failed round again would only wait out the
    # store's timeout for a peer that never comes.
    return form_world(init, newer_than=_joined_round,
                      grace=_NEW_ROUND_GRACE_SECS)


# ---- heartbeat lease ----------------------------------------------------
#
# Hung workers are invisible to the driver's reap loop: a process stuck
# mid-collective never exits. Each worker publishes ``heartbeat/<host_id>
# = wall-clock ts`` every ``HVDTPU_HEARTBEAT_SECS``; the driver treats a
# lease older than ``HVDTPU_HEARTBEAT_TIMEOUT_SECS`` as a hang (blacklist +
# republish). The thread is a daemon and dies with the process.


class _Heartbeat:
    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._paused = threading.Event()
        self.beats = 0

    def start(self, host_id: str) -> bool:
        period = _env.heartbeat_secs()
        if period <= 0 or not in_elastic_world():
            return False
        with self._lock:
            if self._thread is not None:
                return True
            self._stop.clear()
            self._paused.clear()
            self._thread = threading.Thread(
                target=self._beat, args=(host_id, period), daemon=True,
                name="hvdtpu-heartbeat",
            )
            self._thread.start()
            return True

    def _beat(self, host_id: str, period: float):
        # The first beat goes out at once: a worker that freezes before
        # its first period has ended must still hold a lease that expires.
        client = _kv_client()
        beats = _obs.metrics().counter("recovery.heartbeats")
        wait = 0.0
        while not self._stop.wait(wait):
            wait = period
            if self._paused.is_set():
                continue
            try:
                client.put("heartbeat", host_id, repr(time.time()).encode())
                self.beats += 1
                beats.inc()
            except OSError:
                # Driver briefly unreachable: the lease just ages; the
                # driver's timeout is many periods wide for this reason.
                pass

    def pause(self):
        self._paused.set()

    def resume(self):
        self._paused.clear()

    def stop(self):
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


_heartbeat = _Heartbeat()


def heartbeat_start(host_id: str) -> bool:
    """Start the lease thread (idempotent; no-op outside elastic runs or
    with ``HVDTPU_HEARTBEAT_SECS<=0``)."""
    return _heartbeat.start(host_id)


def heartbeat_pause() -> None:
    """Stop publishing beats without stopping the thread -- what the
    chaos ``hang`` action uses so a simulated freeze loses its lease."""
    _heartbeat.pause()


def heartbeat_resume() -> None:
    _heartbeat.resume()


def heartbeat_stop() -> None:
    _heartbeat.stop()


# ---- preemption grace ----------------------------------------------------
#
# A SIGTERM eviction notice becomes a graceful shrink instead of a
# blacklisted failure:
#
#   1. the handler (installed by join_world) sets a process-local flag and
#      publishes ``preempt/<host_id>`` from a side thread;
#   2. the driver consumes the flag and republishes a round WITHOUT this
#      host (ElasticJob._check_preemptions);
#   3. at the next commit, State.commit sees the flag and runs the
#      registered priority checkpoint;
#   4. the commit's host-update check raises HostsUpdatedInterrupt on
#      every rank at once, the rejoin finds this host absent from the
#      round, and the decommission path publishes ``exit/<host_id>=0``.

_preempt_flag = threading.Event()
_preempt_ckpt_done = threading.Event()
_preempt_callbacks: list = []
_preempt_cb_lock = threading.Lock()


def preempt_requested() -> bool:
    """Has this process received a preemption notice (SIGTERM)?"""
    return _preempt_flag.is_set()


def register_preempt_callback(fn) -> None:
    """Register a priority-checkpoint hook run ONCE at the first commit
    (or decommission exit) after a preemption notice -- typically
    ``lambda: checkpoint.priority_checkpoint(dir, state, step)``."""
    with _preempt_cb_lock:
        _preempt_callbacks.append(fn)


def clear_preempt_callbacks() -> None:
    with _preempt_cb_lock:
        _preempt_callbacks.clear()


def run_preempt_checkpoint() -> bool:
    """Run the registered priority-checkpoint hooks exactly once per
    preemption. Each runs under two bounded attempts with a deadline (the
    canonical callback retries its own I/O); a failing hook is logged and
    the drain proceeds. Returns True when the hooks ran on this call."""
    from ..utils.retry import retry_call

    if not _preempt_flag.is_set() or _preempt_ckpt_done.is_set():
        return False
    _preempt_ckpt_done.set()
    with _preempt_cb_lock:
        callbacks = list(_preempt_callbacks)
    for fn in callbacks:
        try:
            retry_call(fn, attempts=2, retry_on=(OSError,), deadline=10.0)
        except Exception as e:  # noqa: BLE001 - the drain must proceed
            log.error("preemption priority checkpoint failed: %s", e)
    return True


def _publish_preempt(host_id: str) -> None:
    client = _kv_client()
    if client is None:
        return
    try:
        client.put("preempt", host_id, repr(time.time()).encode())
    except OSError:
        log.warning("could not publish preemption flag (KV unreachable)")


def install_preemption_handler(host_id: str) -> bool:
    """Install the SIGTERM grace handler (idempotent; main thread only --
    ``signal.signal`` raises elsewhere, and workers join from their main
    thread)."""
    import signal as _signal

    def _handler(signum, frame):
        # Flight recorder first, at both notices: this handler replaces
        # the trace plane's chained SIGTERM hook, so the dump must happen
        # here or an evicted or hung worker ships no timeline.
        _trace.flight_dump("sigterm")
        if _preempt_flag.is_set():
            # Second notice: the platform (or the driver's teardown)
            # means it -- die like a default SIGTERM.
            _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
            os.kill(os.getpid(), _signal.SIGTERM)
            return
        _preempt_flag.set()
        log.warning(
            "SIGTERM received: draining for preemption (finish step, "
            "priority checkpoint, clean exit)"
        )
        # KV I/O from a side thread, never inside the handler frame.
        threading.Thread(
            target=_publish_preempt, args=(host_id,), daemon=True,
            name="hvdtpu-preempt-flag",
        ).start()

    try:
        _signal.signal(_signal.SIGTERM, _handler)
        return True
    except ValueError:
        return False  # not the main thread (in-process test harness)


def _reset_preempt_for_tests() -> None:
    _preempt_flag.clear()
    _preempt_ckpt_done.clear()
    clear_preempt_callbacks()


def joined_ts() -> float:
    """The timestamp of the round this worker has joined (0.0 before the
    first join, and outside an elastic launch)."""
    return _joined_ts


def current_round() -> int:
    """The elastic round this worker has JOINED (-1 before the first
    join)."""
    return _joined_round


def tune_config_source():
    """This worker's view of the autotune rollout protocol: a
    ``KVConfigSource`` bound to the elastic KV client and this host's id
    (the ``autotune/score/<host>`` reporting key). None outside an
    elastic world: the step wrapper then runs its own local search."""
    if not in_elastic_world():
        return None
    from ..tune.rollout import KVConfigSource

    host_id = os.environ.get(ENV_HOST_ID) or os.uname().nodename
    return KVConfigSource(_kv_client(), host_id)


def cert_channel():
    """This worker's view of the SPMD certification preflight protocol:
    a ``KVCertChannel`` bound to the elastic KV client, this host's id,
    the joined round and the round's world size (the ``round_N/size``
    entry: how many fingerprints the gate must collect before it can
    certify). None outside an elastic world, before the first join, or
    when the KV is unreachable: the step's preflight then skips (a
    standalone process has nobody to diverge from)."""
    if not in_elastic_world():
        return None
    round_ = current_round()
    if round_ < 0:
        return None
    client = _kv_client()
    try:
        size_raw = client.get(f"round_{round_}", "size")
    except OSError:
        return None
    if size_raw is None:
        return None
    try:
        n_hosts = int(size_raw.decode() if isinstance(size_raw, bytes)
                      else size_raw)
    except ValueError:
        return None
    from ..analysis.certify import KVCertChannel

    return KVCertChannel(client, _host_id(), round_, n_hosts)


def publish_clean_exit(host_id: Optional[str] = None) -> None:
    """Durably flag a clean exit (``exit/<host_id> = 0``) just before
    leaving: an adopted driver has no ``Popen`` handle to read a
    non-child's exit status from, so this KV flag is how a vanished pid
    is told apart from a crash (``runner.api._AdoptedJob``). A no-op
    outside an elastic launch."""
    if not in_elastic_world():
        return
    if host_id is None:
        host_id = _host_id()
    client = _kv_client()
    try:
        client.put("exit", host_id, b"0")
    except OSError:
        pass  # best-effort; an unreachable KV means nobody is adopting


class WorkerNotificationManager:
    """Polls the KV for membership changes; fans out to registered states
    (``state.on_hosts_updated(timestamp, res)``, the reference's listener
    contract). Outside an elastic launch :meth:`init` starts nothing and
    returns False. The watcher is a daemon thread; :meth:`stop` ends it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # Weak references: a State registers itself at construction, so a
        # strong list would pin every state for the process lifetime.
        self._listeners: "weakref.WeakSet" = weakref.WeakSet()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_ts = 0.0

    def init(self) -> bool:
        """Start the watcher if running under an elastic launcher."""
        with self._lock:
            if self._thread is not None:
                return True
            if not in_elastic_world():
                return False
            baseline = _joined_ts
            if baseline == 0.0:
                # State constructed before the round join: the current
                # published ts is not news -- only later changes are.
                client = _kv_client()
                try:
                    raw = client.get("elastic", "ts")
                    if raw is not None:
                        baseline = float(raw)
                except OSError:
                    pass
            self._last_ts = baseline
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch, daemon=True, name="hvdtpu-notify")
            self._thread.start()
            return True

    def register_listener(self, state) -> None:
        with self._lock:
            self._listeners.add(state)

    def remove_listener(self, state) -> None:
        with self._lock:
            self._listeners.discard(state)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def _watch(self):
        poll = float(os.environ.get(ENV_NOTIFY_POLL, "1.0"))
        client = _kv_client()
        while not self._stop.wait(poll):
            try:
                raw = client.get("elastic", "ts")
            except OSError:
                continue  # driver restarting its KV server; retry
            if raw is None:
                continue
            ts = float(raw)
            if ts <= self._last_ts:
                continue
            self._last_ts = ts
            with self._lock:
                listeners = list(self._listeners)
            log.info("hosts updated (ts=%s); notifying %d states", ts,
                     len(listeners))
            for state in listeners:
                state.on_hosts_updated(ts, None)


notification_manager = WorkerNotificationManager()
