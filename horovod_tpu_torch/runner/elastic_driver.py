"""Elastic driver: host discovery, blacklisting, state-preserving restarts.

The port of the JAX package's ``runner/elastic_driver.py``. Parity:
``horovod/runner/elastic/`` -- ``discovery.py`` (``HostManager:79``,
``HostDiscoveryScript:130``, ``FixedHosts:155``, blacklisting
``:41-47,102-107``) and ``driver.py`` (``ElasticDriver:68``: discovery
thread ``:177-196``, assignment updates ``:228-270``, worker-exit handling
``:292-308``).

The schedulable unit is a host, with one worker process per discovered
host (``assign/<host_id>``), as in the JAX package; every test and the
card run ``host:1``, so a worker is one card. Membership changes publish
a new round that the workers rejoin in place (:class:`ElasticJob`), and
in-process state survives through :func:`horovod_tpu_torch.elastic.run`'s
sync/restore loop.

Telemetry is kept in plain attributes until the metrics plane (A14):
``HostManager.blacklist_events`` / ``penalties`` / ``readmissions`` and
``ElasticJob.rescale_events`` / ``lease_expiries`` /
``guard_report_events`` / ``adoptions``; the driver's autotune rollout
(``autotune=True`` / ``HVDTPU_AUTOTUNE``) raises, naming A14.
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

from .api import launch_job
from .hosts import HostInfo
from ..utils import env as _env

log = logging.getLogger("horovod_tpu_torch.elastic.driver")

DISCOVER_HOSTS_FREQUENCY_SECS = 1.0


class HostDiscovery:
    """Interface: return the currently-available hosts."""

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        raise NotImplementedError


class FixedHosts(HostDiscovery):
    """Static host set (tests / fixed clusters; reference ``:155``)."""

    def __init__(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)

    def set(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class HostDiscoveryScript(HostDiscovery):
    """Executable script printing ``host:slots`` per line (``:130``)."""

    def __init__(self, script: str, default_slots: int = 1):
        self._script = script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.run(
            [self._script], capture_output=True, text=True, timeout=60
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"host discovery script failed rc={out.returncode}: "
                f"{out.stderr[:200]}"
            )
        hosts: Dict[str, int] = {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                name, slots = line.rsplit(":", 1)
                hosts[name] = int(slots)
            else:
                hosts[line] = self._default_slots
        return hosts


class _HostHealth:
    """Per-host failure score backing cooldown/probation decisions."""

    __slots__ = ("strikes", "until")

    def __init__(self):
        self.strikes = 0
        self.until = 0.0  # blacklist expiry (inf = permanent)


# Cooldown doubles per strike, capped at this multiple of the base -- a
# host flapping every probation window converges to a long (but finite)
# sit-out instead of monopolizing rescale churn or being lost forever.
_COOLDOWN_MAX_FACTOR = 8


class HostManager:
    """Tracks available hosts minus the blacklist (reference ``:79``).

    Blacklisting carries a per-host health score: each failure is a
    *strike*, and with ``HVDTPU_BLACKLIST_COOLDOWN`` (or ``cooldown=``)
    set, a struck host sits out ``cooldown * 2**(strikes-1)`` seconds
    (capped) and then re-enters discovery on probation -- a once-flaky
    host is not lost for the job's lifetime, while a repeat offender's
    sit-out doubles each time. Cooldown 0 (the default) keeps the
    reference's permanent exile."""

    def __init__(self, discovery: HostDiscovery,
                 cooldown: Optional[float] = None):
        self._discovery = discovery
        self._blacklist: Dict[str, _HostHealth] = {}
        self._current: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._cooldown = (
            cooldown if cooldown is not None else _env.blacklist_cooldown()
        )
        self.blacklist_events = 0
        self.penalties = 0
        self.readmissions = 0

    @property
    def current_hosts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._current)

    def blacklist(self, host: str) -> None:
        now = time.time()
        with self._lock:
            health = self._blacklist.setdefault(host, _HostHealth())
            health.strikes += 1
            if self._cooldown <= 0:
                health.until = float("inf")
            else:
                factor = min(2 ** (health.strikes - 1), _COOLDOWN_MAX_FACTOR)
                health.until = now + self._cooldown * factor
            self._current.pop(host, None)
            self.blacklist_events += 1
        log.info("blacklisted host %s (%d strike(s))", host, health.strikes)

    def penalize(self, host: str) -> None:
        """Add a health strike WITHOUT blacklisting -- the bookkeeping
        half of probation. A silently-diverged host that was healed by
        resync (``horovod_tpu.guard``) keeps serving, but its next
        blacklist sits out longer (the cooldown doubles per strike), so
        a once-flaky DIMM and a repeat offender are priced differently."""
        with self._lock:
            health = self._blacklist.setdefault(host, _HostHealth())
            health.strikes += 1
            self.penalties += 1

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            health = self._blacklist.get(host)
            return health is not None and health.until > time.time()

    def host_health(self) -> Dict[str, int]:
        """Strike count per host that ever failed (probationers keep
        their score -- the next strike doubles their cooldown)."""
        with self._lock:
            return {h: s.strikes for h, s in self._blacklist.items()}

    def health_snapshot(self) -> Dict[str, Dict[str, float]]:
        """JSON-able blacklist/probation ledger (strikes + expiry per
        host) -- what the control-plane journal persists so a respawned
        driver prices a repeat offender like the dead one did."""
        with self._lock:
            return {
                h: {"strikes": s.strikes, "until": s.until}
                for h, s in self._blacklist.items()
            }

    def restore_health(self, snapshot: Dict[str, Dict[str, float]]) -> None:
        """Adopt a journaled ledger (inverse of :meth:`health_snapshot`).
        ``inf`` expiries survive the JSON round-trip as the float the
        snapshot recorded."""
        with self._lock:
            for host, rec in snapshot.items():
                health = self._blacklist.setdefault(host, _HostHealth())
                health.strikes = int(rec.get("strikes", 0))
                health.until = float(rec.get("until", 0.0))

    def update_available_hosts(self) -> bool:
        """Refresh from discovery; True when membership changed.
        Expired-cooldown hosts re-enter here (probation)."""
        found = self._discovery.find_available_hosts_and_slots()
        now = time.time()
        readmitted = []
        with self._lock:
            filtered = {}
            for h, s in found.items():
                health = self._blacklist.get(h)
                if health is not None and health.until > now:
                    continue
                if health is not None and h not in self._current:
                    readmitted.append((h, health.strikes))
                filtered[h] = s
            changed = filtered != self._current
            self._current = filtered
        for h, strikes in readmitted:
            log.info(
                "host %s re-enters discovery on probation "
                "(%d strike(s))", h, strikes,
            )
            self.readmissions += 1
        return changed


class ElasticDriver:
    """Polls discovery on a thread; exposes membership-change events and
    slot waiting (reference ``ElasticDriver:68``)."""

    def __init__(
        self,
        discovery: HostDiscovery,
        min_np: int = 1,
        max_np: Optional[int] = None,
        on_hosts_updated: Optional[Callable[[float], None]] = None,
        scale_policy=None,
        policy_gauges: Optional[Callable[[], Dict[str, float]]] = None,
    ):
        if scale_policy is not None:
            # Load-driven elastic scaling (the serving workload): wrap
            # discovery so the policy's target trims/regrows the host
            # set -- a rescale then rides the ordinary membership-change
            # path (round republish, drain, spawn). ``policy_gauges``
            # supplies the load observation (queue_depth/in_flight).
            from ..elastic.scale import PolicyDiscovery

            discovery = PolicyDiscovery(
                discovery, scale_policy, policy_gauges or (lambda: {})
            )
        self.host_manager = HostManager(discovery)
        self.min_np = min_np
        self.max_np = max_np
        self._on_hosts_updated = on_hosts_updated
        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self.host_manager.update_available_hosts()
        self._thread = threading.Thread(target=self._discover_loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._shutdown.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _discover_loop(self):
        while not self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_SECS):
            try:
                changed = self.host_manager.update_available_hosts()
            except Exception as e:  # discovery hiccup: keep last known
                log.warning("host discovery failed: %s", e)
                continue
            if changed:
                self._wake.set()
                if self._on_hosts_updated:
                    self._on_hosts_updated(time.time())

    def wait_for_available_slots(self, min_np: int, timeout: float = 600.0):
        """Block until at least ``min_np`` slots exist (reference
        ``:228-243`` semantics)."""
        t0 = time.time()
        while time.time() - t0 < timeout:
            hosts = self.host_manager.current_hosts
            if sum(hosts.values()) >= min_np:
                return hosts
            self._wake.wait(timeout=DISCOVER_HOSTS_FREQUENCY_SECS)
            self._wake.clear()
        raise TimeoutError(
            f"timed out waiting for {min_np} slots "
            f"(have {sum(self.host_manager.current_hosts.values())})"
        )

    def consume_membership_change(self) -> bool:
        changed = self._wake.is_set()
        self._wake.clear()
        return changed


class DriverCrashed(RuntimeError):
    """Raised by the ``driver.crash`` chaos site inside
    :meth:`ElasticJob.run`: models the driver process dying hard --
    cleanup is intentionally skipped (workers stay alive, the KV
    listener dies with the driver), so a harness can exercise the
    ``--adopt`` recovery against genuinely orphaned workers without
    ``os._exit``-ing the test process."""


# rc for a driver that exited on SIGTERM leaving live workers behind for
# an adopter (EX_TEMPFAIL: "try again", which --adopt literally does).
ADOPTABLE_EXIT_CODE = 75


class ElasticJob:
    """Round-based elastic job: workers stay alive across membership
    changes and re-rendezvous in place.

    The reference analog is ``launch_gloo_elastic`` + ``ElasticDriver`` +
    ``WorkerNotificationService`` (``runner/elastic/driver.py:198-308``):
    the driver keeps one persistent rendezvous, publishes every membership
    change as a new *round* (assignments + timestamp in the KV), and the
    workers' notification watchers (``horovod_tpu.elastic.worker``) deliver
    the change so ``state.commit()`` raises ``HostsUpdatedInterrupt`` and
    the worker rejoins -- preserving in-memory state. Only hosts that newly
    appear get a fresh process; hosts that leave exit themselves.

    World-size semantics: one worker *process* per host, as in the JAX
    package, so the published round size counts hosts, while
    ``min_np``/``max_np`` count slots exactly as the reference counts
    GPUs. Every configuration the port runs elastic is ``host:1``: one
    worker, one card.
    """

    def __init__(
        self,
        command: List[str],
        driver: ElasticDriver,
        *,
        max_np: Optional[int] = None,
        reset_limit: Optional[int] = None,
        extra_env: Optional[Dict[str, str]] = None,
        verbose: bool = False,
        poll_interval: float = 0.2,
        output_dir: Optional[str] = None,
        drain_timeout: Optional[float] = None,
        journal_dir: Optional[str] = None,
        adopt: bool = False,
        autotune: Optional[bool] = None,
    ):
        from .http_server import RendezvousServer
        from .secret import make_secret_key

        self.output_dir = output_dir
        self.command = command
        self.driver = driver
        self.max_np = max_np
        self.reset_limit = reset_limit
        self.extra_env = dict(extra_env or {})
        self.verbose = verbose
        self.poll_interval = poll_interval
        # Control-plane durability: with a journal every KV mutation and
        # driver-state change is persisted, so a respawned driver can
        # ``adopt=True`` its way back to the exact pre-crash state --
        # including the HMAC secret and KV port the in-flight workers
        # were spawned with (their env is immutable; the adopter must
        # come back AS the server they know).
        if journal_dir is None:
            journal_dir = _env.get_str(_env.JOURNAL_DIR, None)
        self.journal = None
        self._adopted_state: Optional[Dict] = None
        self._epoch_gen = 0  # driver incarnation; +1 per adoption
        if journal_dir:
            from .journal import ControlPlaneJournal

            self.journal = ControlPlaneJournal(journal_dir)
        secret, recovered_store = make_secret_key(), None
        if adopt:
            if self.journal is None:
                raise ValueError("adopt=True needs a journal_dir")
            recovered_store, state = self.journal.recover()
            if state:
                self._adopted_state = state
                secret = state.get("secret") or secret
                self._epoch_gen = int(state.get("epoch", 0)) + 1
            else:
                log.warning(
                    "adopt requested but the journal holds no driver "
                    "state; starting fresh"
                )
                recovered_store = None
        self._recovered_store = recovered_store
        # Per-job HMAC key shared with every worker across all rounds.
        self.server = RendezvousServer(secret=secret, journal=self.journal)
        self._round = -1
        self._ordered: List[str] = []  # host_id -> rank is the list index
        self._assignment: Dict[str, int] = {}
        self._procs: Dict[str, object] = {}  # host_id -> api._Job
        # Heartbeat-lease books, all in DRIVER wall-clock time (worker
        # beat values are opaque change tokens -- never compared against
        # this process's clock, so cross-host skew cannot masquerade as
        # a hang or mask one):
        #   _hb_baseline: the KV beat value at spawn time (possibly a
        #     dead predecessor's); the lease starts only once the value
        #     CHANGES, so a respawn is never blamed for stale beats.
        #   _hb_seen: (last value, driver time it last changed).
        self._hb_baseline: Dict[str, object] = {}
        self._hb_seen: Dict[str, tuple] = {}
        self._resets = 0
        self._completed: set = set()  # hosts whose worker exited rc=0
        # Heartbeat-lease expiry: how stale a worker's beat may be before
        # the driver treats it as hung (see _check_leases).
        self._hb_timeout = _env.heartbeat_timeout_secs()
        # Silent-divergence reports from the workers' consistency audits
        # (guard KV scope): host -> (last value consumed, driver-side
        # strike tally). Below the blacklist threshold a report only
        # adds a health strike; at it, the host is killed and
        # blacklisted (see _check_guard_reports).
        self._guard_reports: Dict[str, tuple] = {}
        self._guard_blacklist_after = _env.guard_blacklist_after()
        # Preemption-grace books: host -> driver time the preempt flag
        # was consumed. A marked host is excluded from round selection
        # (the next round SHRINKS instead of blacklisting the evicted
        # host) until the mark expires (HVDTPU_PREEMPT_COOLDOWN_SECS) --
        # by then the VM is either gone from discovery or genuinely
        # back and welcome to rejoin.
        self._preempted: Dict[str, float] = {}
        self._preempt_cooldown = _env.preempt_cooldown_secs()
        # Closed-loop autotuner (HVDTPU_AUTOTUNE=1 / autotune=True): the
        # rollout coordinator comes with A14; armed, it raises.
        self._tuner = None
        if autotune if autotune is not None else _env.autotune_default():
            raise NotImplementedError(
                "the elastic driver's autotune rollout is not ported yet; "
                "it arrives with A14")
        # Telemetry (A14 turns these into registry counters).
        self.rescale_events = 0
        self.lease_expiries = 0
        self.guard_report_events = 0
        self.adoptions = 0
        # Driver-clock times of this job's events, for a time-to-recover
        # split: (kind, host or round, time.time()).
        self.events: List[tuple] = []
        self.adopted_hosts: List[str] = []  # filled by _adopt_workers
        # Set when this incarnation must die WITHOUT tearing workers
        # down: driver.crash chaos (hard) or SIGTERM handoff (graceful).
        self._leave_workers_running = False
        self._preempt_exit = threading.Event()
        self._nic_probe_decided = False
        self._nic_probe_on = False
        # How long stragglers may keep finishing their last epoch after
        # the first clean exit before they are force-terminated (ADVICE
        # r2: 30 s killed workers mid-commit while the job reported 0).
        self.drain_timeout = (
            drain_timeout
            if drain_timeout is not None
            else float(os.environ.get("HVDTPU_ELASTIC_DRAIN_TIMEOUT", "300"))
        )

    # ---- durability (journal + adoption) ----------------------------------

    def _driver_state(self) -> Dict:
        """The authoritative driver state the journal persists: enough
        for a respawned driver to resume the current round without
        touching a single healthy worker."""
        import base64

        return {
            "round": self._round,
            "ordered": list(self._ordered),
            "assignment": dict(self._assignment),
            "completed": sorted(self._completed),
            "resets": self._resets,
            "blacklist": self.driver.host_manager.health_snapshot(),
            "guard_reports": {
                h: [base64.b64encode(raw).decode("ascii"), strikes]
                for h, (raw, strikes) in self._guard_reports.items()
            },
            "preempted": dict(self._preempted),
            "pids": {
                h: job.pid for h, job in self._procs.items()
                if getattr(job, "pid", None) is not None
            },
            # /proc start times, the pid-reuse defense: an adopter only
            # re-attaches a pid whose identity still matches.
            "pid_starts": {
                h: job.start_time for h, job in self._procs.items()
                if getattr(job, "start_time", None) is not None
            },
            "secret": self.server.secret,
            "port": self.server.port if self.server._server else None,
            "epoch": self._epoch_gen,
        }

    def _journal_state(self) -> None:
        if self.journal is not None:
            self.journal.record_driver(self._driver_state())

    def _restore_adopted_state(self) -> None:
        """Reconstruct this driver's books from the journaled state of
        the dead incarnation (round, membership, blacklist/probation
        ledger, guard strike tallies, preemption marks)."""
        import base64

        state = self._adopted_state
        self._round = int(state.get("round", -1))
        self._ordered = list(state.get("ordered", []))
        self._assignment = {
            h: int(r) for h, r in state.get("assignment", {}).items()
        }
        self._completed = set(state.get("completed", []))
        self._resets = int(state.get("resets", 0))
        self.driver.host_manager.restore_health(state.get("blacklist", {}))
        self._guard_reports = {
            h: (base64.b64decode(raw.encode("ascii")), int(strikes))
            for h, (raw, strikes) in state.get("guard_reports", {}).items()
        }
        self._preempted = {
            h: float(t) for h, t in state.get("preempted", {}).items()
        }

    def _adopt_workers(self) -> None:
        """Re-attach to workers the dead driver spawned, from their
        journaled pids: a live pid becomes an :class:`api._AdoptedJob`
        (exit status read back from the workers' ``exit/<host>`` KV
        flag); a pid that died during the outage is simply absent -- the
        ordinary ``_spawn_missing`` respawns it into the SAME round.
        Healthy workers are never killed or restarted; they only ever
        blocked on KV availability."""
        from . import api

        pids = self._adopted_state.get("pids", {})
        pid_starts = self._adopted_state.get("pid_starts", {})
        exit_reader = lambda h: self.server.scope_items("exit").get(h)  # noqa: E731
        adopted = self.adopted_hosts = []
        for host in self._ordered:
            if host in self._completed:
                continue
            pid = pids.get(host)
            if pid is None:
                continue
            if not api._is_local(host):
                # Remote workers ride an ssh supervisor that died with
                # the driver -- the far end is unreachable by pid, but
                # may well still be alive and stepping (the data
                # plane needs no KV). Blind-respawning would put TWO
                # workers with one HVDTPU_HOST_ID into the round, so
                # adopt BLIND instead: the exit flag decides a clean
                # finish, the heartbeat lease decides death (expiry ->
                # blacklist -> probation respawn, the ordinary path).
                job = api._AdoptedJob(host, None, exit_reader)
                if job.poll() is None:
                    self._procs[host] = job
                    adopted.append(host)
                    self._hb_baseline[host] = None
                    self._hb_seen.pop(host, None)
                    log.info(
                        "blind-adopted remote worker on %s (liveness "
                        "delegated to its heartbeat lease)", host,
                    )
                continue
            want_start = pid_starts.get(host)
            have_start = api._pid_start_time(int(pid))
            if (want_start is not None and have_start is not None
                    and int(want_start) != int(have_start)):
                # The pid was recycled by an unrelated process during
                # the outage: the worker is dead -- never signal the
                # stranger; the respawn path takes over.
                log.warning(
                    "worker pid %s on %s was reused by another process "
                    "(start %s != journaled %s); respawning",
                    pid, host, have_start, want_start,
                )
                continue
            job = api._AdoptedJob(host, int(pid), exit_reader)
            if job.poll() is None:
                self._procs[host] = job
                adopted.append(host)
                # The predecessor's lease books died with it: adopted
                # workers are live *now* (their beats keep changing),
                # so a fresh baseline-free watch starts the lease at
                # the first observed change.
                self._hb_baseline[host] = None
                self._hb_seen.pop(host, None)
        self.adoptions += 1
        log.info(
            "adopted driver epoch %d: round %d, %d live worker(s) "
            "re-attached (%s), %d respawn candidate(s)",
            self._epoch_gen, self._round, len(adopted), ",".join(adopted),
            len([h for h in self._assignment if h not in self._procs
                 and h not in self._completed]),
        )

    def _blacklist(self, host: str) -> None:
        """Blacklist a failed (crashed, hung or diverged) host. It also
        loses its place in the rank order: when it returns it joins at the
        tail, so rank 0 -- the state every (re)start syncs from -- stays a
        survivor even when the driver held the round below ``min_np``
        until the same host came back."""
        self.driver.host_manager.blacklist(host)
        if host in self._ordered:
            self._ordered.remove(host)

    # ---- round publication ------------------------------------------------

    def _select_hosts(self, hosts_map: Dict[str, int]) -> List[str]:
        """Stable rank order: survivors keep their relative order (so the
        state-holding rank 0 stays rank 0 while it lives), new hosts append
        in sorted order; ``max_np`` trims from the tail. Hosts draining
        for preemption are excluded while their mark is fresh -- the
        round shrinks gracefully instead of waiting for discovery to
        notice the eviction."""
        hosts_map = {
            h: s for h, s in hosts_map.items() if h not in self._preempted
        }
        survivors = [h for h in self._ordered if h in hosts_map]
        new = sorted(h for h in hosts_map if h not in survivors)
        ordered = survivors + new
        if self.max_np:
            total, kept = 0, []
            for h in ordered:
                # Hard cap: never exceed max_np slots -- except that the
                # first host is always kept so min_np=1 worlds can form.
                if kept and total + hosts_map[h] > self.max_np:
                    break
                kept.append(h)
                total += hosts_map[h]
            ordered = kept
        return ordered

    def _publish_round(self, hosts_map: Dict[str, int]) -> None:
        self._ordered = self._select_hosts(hosts_map)
        self._assignment = {h: r for r, h in enumerate(self._ordered)}
        self._round += 1
        n, ts = self._round, time.time()
        scope = f"round_{n}"
        # Assignments and metadata land before the round pointer, and the
        # pointer before the notification timestamp, so a worker that sees
        # either key always finds a complete round behind it.
        for host, rank_ in self._assignment.items():
            self.server.put(scope, f"assign/{host}", str(rank_).encode())
        self.server.put(scope, "size", str(len(self._ordered)).encode())
        self.server.put(scope, "ts", repr(ts).encode())
        self.server.put("elastic", "round", str(n).encode())
        self.server.put("elastic", "ts", repr(ts).encode())
        self.rescale_events += 1
        self.events.append(("round", n, ts))
        # Store GC on round advance: stale round scopes and per-host
        # keys (heartbeats, guard reports, preempt flags) of departed
        # hosts would otherwise accumulate for the life of a week-long
        # elastic run. The journal compaction right after doubles as
        # the GC's persistence pass -- only the lean store survives.
        removed = self.server.gc(n, self._ordered)
        if removed and self.verbose:
            log.info("KV GC dropped %d stale entries at round %d", removed, n)
        if self.journal is not None:
            self._journal_state()
            self.server.compact_journal(self._driver_state())
        if self.verbose:
            log.info("published round %d: %s", n, self._assignment)

    # ---- process management -----------------------------------------------

    def _maybe_start_nic_probe(self) -> bool:
        """NIC auto-discovery for elastic worlds (runner/nics.py): the
        decision is made ONCE, at the first round. Probing a later round
        would count incumbent workers that were spawned without the
        probe env and can never report, stalling the collection -- so a
        world that starts local-only and later grows remote keeps the
        default address derivation (pin HVDTPU_IFACE manually for that
        shape). Hosts joining after round 0 adopt the published choice
        only if they have the interface (worker_report_and_adopt
        checks), degrading to default derivation otherwise."""
        from . import api, nics

        if self._nic_probe_decided:
            return self._nic_probe_on
        self._nic_probe_decided = True
        if os.environ.get(nics.ENV_IFACE) or self.extra_env.get(
            nics.ENV_IFACE
        ):
            return False  # manual pin wins; forwarded via env below
        if not any(not api._is_local(h) for h in self._ordered):
            return False
        self._nic_probe_on = True
        threading.Thread(
            target=nics.driver_autoprobe,
            args=(self.server, len(self._ordered)),
            daemon=True,
        ).start()
        return True

    def _spawn_missing(self) -> None:
        from . import api, nics

        probing = self._maybe_start_nic_probe()
        all_local = all(api._is_local(h) for h in self._ordered)
        for host in self._ordered:
            if host in self._procs or host in self._completed:
                continue
            env = dict(self.extra_env)
            env.update(
                {
                    api.ENV_RENDEZVOUS_ADDR: api._advertised_addr(all_local),
                    api.ENV_RENDEZVOUS_PORT: str(self.server.port),
                    "HVDTPU_ELASTIC": "1",
                    "HVDTPU_HOST_ID": host,
                    # The elastic round this process is born into -- lets
                    # chaos schedules target one incarnation of a worker
                    # (spawn=0 crashes the original, spares the respawn).
                    "HVDTPU_SPAWN_ROUND": str(self._round),
                    api.ENV_SECRET: self.server.secret,
                }
            )
            if all_local and not os.environ.get(api.ENV_LOCAL_ADDR):
                # One machine: the world's store is reached over the
                # loopback.
                env.setdefault(api.ENV_LOCAL_ADDR, "127.0.0.1")
            if probing:
                env[nics.ENV_AUTOPROBE] = "1"
            elif os.environ.get(nics.ENV_IFACE) and nics.ENV_IFACE not in env:
                # Manual pin must reach remote workers (ssh env block).
                env[nics.ENV_IFACE] = os.environ[nics.ENV_IFACE]
            if self.verbose:
                log.info("spawning worker on %s (round %d)", host, self._round)
            self._hb_baseline[host] = self.server.scope_items(
                "heartbeat"
            ).get(host)
            self._hb_seen.pop(host, None)
            # A previous incarnation's drain flags must not outlive it:
            # a stale ``preempt``/``exit`` key would make the fresh
            # worker look mid-eviction (or already-exited) to the
            # driver's preemption scan and the adoption exit-reader.
            self.server.delete("preempt", host)
            self.server.delete("exit", host)
            self._preempted.pop(host, None)
            self._procs[host] = api._Job(
                host, self.command, env, output_dir=self.output_dir,
                rank=self._assignment.get(host, 0),
            )
            self.events.append(("spawn", host, time.time()))
        self._journal_state()  # pids changed; an adopter needs them

    def _check_leases(self) -> bool:
        """Detect *hung* (not crashed) workers mid-round: a worker whose
        heartbeat lease (published by ``elastic.worker``'s beat thread)
        has gone stale is killed, blacklisted and dropped from the next
        round -- before this, a wedged process was only caught by the
        end-of-job drain deadline. Returns True when a republish is
        needed.

        Lease age is measured entirely on the driver's clock: a beat
        value is an opaque token, and the lease clock (re)starts when
        the driver *observes it change*. A worker that has not produced
        a post-spawn beat yet is left alone (it may still be importing
        torch); pre-join hangs are the join timeout's problem."""
        if self._hb_timeout <= 0:
            return False
        beats = self.server.scope_items("heartbeat")
        now = time.time()
        expired: List[str] = []
        for host in list(self._procs):
            if host not in self._assignment:
                continue  # scaled-away worker on its way out
            raw = beats.get(host)
            if raw is None or raw == self._hb_baseline.get(host):
                continue  # no beat from THIS incarnation yet
            prev = self._hb_seen.get(host)
            if prev is None or prev[0] != raw:
                self._hb_seen[host] = (raw, now)
                continue
            if now - prev[1] > self._hb_timeout:
                expired.append(host)
        for host in expired:
            age = now - self._hb_seen[host][1]
            log.warning(
                "worker on %s stopped heartbeating %.1fs ago "
                "(timeout %.1fs); treating as hung -- terminating and "
                "blacklisting", host, age, self._hb_timeout,
            )
            job = self._procs.pop(host)
            # SIGTERM->SIGKILL escalation + reap: a wedged process may
            # ignore SIGTERM (that presumption is why it's being
            # killed), and an unreaped child would linger as a zombie.
            job.kill(grace=2.0)
            self.lease_expiries += 1
            self.events.append(("lease_expired", host, time.time()))
            self._blacklist(host)
        if expired:
            self.driver.host_manager.update_available_hosts()
            return True
        return False

    def _check_guard_reports(self) -> bool:
        """Consume silent-divergence reports the workers' consistency
        audits publish (``guard`` scope, ``divergent/<host>`` = the
        reporter's tally; written by the audit's lowest majority rank,
        which changes across respawns/elections -- so any *changed*
        value counts as news, and the authoritative strike tally lives
        here, driver-side). Each new report adds a health strike
        (:meth:`HostManager.penalize`): the host was already healed by
        resync, so it keeps running, but its next blacklist probation
        doubles. A repeat offender (``HVDTPU_GUARD_BLACKLIST_AFTER``
        strikes) is corrupting state faster than resync is worth --
        kill, blacklist, republish. Returns True when a republish is
        needed."""
        try:
            items = self.server.scope_items("guard")
        except Exception:
            return False
        republish = False
        consumed = False
        for key, raw in items.items():
            if not key.startswith("divergent/"):
                continue
            host = key[len("divergent/"):]
            prev = self._guard_reports.get(host)
            if prev is not None and raw == prev[0]:
                continue  # value unchanged since last consumed
            # Any CHANGED value is one new report: the published value
            # is the reporter's tally plus a job-monotonic audit-step
            # nonce (see guard/audit._kv_report), and the reporter
            # itself changes across respawns and majority-root
            # elections -- so the authoritative strike tally lives HERE,
            # driver-side, counting value transitions.
            strikes = (0 if prev is None else prev[1]) + 1
            self._guard_reports[host] = (raw, strikes)
            consumed = True
            self.guard_report_events += 1
            log.warning(
                "host %s reported silently diverged (%d report(s)); "
                "adding a health strike", host, strikes,
            )
            self.driver.host_manager.penalize(host)
            if strikes >= self._guard_blacklist_after:
                log.warning(
                    "host %s diverged %d times (threshold %d); killing "
                    "and blacklisting", host, strikes,
                    self._guard_blacklist_after,
                )
                job = self._procs.pop(host, None)
                if job is not None:
                    job.kill(grace=2.0)
                # Same books the lease-expiry kill path closes out.
                self._hb_seen.pop(host, None)
                self._hb_baseline.pop(host, None)
                self._blacklist(host)
                self.driver.host_manager.update_available_hosts()
                republish = True
        if consumed:
            self._journal_state()  # strike tallies must survive a crash
        return republish

    def _check_preemptions(self) -> bool:
        """Consume ``preempt/<host>`` flags the workers' SIGTERM
        handlers publish: republish a round WITHOUT the evicted host so
        it can drain through the ordinary scale-down path (sees the new
        round at its next commit, takes its priority checkpoint, exits
        0) -- the world shrinks gracefully instead of the host being
        blacklisted as a failure. Returns True when a republish is
        needed.

        Also expires stale drain marks (this runs EVERY poll -- expiry
        must not wait for an unrelated republish to run the selection
        filter): an expired host still present in discovery gets a
        republish so it actually rejoins, instead of staying excluded
        for the rest of the job."""
        now = time.time()
        republish = False
        changed = False
        for host, since in list(self._preempted.items()):
            if now - since > self._preempt_cooldown:
                changed = True
                # Mark expired: the host either left discovery (really
                # evicted) or survived and may rejoin. Clear the stale
                # KV flags so a future incarnation isn't insta-drained.
                del self._preempted[host]
                self.server.delete("preempt", host)
                self.server.delete("exit", host)
                if host in self.driver.host_manager.current_hosts:
                    log.info(
                        "preemption mark for %s expired and the host is "
                        "back in discovery; re-admitting", host,
                    )
                    republish = True
        try:
            flags = self.server.scope_items("preempt")
        except Exception:
            return republish
        for host in flags:
            if host in self._preempted or host not in self._assignment:
                continue
            self._preempted[host] = time.time()
            log.info(
                "host %s received a preemption notice; draining it out "
                "of the next round", host,
            )
            republish = True
            changed = True
        if changed:
            self._journal_state()
        return republish

    def _check_autotune(self) -> bool:
        """One autotune coordinator turn; the rollout coordinator comes
        with A14 (``__init__`` refuses an armed tuner), so this is inert."""
        return False

    def _terminate_all(self) -> None:
        # Two rounds of SIGTERM, then SIGKILL: workers install a
        # preemption-grace handler that absorbs the FIRST notice to
        # drain -- a teardown must escalate past it (the handler treats
        # a second notice as "the platform means it" and dies).
        for job in self._procs.values():
            job.terminate()
        for job in self._procs.values():
            job.kill(grace=2.0)
        self._procs.clear()

    def _drain(self) -> int:
        """Completion phase: some worker finished the training function
        cleanly; wait (up to ``drain_timeout``, HVDTPU_ELASTIC_DRAIN_TIMEOUT)
        for the rest, so workers legitimately finishing their last epoch
        are not killed mid-commit (ADVICE r2). A straggler that *fails*
        during the window surfaces as the job's return code instead of
        being silently absorbed into a success."""
        t0 = time.time()
        while self._procs and time.time() - t0 < self.drain_timeout:
            for host, job in list(self._procs.items()):
                rc = job.poll()
                if rc is None:
                    continue
                job.terminate()  # reaped; closes redirected log files
                del self._procs[host]
                if rc == 0:
                    self._completed.add(host)
                elif host in self._assignment:
                    log.error(
                        "worker on %s failed rc=%d after %d peer(s) "
                        "completed; job result is incomplete",
                        host, rc, len(self._completed),
                    )
                    self._terminate_all()
                    return rc
            time.sleep(self.poll_interval)
        if self._procs:
            # Scaled-away workers (not in the current assignment) were told
            # to exit and hold no shard of the final result; only in-round
            # stragglers make the job incomplete.
            stragglers = sorted(h for h in self._procs if h in self._assignment)
            self._terminate_all()
            if stragglers and (
                os.environ.get("HVDTPU_ELASTIC_DRAIN_STRICT", "1") != "0"
            ):
                # A worker that never finished (e.g. hung mid-commit) was
                # killed at the deadline; its shard of the final epoch is
                # not committed, so the job result is incomplete and must
                # not report success (ADVICE r3). Set
                # HVDTPU_ELASTIC_DRAIN_STRICT=0 for the lenient legacy
                # behavior.
                log.error(
                    "%d worker(s) (%s) force-terminated %.0fs after job "
                    "completion; reporting failure (set "
                    "HVDTPU_ELASTIC_DRAIN_STRICT=0 to report success anyway)",
                    len(stragglers), ",".join(stragglers), self.drain_timeout,
                )
                return 1
            log.warning(
                "worker(s) still running %.0fs after job completion; "
                "force-terminated", self.drain_timeout,
            )
        return 0

    # ---- main loop --------------------------------------------------------

    def _install_sigterm_handler(self) -> bool:
        """Driver-side preemption grace: SIGTERM (the cloud's eviction
        notice) makes the run loop journal a final compacted snapshot
        and leave -- workers stay alive, blocked only on KV
        availability, for the respawned ``--adopt`` driver to pick up.

        Only installed when a journal exists: without one, adoption is
        impossible, so leaving workers orphaned would strand them (and
        their accelerators) until the join timeout -- journal-less runs
        keep the default SIGTERM disposition. Only installable from the
        main thread (in-process harnesses run the driver on a worker
        thread and drive the seam directly)."""
        import signal as _signal

        if self.journal is None:
            return False

        def _handler(signum, frame):
            log.warning(
                "driver received SIGTERM; journaling final state and "
                "leaving workers for adoption"
            )
            self._preempt_exit.set()

        try:
            _signal.signal(_signal.SIGTERM, _handler)
            return True
        except ValueError:  # not the main thread
            return False

    def _chaos_control_plane_sites(self) -> None:
        """The control plane's own fault sites, checked once per poll:

        * ``kv.server`` -- ``restart`` tears the KV listener down hard
          and brings a fresh-epoch incarnation up on the same port from
          the journal replay (clients ride it out via their reconnect
          epochs);
        * ``driver.crash`` -- raises :class:`DriverCrashed` with cleanup
          suppressed (context ``step`` is the current round, so
          ``@step=R`` crashes the driver deterministically in round R).
        """
        from .. import chaos as _chaos

        if not _chaos.enabled():
            return
        act = _chaos.action("kv.server")
        if act is not None and act.kind == "restart":
            epoch = self.server.restart(replay=self.journal is not None)
            log.warning(
                "chaos: KV server restarted (journal=%s, new epoch %s)",
                self.journal is not None, epoch,
            )
        act = _chaos.action("driver.crash", step=self._round)
        if act is not None:
            self._leave_workers_running = True
            raise DriverCrashed(
                f"chaos: injected driver crash at round {self._round}"
            )

    def run(self) -> int:
        adopting = self._adopted_state is not None
        if adopting:
            # Come back AS the server the in-flight workers know: same
            # secret (constructor), same port, journal-replayed store.
            port = int(self._adopted_state.get("port") or 0)
            self.server.start(port=port, store=self._recovered_store)
            self._restore_adopted_state()
        else:
            # A FRESH job must not resurrect a previous run's journal:
            # start empty and truncate (compact the empty state) so a
            # later crash+adopt replays only THIS job's history.
            self.server.start(store={})
            if self.journal is not None:
                self.server.compact_journal(None)
        self._install_sigterm_handler()
        self.driver.start()
        try:
            if adopting and self._round >= 0:
                # Resume the CURRENT round: re-attach live workers,
                # respawn only the ones that died during the outage --
                # never republish just because the driver changed
                # (healthy workers must not even notice).
                self._adopt_workers()
                self._journal_state()
                self._spawn_missing()
            else:
                hosts_map = self.driver.wait_for_available_slots(
                    self.driver.min_np
                )
                self._publish_round(hosts_map)
                self._spawn_missing()
            while True:
                time.sleep(self.poll_interval)
                # Driver-clock beacon: a driver timestamp refreshed
                # every poll tick gives late joiners (respawns after a
                # blacklist) a clock_sync observation whose staleness
                # is bounded by the poll interval -- the round ts they
                # join on may have been published arbitrarily long ago.
                self.server.put("clock", "now", repr(time.time()).encode())
                self._chaos_control_plane_sites()
                if self._preempt_exit.is_set() and self.journal is not None:
                    # Graceful handoff: final compacted snapshot, then
                    # leave everything running for the adopter. (The
                    # handler is only installed with a journal; without
                    # one there is nothing to adopt FROM, so the event
                    # is ignored and ordinary teardown applies.)
                    self._leave_workers_running = True
                    self.server.compact_journal(self._driver_state())
                    return ADOPTABLE_EXIT_CODE
                republish = False
                # Membership changes from discovery.
                if self.driver.consume_membership_change():
                    republish = True
                # Hung-worker detection via heartbeat-lease expiry.
                if self._check_leases():
                    republish = True
                # Silent-divergence reports from the consistency audits.
                if self._check_guard_reports():
                    republish = True
                # Preemption notices: drain evicted hosts gracefully.
                if self._check_preemptions():
                    republish = True
                # Autotune: collect trial scores, publish the next
                # candidate; a retrace-knob switch rides a republish.
                if self._check_autotune():
                    republish = True
                # Size-triggered compaction between rounds (a stable
                # world still journals every heartbeat-ish mutation).
                if (
                    self.journal is not None
                    and self.journal.journal_bytes
                    > _env.journal_compact_bytes()
                ):
                    self.server.compact_journal(self._driver_state())
                # Reap exits.
                failed_rc = 0
                for host, job in list(self._procs.items()):
                    rc = job.poll()
                    if rc is None:
                        continue
                    job.terminate()  # reaped; closes redirected log files
                    del self._procs[host]
                    self.events.append(("exit", host, time.time(), rc))
                    if host not in self._assignment:
                        if host in self._preempted:
                            if rc == 0:
                                # Preemption drain completed: the
                                # evicted host took its priority
                                # checkpoint and left cleanly --
                                # departed, NOT blacklisted.
                                log.info(
                                    "preempted host %s drained cleanly",
                                    host,
                                )
                            else:
                                # The platform's kill beat the grace
                                # window: still departed (no strike for
                                # an eviction), but not a drain -- and
                                # the draining gauge must not outlive
                                # the host in hvdtpu_top.
                                log.warning(
                                    "preempted host %s died rc=%d before "
                                    "finishing its drain", host, rc,
                                )
                            self._journal_state()
                        # Scaled-away worker exiting as told; not news.
                        continue
                    if host in self._preempted:
                        # The evicted worker left (or was SIGKILLed)
                        # BEFORE the shrink round dropped it from the
                        # assignment: still a departure, never a
                        # failure -- no strike, and its rc=0 must not
                        # read as "the job finished". Shrink now.
                        if rc == 0:
                            log.info(
                                "preempted host %s drained before the "
                                "shrink round landed", host,
                            )
                        else:
                            log.warning(
                                "preempted host %s died rc=%d before "
                                "draining", host, rc,
                            )
                        self._journal_state()
                        republish = True
                        continue
                    if rc == 0:
                        # An in-round worker finished the training
                        # function. Success is declared only when every
                        # in-round worker has exited (ADVICE r2: peers
                        # may legitimately still be committing their
                        # last epoch -- don't kill them after 30 s and
                        # report rc=0).
                        self._completed.add(host)
                        self._journal_state()
                        continue
                    log.warning("worker on %s failed rc=%d; blacklisting", host, rc)
                    self._blacklist(host)
                    self.driver.host_manager.update_available_hosts()
                    failed_rc = rc
                    republish = True
                if self._completed:
                    if failed_rc:
                        # A peer crashed while others already finished:
                        # the job's result is incomplete -- surface the
                        # failure instead of silently reporting success.
                        log.error(
                            "worker failure (rc=%d) after %d worker(s) "
                            "completed; terminating job",
                            failed_rc, len(self._completed),
                        )
                        self._terminate_all()
                        return failed_rc
                    # Completion phase: wait (bounded by drain_timeout)
                    # for the remaining in-round workers to finish.
                    return self._drain()
                if failed_rc:
                    self._resets += 1
                    if (
                        self.reset_limit is not None
                        and self._resets >= self.reset_limit
                    ):
                        log.error(
                            "reset limit %d reached; giving up", self.reset_limit
                        )
                        self._terminate_all()
                        return failed_rc
                if republish:
                    hosts_map = self.driver.host_manager.current_hosts
                    if sum(hosts_map.values()) < self.driver.min_np:
                        # Below min_np: hold the current round; workers block
                        # in join_world until new hosts appear.
                        try:
                            hosts_map = self.driver.wait_for_available_slots(
                                self.driver.min_np
                            )
                        except TimeoutError:
                            log.error("world fell below min_np and never recovered")
                            self._terminate_all()
                            return failed_rc or 1
                    self._publish_round(hosts_map)
                    self._spawn_missing()
                elif not self._procs:
                    # Everyone died without a clean exit and nothing was
                    # reaped as a failure (e.g. killed externally).
                    return 1
        finally:
            if not self._leave_workers_running:
                self._terminate_all()
            # On a driver crash (chaos) or SIGTERM handoff the workers
            # must survive this incarnation -- they only block on KV
            # availability until the adopter's server returns; the
            # discovery thread and listener still die with us (a
            # crashed driver's would have).
            self.driver.stop()
            self.server.stop()


def run_elastic(
    command: List[str],
    *,
    discovery_script: Optional[str] = None,
    discovery: Optional[HostDiscovery] = None,
    min_np: int = 1,
    max_np: Optional[int] = None,
    reset_limit: Optional[int] = None,
    extra_env: Optional[Dict[str, str]] = None,
    verbose: bool = False,
    launcher: Callable = launch_job,
    output_dir: Optional[str] = None,
    drain_timeout: Optional[float] = None,
    job_ref: Optional[Dict] = None,
    journal_dir: Optional[str] = None,
    adopt: bool = False,
    autotune: Optional[bool] = None,
) -> int:
    """Elastic job entry point.

    With the default launcher this runs the round-based :class:`ElasticJob`
    (workers survive membership changes and re-rendezvous in place). A
    custom ``launcher`` callable falls back to the whole-job relaunch loop
    -- the coarse-grained mode, kept for schedulers that must own process
    placement (and as the unit-test seam).

    ``journal_dir`` makes the control plane durable: every KV mutation
    and driver-state change is journaled (CRC-framed WAL + compacted
    snapshots), and ``adopt=True`` makes a respawned driver reconstruct
    the dead incarnation's exact state -- same HMAC secret, same KV port,
    same round, same blacklist/strike ledger -- re-attach the still-live
    workers by journaled pid, and resume WITHOUT restarting anything
    healthy (``hvdtpu-run-torch --journal-dir D`` / ``--adopt``).

    ``job_ref`` (a dict) receives the live :class:`ElasticJob` under
    ``"job"`` before the run starts -- the diagnostics seam harnesses
    like ``horovod_tpu_torch.tools.chaos_soak`` use to dump KV round state and tear a
    wedged job down when a scenario blows its deadline.
    """
    if discovery is None:
        if discovery_script is None:
            raise ValueError("need discovery_script or discovery")
        discovery = HostDiscoveryScript(discovery_script)
    driver = ElasticDriver(discovery, min_np=min_np, max_np=max_np)
    if launcher is launch_job:
        job = ElasticJob(
            command,
            driver,
            max_np=max_np,
            reset_limit=reset_limit,
            extra_env=extra_env,
            verbose=verbose,
            output_dir=output_dir,
            drain_timeout=drain_timeout,
            journal_dir=journal_dir,
            adopt=adopt,
            autotune=autotune,
        )
        if job_ref is not None:
            job_ref["job"] = job
        return job.run()

    driver.start()
    resets = 0
    try:
        while True:
            hosts_map = driver.wait_for_available_slots(min_np)
            hosts = [HostInfo(h, s) for h, s in sorted(hosts_map.items())]
            if max_np:
                total, kept = 0, []
                for h in hosts:
                    if total >= max_np:
                        break
                    kept.append(h)
                    total += h.slots
                hosts = kept
            if verbose:
                log.info("launching on %s", [(h.hostname, h.slots) for h in hosts])
            failed_hosts: List[str] = []
            kwargs: Dict = {"extra_env": extra_env}
            try:
                import inspect

                sig = inspect.signature(launcher)
                accepts_failure_cb = "on_host_failure" in sig.parameters or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in sig.parameters.values()
                )
            except (TypeError, ValueError):
                accepts_failure_cb = False
            if accepts_failure_cb:
                kwargs["on_host_failure"] = failed_hosts.append
            rc = launcher(command, hosts, **kwargs)
            if rc == 0:
                return 0
            # Blacklist the hosts whose processes actually failed
            # (reference driver.py:292-308 -> registration blacklisting).
            for h in failed_hosts:
                driver.host_manager.blacklist(h)
            driver.host_manager.update_available_hosts()
            resets += 1
            if reset_limit is not None and resets >= reset_limit:
                log.error("reset limit %d reached; giving up", reset_limit)
                return rc
            driver.consume_membership_change()
    finally:
        driver.stop()
