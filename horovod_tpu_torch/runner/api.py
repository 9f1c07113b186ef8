"""Process launch core: one process per slot.

The port of the JAX package's ``runner/api.py``. The reference launcher
(``horovod/runner/gloo_run.py`` ``launch_gloo:226`` + ``safe_shell_exec``)
spawns one process per GPU slot; the JAX package spawns one controller
per host, each driving every local chip. A port process drives one card
(``context.init`` pins ``cuda:<LOCAL_RANK>``), so :func:`launch_job`
spawns one process per :class:`~.hosts.SlotInfo` of
:func:`~.hosts.get_host_assignments`, with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set from the slot besides the
JAX package's ``HVDTPU_*`` block (``HVDTPU_PROCESS_ID`` is the slot's
rank, ``HVDTPU_NUM_PROCESSES`` the slot count).

Kept from the reference:

* slot assignments published through the HTTP KV rendezvous, which also
  carries the world's bootstrap: rank 0 opens the ``torch.distributed``
  store and publishes its address there (:func:`kv_store`), in place of
  the JAX package's ``auto_init_distributed``;
* local and remote (ssh) process exec with failure propagation -- the
  first non-zero exit terminates the whole job (``safe_shell_exec``
  semantics) -- and ``--output-filename``'s ``rank.<N>`` directories;
* :class:`_AdoptedJob`, the elastic driver's re-attachment to workers a
  crashed driver spawned.

:func:`run` ships the function with the standard library's ``pickle``
(the card's machine has no ``cloudpickle``): the function must be
importable by name, and a closure or lambda raises ``HorovodTpuError``.
"""

from __future__ import annotations

import os
import pickle
import shlex
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from .hosts import HostInfo, SlotInfo, get_host_assignments, parse_hosts
from .http_server import RendezvousServer
from .secret import ENV_SECRET, make_secret_key

# Env vars injected into every launched process (the JAX package's
# HVDTPU_* block, the analog of the reference's HOROVOD_GLOO_* block,
# gloo_run.py:187-198), and the slot's torch-style rank variables.
ENV_RENDEZVOUS_ADDR = "HVDTPU_RENDEZVOUS_ADDR"
ENV_RENDEZVOUS_PORT = "HVDTPU_RENDEZVOUS_PORT"
ENV_COORDINATOR = "HVDTPU_COORDINATOR_ADDR"
ENV_PROCESS_ID = "HVDTPU_PROCESS_ID"
ENV_NUM_PROCESSES = "HVDTPU_NUM_PROCESSES"
ENV_HOSTNAMES = "HVDTPU_HOSTNAMES"
ENV_LOCAL_ADDR = "HVDTPU_LOCAL_ADDR"
# The KV scope of the torch.distributed store's address: "dist" in a
# static launch, "dist_<round>" in an elastic one (elastic.worker sets it
# at each round join, so a re-rendezvous never reads a stale address).
ENV_DIST_SCOPE = "HVDTPU_DIST_SCOPE"
DIST_KEY = "store"


def slot_env(slot: SlotInfo) -> Dict[str, str]:
    """The rank variables ``context.init`` reads, from one slot."""
    return {
        "RANK": str(slot.rank),
        "WORLD_SIZE": str(slot.size),
        "LOCAL_RANK": str(slot.local_rank),
        "LOCAL_WORLD_SIZE": str(slot.local_size),
    }


def _is_local(hostname: str) -> bool:
    # Any 127.0.0.0/8 loopback is this machine by definition — distinct
    # loopback IPs let a test harness run >2 "hosts" locally (e.g. the
    # 3-rank majority vote in chaos_soak's silent scenario).
    return hostname in (
        "localhost", os.uname().nodename
    ) or hostname.startswith("127.")


class _Job:
    """A launched process (one slot) with output forwarding.

    Worker stdin is /dev/null on every host: remote workers consume
    their env block from the ssh pipe (below), so inheriting the
    launcher's stdin only locally would make ranks diverge.

    ``output_dir`` redirects the worker's stdout/stderr into
    ``<output_dir>/rank.<N>/stdout|stderr`` (reference
    ``--output-filename`` layout, ``launch.py:282``).
    """

    def __init__(self, hostname: str, cmd: List[str], env: Dict[str, str],
                 output_dir: Optional[str] = None, rank: int = 0):
        self.hostname = hostname
        self._out = self._err = None
        self.start_time = None  # set for local workers below
        stdout = stderr = None
        if output_dir:
            d = os.path.join(output_dir, f"rank.{rank}")
            os.makedirs(d, exist_ok=True)
            # Append: an elastic respawn reusing a rank number must not
            # truncate the previous round's (crash) output.
            self._out = open(os.path.join(d, "stdout"), "ab")
            self._err = open(os.path.join(d, "stderr"), "ab")
            stdout, stderr = self._out, self._err
        if _is_local(hostname):
            self.proc = subprocess.Popen(
                cmd, env={**os.environ, **env}, stdin=subprocess.DEVNULL,
                stdout=stdout, stderr=stderr,
            )
            # Journaled alongside the pid so an adopting driver can
            # verify identity before re-attaching (pid reuse defense).
            self.start_time = _pid_start_time(self.proc.pid)
        else:
            # ssh fan-out (reference launch.py:58-107 checks + exec). Env
            # rides stdin, NOT the remote argv: command lines are visible
            # to every user via ps on the worker host, and the block
            # includes the job's HMAC secret. Values are base64-encoded so
            # arbitrary content (newlines, the sentinel text) cannot
            # corrupt the stream.
            import base64

            bootstrap = (
                f"cd {shlex.quote(os.getcwd())} && "
                'while IFS== read -r k v; do '
                'case "$k" in __HVDTPU_ENV_END__) break;; esac; '
                # command substitution strips trailing newlines; the x
                # suffix protects them so decoded values round-trip.
                'd=$(printf %s "$v" | base64 -d && printf x); '
                'export "$k=${d%x}"; done && '
                "exec " + " ".join(shlex.quote(c) for c in cmd)
                + " < /dev/null"
            )
            self.proc = subprocess.Popen(
                ["ssh", "-o", "BatchMode=yes", hostname, bootstrap],
                stdin=subprocess.PIPE, stdout=stdout, stderr=stderr,
            )
            payload = (
                "\n".join(
                    f"{k}={base64.b64encode(v.encode()).decode()}"
                    for k, v in env.items()
                )
                + "\n__HVDTPU_ENV_END__\n"
            ).encode()
            try:
                self.proc.stdin.write(payload)
                self.proc.stdin.flush()
                self.proc.stdin.close()
            except (BrokenPipeError, OSError):
                pass  # ssh died; poll() surfaces the failure

    @property
    def pid(self) -> int:
        """The worker's (or its ssh supervisor's) process id — journaled
        by the elastic driver so a respawned ``--adopt`` driver can
        re-attach to still-running workers it did not spawn."""
        return self.proc.pid

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self):
        try:
            self.proc.terminate()
        except ProcessLookupError:
            pass
        for f in (self._out, self._err):
            if f is not None and not f.closed:
                f.close()

    def kill(self, grace: float = 5.0):
        """SIGTERM → bounded wait → SIGKILL escalation, then reap.

        For workers presumed *hung* (the lease-expiry path): a wedged
        process may ignore SIGTERM — that presumption is exactly why it
        is being killed — and a terminated-but-unreaped child stays a
        zombie for the driver's lifetime."""
        try:
            self.proc.terminate()
        except ProcessLookupError:
            pass
        try:
            self.proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            try:
                self.proc.kill()
            except ProcessLookupError:
                pass
            try:
                self.proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                pass
        for f in (self._out, self._err):
            if f is not None and not f.closed:
                f.close()


def _pid_start_time(pid: int) -> Optional[int]:
    """Kernel start time (clock ticks since boot, ``/proc/<pid>/stat``
    field 22) — the identity check that makes pid re-attachment safe:
    a recycled pid never has the original's start time, so an adopter
    can tell "the worker I journaled" from "an unrelated process that
    inherited its number" before it ever signals anything."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("ascii", "replace")
        # Fields after the parenthesized comm (which may contain
        # spaces): state is field 3, starttime is field 22.
        return int(stat.rsplit(") ", 1)[1].split()[19])
    except (OSError, ValueError, IndexError):
        return None


class _AdoptedJob:
    """A worker process re-attached by a respawned (``--adopt``) driver.

    The adopter never spawned this process, so it holds no ``Popen``
    handle: liveness is probed by pid (``os.kill(pid, 0)``), and the
    exit *status* — unknowable for a non-child — comes from the KV
    instead: a worker that finishes (or preemption-drains) cleanly
    publishes ``exit/<host> = 0`` just before leaving
    (``elastic.run`` / ``elastic.worker``), so a vanished pid without
    that flag is a crash. Signals work by pid exactly as for owned
    children; only the ``wait()`` reap is skipped (init reaps orphans).

    ``pid=None`` is **blind adoption** (remote workers, whose ssh
    supervisor died with the old driver while the far end may live
    on): no signals, no pid probe — the exit flag decides a clean
    finish and the heartbeat lease decides death (a silent far end
    stops beating, the lease expires, the ordinary blacklist/probation
    path respawns it; two incarnations never coexist).
    """

    def __init__(self, hostname: str, pid: Optional[int],
                 exit_reader: Callable):
        self.hostname = hostname
        self._pid = pid
        self._exit_reader = exit_reader  # host -> Optional[bytes]
        self._rc: Optional[int] = None
        self.start_time = (
            _pid_start_time(pid) if pid is not None else None
        )

    @property
    def pid(self) -> Optional[int]:
        return self._pid

    def _alive(self) -> bool:
        try:
            os.kill(self._pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True  # exists, not ours to signal

    def _exit_flag_rc(self) -> Optional[int]:
        try:
            flag = self._exit_reader(self.hostname)
        except Exception:
            flag = None
        return 0 if flag == b"0" else None

    def poll(self) -> Optional[int]:
        if self._rc is not None:
            return self._rc
        if self._pid is None:
            # Blind (remote) adoption: a clean finish shows up as the
            # exit flag; anything else is the heartbeat lease's call.
            self._rc = self._exit_flag_rc()
            return self._rc
        # If the pid happens to be OUR child (the in-process test
        # harness adopts workers the same process spawned), reap it:
        # a zombie still answers kill(pid, 0), so the probe below would
        # report it alive until something else ran wait() on it.
        try:
            pid, status = os.waitpid(self._pid, os.WNOHANG)
            if pid == 0:
                return None  # our child, still running
            code = os.waitstatus_to_exitcode(status)
            self._rc = code if code >= 0 else 1  # signal death = failure
            return self._rc
        except ChildProcessError:
            pass  # the production case: not our child — probe by pid
        except OSError:
            pass
        if self._alive():
            return None
        self._rc = self._exit_flag_rc()
        if self._rc is None:
            self._rc = 1  # vanished without the clean-exit flag
        return self._rc

    def terminate(self):
        if self._pid is None:
            return
        try:
            os.kill(self._pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass

    def kill(self, grace: float = 5.0):
        if self._pid is None:
            return
        self.terminate()
        deadline = time.time() + grace
        while self._alive() and time.time() < deadline:
            time.sleep(0.05)
        if self._alive():
            try:
                os.kill(self._pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass


def launch_job(
    command: List[str],
    hosts: List[HostInfo],
    *,
    extra_env: Optional[Dict[str, str]] = None,
    poll_interval: float = 0.2,
    on_host_failure: Optional[Callable[[str], None]] = None,
    server: Optional[RendezvousServer] = None,
    output_dir: Optional[str] = None,
) -> int:
    """Launch ``command`` once per slot of ``hosts`` with the full env
    block; block until completion. Returns the job exit code (the first
    failure wins and terminates the rest). ``on_host_failure`` receives
    the hostname of every process that exits non-zero *before* the
    cascade kill -- the per-host attribution the elastic driver's
    blacklist feeds on (reference ``runner/elastic/driver.py:292-308``).
    A caller-owned ``server`` (the programmatic :func:`run` ships its
    pickled function and collects results through it) is left running on
    return."""
    owns_server = server is None
    if owns_server:
        # Per-job HMAC key: only this job's workers can read or write the
        # rendezvous KV (reference secret.py signing for its services).
        server = RendezvousServer(secret=make_secret_key())
        server.start()
    secret = server.secret
    port = server.port
    slots = get_host_assignments(hosts, min_np=len(hosts))
    server.init(slots, clear=owns_server)

    coordinator_host = hosts[0].hostname
    hostnames = ",".join(h.hostname for h in hosts)

    # NIC auto-discovery (reference driver_service.py:122-257): engage
    # for genuinely multi-host worlds unless the user pinned an
    # interface; workers report their tables over the KV and a driver
    # thread publishes the common choice (runner/nics.py).
    from . import nics as _nics

    all_local = all(_is_local(h.hostname) for h in hosts)
    autoprobe = (
        not all_local
        and not (extra_env or {}).get(_nics.ENV_IFACE)
        and not os.environ.get(_nics.ENV_IFACE)
    )
    if autoprobe:
        probe_thread = threading.Thread(
            target=_nics.driver_autoprobe,
            args=(server, len(slots)),
            daemon=True,
        )
        probe_thread.start()
    jobs: List[_Job] = []
    try:
        for slot in slots:
            env = dict(extra_env or {})
            env.update(
                {
                    ENV_RENDEZVOUS_ADDR: _advertised_addr(all_local),
                    ENV_RENDEZVOUS_PORT: str(port),
                    ENV_COORDINATOR: coordinator_host,
                    ENV_PROCESS_ID: str(slot.rank),
                    ENV_NUM_PROCESSES: str(len(slots)),
                    ENV_HOSTNAMES: hostnames,
                    **slot_env(slot),
                }
            )
            if all_local and not os.environ.get(ENV_LOCAL_ADDR):
                # One machine: the store rank 0 opens is reached over the
                # loopback, whatever the interfaces say.
                env.setdefault(ENV_LOCAL_ADDR, "127.0.0.1")
            if secret is not None:
                env[ENV_SECRET] = secret
            if autoprobe:
                env[_nics.ENV_AUTOPROBE] = "1"
            elif os.environ.get(_nics.ENV_IFACE) and _nics.ENV_IFACE not in env:
                # A launcher-shell manual pin must reach REMOTE workers
                # too (ssh delivers only this env block; os.environ is
                # inherited by local processes alone).
                env[_nics.ENV_IFACE] = os.environ[_nics.ENV_IFACE]
            jobs.append(
                _Job(slot.hostname, command, env, output_dir=output_dir,
                     rank=slot.rank)
            )

        exit_code = 0
        alive = set(range(len(jobs)))
        cascade_killed: set = set()
        while alive:
            for i in list(alive):
                rc = jobs[i].poll()
                if rc is None:
                    continue
                alive.discard(i)
                if rc != 0:
                    # Don't attribute our own cascade kill as a failure.
                    if on_host_failure is not None and i not in cascade_killed:
                        on_host_failure(jobs[i].hostname)
                    if exit_code == 0:
                        exit_code = rc
                        # First failure terminates the job (safe_shell_exec
                        # semantics). A job that already exited on its own
                        # by now failed independently -- keep it eligible
                        # for failure attribution.
                        for j in alive:
                            if jobs[j].poll() is None:
                                cascade_killed.add(j)
                                jobs[j].terminate()
            time.sleep(poll_interval)
        return exit_code
    finally:
        for j in jobs:
            j.terminate()
        if owns_server:
            server.stop()


def _check_picklable(obj, what: str) -> bytes:
    from ..exceptions import HorovodTpuError

    try:
        return pickle.dumps(obj)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise HorovodTpuError(
            f"{what} cannot be shipped to the workers with the standard "
            f"library's pickle ({e}); define the function at module level "
            "so the workers can import it by name (a closure or lambda "
            "cannot be pickled)"
        ) from e


def run(
    func: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    *,
    hosts: Optional[str] = None,
    device: Optional[str] = None,
):
    """Programmatic run (parity: ``horovod.run``,
    ``horovod/runner/__init__.py``).

    Always returns a rank-ordered list of results (the reference's
    contract). With one slot in all the world is this process: it is
    initialized in-process if it is not yet, and ``func`` runs directly.

    Otherwise (``hosts="h1:2,h2:2"``) ``func``, ``args`` and ``kwargs``
    are pickled with the standard library and published through the
    rendezvous KV; one worker process per slot (``python -m
    horovod_tpu_torch.runner.task_fn``) fetches them, initializes the
    world (NCCL on its card; ``device="cpu"`` makes it a gloo world of
    CPU processes), runs ``func`` and publishes its result.
    """
    from ..context import init, is_initialized

    host_list = parse_hosts(hosts) if hosts is not None else []
    if sum(h.slots for h in host_list) <= 1:
        if not is_initialized():
            init(device)
        return [func(*args, **(kwargs or {}))]

    blob = _check_picklable((func, tuple(args), dict(kwargs or {})),
                            f"run({getattr(func, '__qualname__', func)!r})")
    server = RendezvousServer(secret=make_secret_key())
    server.start()
    try:
        server.put("program", "func", blob)
        server.put("program", "device", (device or "").encode())
        rc = launch_job(
            [sys.executable, "-m", "horovod_tpu_torch.runner.task_fn"],
            host_list,
            server=server,
        )
        if rc != 0:
            raise RuntimeError(f"programmatic run failed with exit code {rc}")
        results = []
        scope = server.scope_items("result")
        for r in range(sum(h.slots for h in host_list)):
            blob = scope.get(str(r))
            if blob is None:
                raise RuntimeError(f"rank {r} produced no result")
            results.append(pickle.loads(blob))
        return results
    finally:
        server.stop()


def kv_client():
    """The launcher's rendezvous client from this process's env, or None
    outside a launch."""
    from .http_server import RendezvousClient

    addr = os.environ.get(ENV_RENDEZVOUS_ADDR)
    port = os.environ.get(ENV_RENDEZVOUS_PORT)
    if not addr or not port:
        return None
    return RendezvousClient(addr, int(port))


def kv_store(rank: int, size: int, timeout: float,
             scope: Optional[str] = None):
    """The ``torch.distributed`` store of a launched world, bootstrapped
    over the launcher's KV (the Gloo-style bootstrap,
    ``horovod/common/gloo/gloo_context.cc:63-146``, in place of the JAX
    package's ``auto_init_distributed`` and native coordinator
    negotiation).

    Rank 0 opens a ``TCPStore`` on port 0 -- the kernel picks a free
    port at bind time, so no port is probed and then raced for -- and
    publishes ``host:port`` under ``<scope>/store``; every other rank
    waits for the key and connects. The scope is ``HVDTPU_DIST_SCOPE``
    (``dist``; ``dist_<round>`` in an elastic round). A rank that reaches
    a stale address (a torn-down world of the same round) re-reads the
    key until ``timeout``. Returns None outside a launch. ``scope``
    overrides the scope (the dynamic-enqueue runtime's store lives under
    ``native``)."""
    from datetime import timedelta

    import torch.distributed as dist

    client = kv_client()
    if client is None:
        return None
    from . import nics as _nics

    # Multi-host NIC auto-discovery: adopt the driver's common interface
    # as HVDTPU_IFACE before the address below is derived. No-op unless
    # the launcher enabled the probe; a manual HVDTPU_IFACE always wins.
    _nics.worker_report_and_adopt(client)
    scope = scope or os.environ.get(ENV_DIST_SCOPE, "dist")
    if rank == 0:
        # wait_for_workers=False: the address is published only after
        # the constructor returns, so it must not wait for the others.
        host = _local_addr()
        store = dist.TCPStore(host, 0, size, True,
                              timeout=timedelta(seconds=timeout),
                              wait_for_workers=False)
        client.put(scope, DIST_KEY, f"{host}:{store.port}".encode())
        return store
    deadline = time.time() + timeout
    while True:
        left = max(1.0, deadline - time.time())
        host, port = client.wait(scope, DIST_KEY, deadline=left).decode(
        ).rsplit(":", 1)
        try:
            return dist.TCPStore(
                host, int(port), size, False,
                timeout=timedelta(seconds=min(10.0, left)))
        except (RuntimeError, OSError):
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def _advertised_addr(all_local: bool) -> str:
    """The launcher's KV address as the workers should dial it: the
    loopback when every host is this machine, else :func:`_local_addr`."""
    return "127.0.0.1" if all_local else _local_addr()


def _iface_addr(iface: str) -> Optional[str]:
    """IPv4 address bound to a named interface (Linux ``SIOCGIFADDR``
    ioctl — stdlib-only equivalent of the reference's psutil NIC probe,
    ``runner/driver/driver_service.py:122-257``)."""
    import fcntl
    import socket
    import struct

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        try:
            packed = struct.pack("256s", iface.encode()[:15])
            return socket.inet_ntoa(
                fcntl.ioctl(s.fileno(), 0x8915, packed)[20:24]  # SIOCGIFADDR
            )
        except OSError:
            return None


def _local_addr() -> str:
    """Advertisable local IPv4 address. Order: ``HVDTPU_LOCAL_ADDR``
    override, then ``HVDTPU_IFACE`` (interface names, comma-separated;
    the first that resolves wins), then the first usable interface of
    :func:`.nics.list_interfaces` (the same preference order as the NIC
    probe), then ``127.0.0.1``. Only this machine's interface table is
    read: no name lookup, no probe of a route."""
    override = os.environ.get(ENV_LOCAL_ADDR)
    if override:
        return override
    iface = os.environ.get("HVDTPU_IFACE")
    if iface:
        names = [n.strip() for n in iface.split(",") if n.strip()]
        for name in names:
            addr = _iface_addr(name)
            if addr:
                return addr
        raise RuntimeError(
            f"HVDTPU_IFACE={iface!r}: none of {names} has an IPv4 "
            "address (or no such interface); fix the name(s) or unset it"
        )
    from . import nics as _nics

    table = _nics.list_interfaces()
    if table:
        return table[sorted(table, key=_nics._rank_name)[0]]
    return "127.0.0.1"
