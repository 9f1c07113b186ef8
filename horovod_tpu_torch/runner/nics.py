"""Automatic NIC discovery for multi-host launches.

The port of the JAX package's ``runner/nics.py``. Parity: the reference's
interface probe (``horovod/runner/driver/driver_service.py:122-257``)
starts task services on every host, has each report its interfaces, and
intersects the usable set so ``--network-interface`` is only needed as
an override. Here the probe rides the launcher's HMAC'd rendezvous KV:

1. **Worker bootstrap** (``context.init``'s KV bootstrap of the
   ``torch.distributed`` store): when the driver enabled the probe
   (``HVDTPU_NIC_AUTOPROBE=1``), each worker PUTs its host's
   ``{iface: ipv4}`` table to the ``nics`` scope, then waits for the
   driver's ``chosen`` key and adopts it as ``HVDTPU_IFACE`` -- which the
   store address a rank 0 advertises honours via
   :func:`.api._local_addr`.
2. **Driver** (``launch_job``, the elastic driver's first round):
   collects every process's report, intersects interface names across
   hosts, and publishes the choice (empty string when there is no common
   NIC -- workers then fall back to the default address derivation).

Manual ``HVDTPU_IFACE`` / ``--network-interface`` always wins: the driver
skips the probe and workers never wait. The probe only engages for
worlds with at least one non-local host.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Dict, Optional

SCOPE = "nics"
CHOSEN_KEY = "chosen"
REPORT_PREFIX = "report."
ENV_AUTOPROBE = "HVDTPU_NIC_AUTOPROBE"
ENV_IFACE = "HVDTPU_IFACE"

# Name-prefix preference when several NICs are common to all hosts:
# fabric/ethernet devices before bonds before anything exotic.
_PREFERENCE = ("eth", "ens", "enp", "eno", "ib", "bond")


def list_interfaces() -> Dict[str, str]:
    """``{iface_name: ipv4}`` for every up, non-loopback interface with
    an IPv4 address (stdlib-only; the reference uses psutil)."""
    from .api import _iface_addr

    out: Dict[str, str] = {}
    try:
        names = [name for _, name in socket.if_nameindex()]
    except OSError:
        return out
    for name in names:
        addr = _iface_addr(name)
        if addr and not addr.startswith("127."):
            out[name] = addr
    return out


def _rank_name(name: str) -> tuple:
    for i, prefix in enumerate(_PREFERENCE):
        if name.startswith(prefix):
            return (i, name)
    return (len(_PREFERENCE), name)


def choose_common(reports) -> str:
    """Intersect interface names across host reports; deterministic
    preference order. Empty string when nothing is common (callers fall
    back to default address derivation)."""
    reports = [r for r in reports if r]
    if not reports:
        return ""
    common = set(reports[0])
    for r in reports[1:]:
        common &= set(r)
    if not common:
        return ""
    return sorted(common, key=_rank_name)[0]


def driver_autoprobe(server, n_procs: int, deadline_secs: float = 60.0,
                     poll: float = 0.1,
                     cold_start_secs: float = 600.0) -> str:
    """Driver side: wait for every process's interface report, choose,
    publish. Returns the published choice.

    The ``deadline_secs`` window starts at the FIRST report, not at
    launch: before that the workers are still in ssh fan-out /
    interpreter cold start (importing torch and initializing CUDA can
    take a while on a cold host), which must not eat the collection budget — workers
    arrive within seconds of each other once interpreters are up.
    ``cold_start_secs`` bounds the wait for that first report so a world
    that never bootstraps cannot pin this thread forever. Partial
    reports at the deadline publish the EMPTY fallback: choosing from a
    partial intersection could pick an interface the silent hosts lack,
    splitting the world between fabric-IP and hostname derivation — the
    exact unroutable-address hang the probe exists to prevent. Everyone
    falling back together is always routable-or-not together. Workers
    must never wait forever, so something is always published."""
    import logging

    log = logging.getLogger("horovod_tpu_torch.runner")
    t0 = time.time()
    first_report: Optional[float] = None
    reports: Dict[str, Dict[str, str]] = {}
    while True:
        now = time.time()
        if first_report is None:
            if now - t0 > cold_start_secs:
                break
        elif now - first_report > deadline_secs:
            break
        try:
            items = server.scope_items(SCOPE)
        except Exception:
            return ""  # server stopped (job torn down) — nothing to publish
        reports = {
            k: json.loads(v.decode())
            for k, v in items.items()
            if k.startswith(REPORT_PREFIX)
        }
        if reports and first_report is None:
            first_report = now
        if len(reports) >= n_procs:
            break
        time.sleep(poll)
    if len(reports) < n_procs:
        log.warning(
            "NIC probe: %d/%d worker report(s) before the deadline; "
            "publishing the default-derivation fallback (a choice the "
            "silent hosts never confirmed could split address derivation "
            "across the world)",
            len(reports), n_procs,
        )
        chosen = ""
    else:
        chosen = choose_common(list(reports.values()))
        if not chosen:
            log.warning(
                "NIC probe: no interface common to all hosts; workers "
                "keep default address derivation (set HVDTPU_IFACE to "
                "pin one)"
            )
    try:
        server.put(SCOPE, CHOSEN_KEY, chosen.encode())
    except Exception:
        return ""
    return chosen


def worker_report_and_adopt(client, deadline_secs: float = 120.0,
                            env=None) -> Optional[str]:
    """Worker side: report this host's interfaces, adopt the driver's
    choice as ``HVDTPU_IFACE``. No-ops unless the driver enabled the
    probe; a manual ``HVDTPU_IFACE`` always wins. ``env`` is the process
    environment (injectable for tests that simulate several workers in
    one process)."""
    if env is None:
        env = os.environ
    if not env.get(ENV_AUTOPROBE):
        return None
    if env.get(ENV_IFACE):
        return env[ENV_IFACE]
    ifaces = list_interfaces()
    # Report key must be unique per worker: elastic workers carry
    # HVDTPU_HOST_ID (and no process id), static workers the reverse.
    pid = (
        env.get("HVDTPU_HOST_ID")
        or env.get("HVDTPU_PROCESS_ID")
        or socket.gethostname()
    )
    client.put(SCOPE, f"{REPORT_PREFIX}{pid}", json.dumps(ifaces).encode())
    try:
        chosen = client.wait(
            SCOPE, CHOSEN_KEY, deadline=deadline_secs
        ).decode()
    except Exception:
        return None  # driver gone or timed out: default derivation
    if chosen and chosen in ifaces:
        env[ENV_IFACE] = chosen
        return chosen
    if chosen:
        # Mixed-derivation hazard: peers adopted `chosen` and will
        # advertise its IP, but this host has no such interface and
        # falls back to hostname derivation — say so LOUDLY so a
        # cross-derivation hang is diagnosable from this line alone.
        import logging

        logging.getLogger("horovod_tpu_torch.runner").error(
            "NIC probe: driver chose interface %r but this host has "
            "only %s; falling back to default address derivation while "
            "peers use the chosen NIC — if the job hangs here, set "
            "HVDTPU_IFACE on all hosts to a mutually routable interface",
            chosen, sorted(ifaces) or "no usable interfaces",
        )
    return None
