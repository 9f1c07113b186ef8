"""Process-level serving transport over the elastic rendezvous KV plane.

The port of the JAX package's ``serve/kv.py``, with the same message
schema, so either package's coordinator drives either package's workers.
The in-process :class:`~horovod_tpu_torch.serve.pool.ServePool` models
one host; a serving deployment runs one serving worker *process* per host
under the elastic driver -- the same rendezvous, heartbeat leases,
blacklist probation and respawn machinery training uses. This module is
the request plane between them:

* the **coordinator** (:class:`KVServeCoordinator`) runs next to the
  driver (it holds the in-process :class:`~..runner.http_server.
  RendezvousServer`), leases batches from a :class:`~.dispatcher.
  Dispatcher` and publishes them under ``serve_in_<host>/<seq>``;
* each **worker process** (:func:`kv_worker_serve_loop`) polls its own
  scope, packs the lease into the fixed device batch
  (:func:`~..ops.batching.pack_requests`), moves it to its device (the
  card by default), runs the inference function there, and publishes one
  response per request under ``serve_out/<request_id>``;
* the coordinator resolves responses into the dispatcher
  (:meth:`Dispatcher.resolve`), so a worker killed mid-flight simply
  stops answering: its leases hit the dispatch timeout, the requests
  re-queue, and a surviving (or respawned) worker answers them -- zero
  dropped requests, one response per request (late duplicate answers
  lose the future race and are ignored).

Leases are addressed to one worker *incarnation* (the port's repair of
ROADMAP C12, which the JAX package keeps): a worker announces itself with a
fresh ``serve_ctl/ready/<host>`` stamp, every lease message carries the
stamp it was addressed to (``"ready"``), and a worker skips a lease whose
stamp is not its own -- so a respawn never replays the leases written to
its dead predecessor, which re-queue through the lease timeout instead.
The elastic driver deletes the announcement when it reaps or blacklists
the host, so no new lease goes to the dead incarnation. A message without
a stamp (from the JAX package's coordinator) is served as before.

Payloads are JSON lists of float32 values (token ids up to 2**24 travel
exactly), as in the JAX package: the recovery semantics, which is what
this layer exists to prove, are the same as over a data plane. Answered
request keys accumulate in ``serve_out`` and each pump tick rescans it --
O(total requests) per tick, fine at the scale this transport serves.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Set

import numpy as np
import torch

from .. import chaos as _chaos
from .dispatcher import Dispatcher

__all__ = ["KVServeCoordinator", "kv_worker_serve_loop", "scope_in"]

log = logging.getLogger("horovod_tpu_torch.serve.kv")

SCOPE_OUT = "serve_out"
SCOPE_CTL = "serve_ctl"


def scope_in(host: str) -> str:
    return f"serve_in_{host}"


class KVServeCoordinator:
    """Driver-side pump between a :class:`Dispatcher` and the KV plane.

    ``max_outstanding`` bounds leases per worker (continuous batching
    needs at most one in flight plus one queued to keep a worker busy).
    Worker death needs no special signal here: unanswered leases expire
    via the dispatcher's ``request_timeout_secs`` reaper and re-queue.
    """

    def __init__(self, server, dispatcher: Dispatcher,
                 poll_secs: float = 0.05, max_outstanding: int = 2):
        self.server = server
        self.dispatcher = dispatcher
        self.poll_secs = poll_secs
        self.max_outstanding = max_outstanding
        self._seq = 0
        self._resolved: Set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lease_by_id: Dict[int, Any] = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "KVServeCoordinator":
        self._thread = threading.Thread(
            target=self._pump, name="hvdtpu-serve-coord", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, shutdown_workers: bool = True) -> None:
        if shutdown_workers:
            self.server.put(SCOPE_CTL, "shutdown", b"1")
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- pump --------------------------------------------------------------

    def ready_stamps(self) -> Dict[str, str]:
        """Each announced host's ready stamp, as its worker wrote it: the
        incarnation a lease is addressed to."""
        return {
            key[len("ready/"):]: raw.decode()
            for key, raw in self.server.scope_items(SCOPE_CTL).items()
            if key.startswith("ready/")
        }

    def ready_workers(self) -> Dict[str, float]:
        """Hosts that announced themselves serving-ready, with the time
        of the announcement. The elastic driver retires a dead host's
        entry; without a driver a stale one costs only lease timeouts."""
        out: Dict[str, float] = {}
        for host, stamp in self.ready_stamps().items():
            try:
                out[host] = float(stamp)
            except ValueError:
                pass
        return out

    def live_workers(self) -> Dict[str, float]:
        """Ready workers still in the current elastic round. A host the
        driver blacklisted out of the round stops receiving leases the
        moment the round republishes; without an elastic driver every
        ready worker counts."""
        ready = self.ready_workers()
        try:
            raw = self.server.scope_items("elastic").get("round")
            if raw is None:
                return ready
            n = int(raw)
            assigned = {
                k[len("assign/"):]
                for k in self.server.scope_items(f"round_{n}")
                if k.startswith("assign/")
            }
            return {h: t for h, t in ready.items() if h in assigned}
        except Exception:  # torn round read: next pump tick re-reads
            return ready

    def _pump(self) -> None:
        while not self._stop.wait(self.poll_secs):
            try:
                self._collect_responses()
                self.dispatcher.reap_expired()
                self._dispatch_batches()
                # Retired leases (answered or reaped) leave the book.
                active = set(self.dispatcher.active_lease_ids())
                for lid in [l for l in self._lease_by_id if l not in active]:
                    del self._lease_by_id[lid]
            except Exception as e:  # noqa: BLE001 - pump must survive
                log.warning("serve coordinator pump error: %s", e)

    def _collect_responses(self) -> None:
        for key, raw in self.server.scope_items(SCOPE_OUT).items():
            if key in self._resolved:
                continue
            self._resolved.add(key)
            if key.startswith("err/"):
                # Worker-reported dispatch error: fail the lease now
                # instead of waiting out the timeout.
                lease = self._lease_by_id.pop(int(key[len("err/"):]), None)
                if lease is not None:
                    self.dispatcher.fail(lease)
                continue
            rec = json.loads(raw)
            self.dispatcher.resolve(int(key), rec["value"])

    def _dispatch_batches(self) -> None:
        if self.dispatcher.queue_depth == 0:
            return
        by_worker = self.dispatcher.in_flight_by_worker()
        batch = self.dispatcher.batch_size
        stamps = self.ready_stamps()
        for host in sorted(self.live_workers()):
            outstanding = -(-by_worker.get(host, 0) // batch)  # ceil
            while (
                outstanding < self.max_outstanding
                and self.dispatcher.queue_depth > 0
            ):
                lease = self.dispatcher.lease(host, timeout=0.01)
                if lease is None:
                    break
                self._lease_by_id[lease.lease_id] = lease
                msg = {
                    "lease": lease.lease_id,
                    "ready": stamps.get(host),
                    "batch_size": batch,
                    "reqs": [
                        {"id": r.id,
                         "x": np.asarray(torch.as_tensor(r.payload)
                                         .cpu()).tolist()}
                        for r in lease.requests
                    ],
                }
                self._seq += 1
                self.server.put(
                    scope_in(host), str(self._seq),
                    json.dumps(msg).encode(),
                )
                outstanding += 1


def kv_worker_serve_loop(
    infer: Callable[[Any], Any],
    *,
    client=None,
    host_id: Optional[str] = None,
    poll_secs: float = 0.05,
    on_batch: Optional[Callable[[dict], None]] = None,
    device=None,
) -> int:
    """Worker-process serve loop: announce ready, poll the host's lease
    scope, answer every request, return the batches served on the
    shutdown key.

    ``infer`` maps a ``[batch, ...]`` float32 tensor on ``device`` (default
    this process's card; ``"cpu"`` on the CPU) to a ``[batch, ...]``
    output, run under ``torch.inference_mode()``. The chaos
    ``serve.dispatch`` site fires per leased batch: ``crash`` hard-kills
    this worker mid-flight (the elastic driver blacklists and respawns the
    host; the coordinator's lease timeout re-queues the work), ``error``
    reports the lease failed, ``timeout`` swallows the batch silently.

    The worker serves only leases addressed to its own ready stamp (or to
    no stamp, from a coordinator that sends none); ``on_batch`` hears the
    lease id of each batch served.
    """
    from ..context import resolve_device
    from ..elastic import worker as _ew
    from ..ops.batching import pack_requests, unpack_responses

    dev = resolve_device(device)
    if client is None:
        client = _ew._kv_client()
    if host_id is None:
        host_id = os.environ.get(_ew.ENV_HOST_ID) or os.uname().nodename
    on_card = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
    stamp = repr(time.time())
    client.put(SCOPE_CTL, f"ready/{host_id}", stamp.encode())
    seen: Set[str] = set()
    served = 0
    while True:
        if client.get(SCOPE_CTL, "shutdown") is not None:
            return served
        try:
            keys = client.keys(scope_in(host_id))
        except OSError:
            time.sleep(poll_secs)
            continue
        fresh = [k for k in keys if k not in seen]
        if not fresh:
            time.sleep(poll_secs)
            continue
        for key in sorted(fresh, key=int):
            seen.add(key)
            raw = client.get(scope_in(host_id), key)
            if raw is None:
                continue
            msg = json.loads(raw)
            if msg.get("ready") not in (None, stamp):
                # Addressed to an earlier incarnation of this host: its
                # lease times out at the coordinator and re-queues.
                continue
            if _chaos.enabled():
                fault = _chaos.act("serve.dispatch", host=host_id)
                if fault is not None:
                    if fault.kind == "timeout":
                        continue  # swallow: coordinator reaper re-queues
                    if fault.kind == "error":
                        client.put(
                            SCOPE_OUT, f"err/{msg['lease']}", b"error"
                        )
                        continue
            reqs = msg["reqs"]
            payloads = [
                torch.from_numpy(np.asarray(r["x"], np.float32))
                for r in reqs
            ]
            batch, spec = pack_requests(payloads, msg["batch_size"])
            with on_card, torch.inference_mode():
                out = infer(batch.to(dev))
            responses = unpack_responses(out, spec)
            for r, resp in zip(reqs, responses):
                client.put(
                    SCOPE_OUT, str(r["id"]),
                    json.dumps(
                        {
                            "value": np.asarray(
                                torch.as_tensor(resp).cpu()).tolist(),
                            "worker": host_id,
                        }
                    ).encode(),
                )
            served += 1
            if on_batch is not None:
                on_batch(
                    {
                        "host": host_id,
                        "batch": served,
                        "lease": msg["lease"],
                        "n_reqs": len(reqs),
                        "fill": spec.fill,
                    }
                )
