"""HTTP KV rendezvous server and its client.

The port of the JAX package's ``runner/http_server.py``: the same wire
protocol, HMAC signing, identity epochs and journal, so a client of
either package talks to a server of either package. Parity:
``horovod/runner/http/http_server.py`` (``RendezvousServer`` ``:174``, KV
handler ``:35-110``) -- the bootstrap store launched processes use before
the data plane exists: the port's workers publish and read the
``torch.distributed`` store's address through it (``context.init``), and
the elastic driver publishes its rounds through it.

Protocol (scope-keyed like the reference):
  PUT  /<scope>/<key>   body = value bytes
  GET  /<scope>/<key>   -> 200 value | 404
  GET  /_scope/<scope>  -> newline-separated keys currently in scope
  DELETE /<scope>       -> drop scope (elastic re-rendezvous)
  DELETE /<scope>/<key> -> drop one key

High availability: with a :class:`~.journal.ControlPlaneJournal`
attached, every mutation is durably journaled before the response, so a
respawned (or :meth:`RendezvousServer.restart`-ed) server replays to the
exact pre-crash store. Every response carries the server's **identity
epoch** (``X-Hvdtpu-Epoch``, minted per listener incarnation): clients
watch it to tell "same server, still failing" from "fresh server, fresh
retry budget". HMAC replay protection composes with restarts because
every client retry re-signs with a fresh timestamp.

Telemetry: ``RendezvousClient.retries_seen`` (transient failures retried)
and ``.reconnects`` (epoch changes observed), counted also as
``recovery.kv_retries`` and ``recovery.kv_reconnects``.
"""

from __future__ import annotations

import collections
import errno
import secrets as _secrets_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, Optional, Tuple
from urllib.parse import unquote

from ..obs import control as _ctl
from ..obs import registry as _obs
from ..utils.retry import Backoff

from .secret import (
    DIGEST_HEADER,
    TS_HEADER,
    check_digest,
    compute_digest,
    env_secret,
    replay_window_seconds,
    signed_message,
)

# Server identity epoch: a fresh token per listener incarnation, echoed
# in every response so clients can detect a restart underneath them.
EPOCH_HEADER = "X-Hvdtpu-Epoch"

# Scopes whose writes are NOT journaled: heartbeat beats arrive every
# couple of seconds per host and each journaled write is an fsync under
# the store lock — yet an adopting driver deliberately discards the
# predecessor's lease books (beat values are opaque change tokens whose
# age only means something on the clock that observed them), so
# journaling them buys zero recovery fidelity at real hot-path cost.
# The clock beacon is the same shape at poll-tick rate: a timestamp
# only the incumbent driver's clock can vouch for (an adopter beacons
# its own clock the moment its poll loop starts).
UNJOURNALED_SCOPES = frozenset({"heartbeat", "clock"})


class _KVHandler(BaseHTTPRequestHandler):
    server_version = "HorovodTpuRendezvous/1.0"

    def log_message(self, fmt, *args):  # quiet
        pass

    def end_headers(self):
        # Every response — including 403/404 — advertises the listener
        # incarnation, so a client mid-retry can tell a restarted server
        # from a persistently failing one.
        self.send_header(EPOCH_HEADER, self.server.epoch)
        super().end_headers()

    def _parse(self) -> Tuple[str, str]:
        parts = [unquote(p) for p in self.path.split("/") if p]
        scope = parts[0] if parts else ""
        key = "/".join(parts[1:]) if len(parts) > 1 else ""
        return scope, key

    def _authorized(self, body: bytes = b"") -> bool:
        """HMAC check when the server holds a job secret (reference
        ``secret.py`` signing): digest over method+path+timestamp+body.
        The timestamp bounds replays to ``REPLAY_WINDOW_SECONDS``; for
        state-changing methods the exact digest is additionally rejected
        if seen before inside the window (idempotent GET polls are left
        alone — ``RendezvousClient.wait`` legitimately repeats them)."""
        import time

        secret = self.server.secret
        if not secret:
            return True
        window = replay_window_seconds()
        ts = self.headers.get(TS_HEADER, "")
        digest = self.headers.get(DIGEST_HEADER, "")
        reason = "bad digest"
        ok = check_digest(secret, signed_message(self.command, self.path, ts, body), digest)
        if ok:
            try:
                ok = abs(time.time() - float(ts)) <= window
                if not ok:
                    reason = (
                        "timestamp outside replay window "
                        f"({window:.0f}s; clock skew? set HVDTPU_REPLAY_WINDOW)"
                    )
            except ValueError:
                ok, reason = False, "missing/invalid timestamp header"
        if ok and self.command in ("PUT", "DELETE"):
            with self.server.lock:
                seen = self.server.seen_digests
                now = time.time()
                # A digest stays cached for 2x the window: a timestamp
                # may be up to `window` in the future, so its signature
                # remains valid for up to 2x window after first receipt.
                while seen and now - seen[0][0] > 2 * window:
                    seen.popleft()
                if any(d == digest for _, d in seen):
                    ok, reason = False, "replayed request"
                else:
                    seen.append((now, digest))
        if ok:
            return True
        msg = reason.encode()
        self.send_response(403)
        self.send_header("Content-Length", str(len(msg)))
        self.end_headers()
        self.wfile.write(msg)
        return False

    def do_PUT(self):
        scope, key = self._parse()
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        if not self._authorized(value):
            return
        with self.server.lock:
            self.server.store.setdefault(scope, {})[key] = value
            # Journal INSIDE the lock so replay order matches store
            # order; the append fsyncs before the 200 goes out — an
            # acknowledged write is a durable write.
            if (self.server.journal is not None
                    and scope not in UNJOURNALED_SCOPES):
                self.server.journal.record_put(scope, key, value)
            self.server.cond.notify_all()
        self.send_response(200)
        self.end_headers()

    def do_GET(self):
        if not self._authorized():
            return
        scope, key = self._parse()
        if scope == "_scope":
            with self.server.lock:
                keys = sorted(self.server.store.get(key, {}).keys())
            body = "\n".join(keys).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        with self.server.lock:
            value = self.server.store.get(scope, {}).get(key)
        if value is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_DELETE(self):
        if not self._authorized():
            return
        scope, key = self._parse()
        with self.server.lock:
            if key:
                # Single-key delete (the weight-stream GC pass).
                existed = self.server.store.get(scope, {}).pop(key, None)
                if (existed is not None
                        and self.server.journal is not None
                        and scope not in UNJOURNALED_SCOPES):
                    self.server.journal.record_delete(scope, key)
            else:
                self.server.store.pop(scope, None)
                if self.server.journal is not None:
                    self.server.journal.record_delete_scope(scope)
        self.send_response(200)
        self.end_headers()


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, secret: Optional[str] = None,
                 journal=None, store: Optional[Dict] = None):
        super().__init__(addr, _KVHandler)
        # ``store`` lets a restart/adoption seed the journal-recovered
        # state; a fresh listener starts empty.
        self.store: Dict[str, Dict[str, bytes]] = store if store is not None else {}
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.secret = secret
        self.journal = journal
        self.epoch = _secrets_mod.token_hex(8)  # identity per incarnation
        self.seen_digests = collections.deque()  # (recv time, digest)


# How long a listener waits for its given port to come free (start()).
REBIND_SECS = 10.0


class RendezvousServer:
    """In-process KV server; ``start()`` returns the bound port.

    With ``journal`` (or ``journal_dir``) attached, every mutation —
    HTTP or direct — is durably journaled, ``start()`` replays the
    journal into the store (crash recovery / adoption), and
    :meth:`restart` proves the loop in-process: tear the listener down
    hard and bring a fresh-epoch one up on the same port from the
    journal alone.
    """

    def __init__(self, host: str = "0.0.0.0", secret: Optional[str] = None,
                 journal=None, journal_dir: Optional[str] = None):
        if journal is None and journal_dir is not None:
            from .journal import ControlPlaneJournal

            journal = ControlPlaneJournal(journal_dir)
        self._host = host
        self._secret = secret
        self._journal = journal
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self.restarts = 0  # in-process restart() invocations (chaos/tests)

    @property
    def journal(self):
        return self._journal

    def start(self, port: int = 0,
              store: Optional[Dict[str, Dict[str, bytes]]] = None) -> int:
        """Listen on ``port`` (0: one the kernel picks). A given port -- a
        restart's, an adopter's -- was free a moment ago, and a socket
        another process opened in the gap may hold it for a while (the
        kernel hands a freed port out as an outgoing connection's source
        port): the bind is retried for up to :data:`REBIND_SECS`."""
        if store is None and self._journal is not None:
            store, _ = self._journal.recover()
        deadline = time.monotonic() + (REBIND_SECS if port else 0.0)
        backoff = Backoff(base=0.02, cap=0.5)
        while True:
            try:
                self._server = _Server(
                    (self._host, port), secret=self._secret,
                    journal=self._journal, store=store,
                )
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE or time.monotonic() > deadline:
                    raise
                backoff.sleep()
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self._server.server_address[1]

    def restart(self, replay: bool = True) -> str:
        """Hard listener restart on the same port (the ``kv.server``
        chaos site, and the unit seam for crash recovery): the old
        socket dies mid-conversation, a new incarnation — fresh
        identity epoch — comes up from the journal replay (``replay=
        False`` models a journal-less server: the store is LOST, which
        is exactly the negative the journal exists to prevent).
        Returns the new epoch."""
        assert self._server is not None
        port = self._server.server_address[1]
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        store = None if replay else {}
        self.start(port=port, store=store)
        self.restarts += 1
        return self._server.epoch

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]

    @property
    def epoch(self) -> str:
        """Current listener incarnation token (changes on restart)."""
        assert self._server is not None
        return self._server.epoch

    @property
    def secret(self) -> Optional[str]:
        """The job HMAC key this server enforces (None = open)."""
        return self._secret

    def put(self, scope: str, key: str, value: bytes) -> None:
        """Direct (in-process) KV write — what the elastic driver uses to
        publish rounds without going through its own HTTP socket."""
        assert self._server is not None
        with self._server.lock:
            self._server.store.setdefault(scope, {})[key] = value
            if self._journal is not None and scope not in UNJOURNALED_SCOPES:
                self._journal.record_put(scope, key, value)
            self._server.cond.notify_all()

    def delete(self, scope: str, key: str) -> None:
        """Direct single-key delete (stale preempt/exit flags at a
        respawn; the GC pass)."""
        assert self._server is not None
        with self._server.lock:
            existed = self._server.store.get(scope, {}).pop(key, None)
            if (existed is not None and self._journal is not None
                    and scope not in UNJOURNALED_SCOPES):
                self._journal.record_delete(scope, key)

    def delete_scope(self, scope: str) -> None:
        assert self._server is not None
        with self._server.lock:
            existed = self._server.store.pop(scope, None)
            if existed is not None and self._journal is not None:
                self._journal.record_delete_scope(scope)

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        """Direct (in-process) snapshot of one scope — the read half of
        :meth:`put` (the programmatic run collects results with it)."""
        assert self._server is not None
        with self._server.lock:
            return dict(self._server.store.get(scope, {}))

    def snapshot_store(self) -> Dict[str, Dict[str, bytes]]:
        """Deep copy of the whole store (diagnostics; NOT the compaction
        input — see :meth:`compact_journal`)."""
        assert self._server is not None
        with self._server.lock:
            return {s: dict(kv) for s, kv in self._server.store.items()}

    def compact_journal(self, driver_state: Optional[Dict]) -> None:
        """Snapshot + WAL truncation atomically WITH RESPECT TO KV
        writes: the store copy and the journal compaction happen under
        the store lock, so an acknowledged PUT can never land between
        "state snapshotted" and "its WAL record truncated" — which
        would durably lose it (it would be in neither file)."""
        assert self._server is not None and self._journal is not None
        with self._server.lock:
            store = {
                s: dict(kv) for s, kv in self._server.store.items()
                if s not in UNJOURNALED_SCOPES
            }
            self._journal.compact(store, driver_state)

    def gc(self, current_round: int, live_hosts: Iterable[str],
           keep_rounds: int = 2) -> int:
        """Bound store growth across a long elastic run: drop round
        scopes older than the newest ``keep_rounds`` (workers only ever
        read the current round, and one behind during a publish race)
        and per-host keys (heartbeat leases, guard divergence reports,
        preempt/exit flags) of hosts no longer in the world. Returns
        the number of entries removed. Journaled like any mutation, so
        a replayed store is as lean as the live one was — and the
        compaction that follows a round advance persists only the
        GC'd survivors."""
        assert self._server is not None
        live = set(live_hosts)
        removed = 0
        with self._server.lock:
            store, journal = self._server.store, self._journal
            floor = current_round - keep_rounds + 1
            for scope in list(store):
                for prefix in ("round_", "dist_"):
                    if scope.startswith(prefix):
                        tail = scope[len(prefix):]
                        if tail.isdigit() and int(tail) < floor:
                            store.pop(scope)
                            removed += 1
                            if journal is not None:
                                journal.record_delete_scope(scope)
            for scope in ("heartbeat", "preempt", "exit"):
                kv = store.get(scope, {})
                for host in [h for h in kv if h not in live]:
                    kv.pop(host)
                    removed += 1
                    if (journal is not None
                            and scope not in UNJOURNALED_SCOPES):
                        journal.record_delete(scope, host)
            guard = store.get("guard", {})
            for key in list(guard):
                if key.startswith("divergent/") and (
                    key[len("divergent/"):] not in live
                ):
                    guard.pop(key)
                    removed += 1
                    if journal is not None:
                        journal.record_delete("guard", key)
        return removed

    def init(self, slot_assignments, clear: bool = True) -> None:
        """Publish slot assignments (parity: RendezvousServer.init —
        resets the store for a new rendezvous round; ``clear=False``
        preserves caller-published keys, e.g. the programmatic run's
        pickled function)."""
        assert self._server is not None
        with self._server.lock:
            if clear:
                self._server.store.clear()
                if self._journal is not None:
                    self._journal.record_clear()
            scope = self._server.store.setdefault("rank", {})
            for slot in slot_assignments:
                value = slot.to_response_string().encode()
                scope[str(slot.rank)] = value
                if self._journal is not None:
                    self._journal.record_put("rank", str(slot.rank), value)

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()  # release the listening socket fd
            self._server = None
        if self._journal is not None:
            self._journal.close()


def _transient(e: BaseException) -> bool:
    """Is this request failure worth retrying? Server-side 5xx and the
    whole connection-level family (refused, reset, timed out, DNS) are
    transient; 4xx — auth rejection, genuine 404 — are answers."""
    import urllib.error

    if isinstance(e, urllib.error.HTTPError):
        return e.code >= 500
    return isinstance(e, (urllib.error.URLError, ConnectionError,
                          TimeoutError))


class RendezvousClient:
    """Tiny stdlib client for the KV server.

    With a job secret (explicit or ``HVDTPU_SECRET``), every request is
    HMAC-signed the way the reference signs its service messages.

    Transient failures (connection reset/refused, timeouts, 5xx —
    including injected ``kv.request`` chaos) are retried with
    exponential backoff up to ``retries`` total attempts
    (``HVDTPU_KV_RETRIES``): a single driver blip must not kill a worker
    that could have succeeded 100 ms later. Each attempt re-signs with a
    fresh timestamp so a retried PUT is never rejected as a replay.

    Reconnect epochs: every server response carries an identity token
    minted per listener incarnation. When the observed epoch CHANGES
    mid-retry, both the backoff delay and the attempt budget reset —
    a fresh server deserves a fresh budget, and a worker that backed
    off to the cap during an outage must not keep sitting at max delay
    against the healthy restart (resetting only on *success* would).
    The wall-clock deadline stays the hard stop either way."""

    def __init__(self, addr: str, port: int, timeout: float = 30.0,
                 secret: Optional[str] = None,
                 retries: Optional[int] = None):
        from ..utils import env as _envmod

        self._base = f"http://{addr}:{port}"
        self._timeout = timeout
        self._secret = secret if secret is not None else env_secret()
        self._retries = retries if retries is not None else _envmod.kv_retries()
        self._epoch: Optional[str] = None  # last server identity seen
        self.retries_seen = 0  # transient failures retried
        self.reconnects = 0  # server identity changes observed

    @property
    def server_epoch(self) -> Optional[str]:
        """Last server identity epoch observed (None before the first
        answered request). Polling loops (``wait``, ``join_world``)
        reset their own backoff when this changes."""
        return self._epoch

    def _note_epoch(self, epoch: Optional[str]) -> bool:
        """Record the epoch from a response (success OR an HTTP error —
        both prove a live listener); True when it changed."""
        if not epoch or epoch == self._epoch:
            return False
        changed = self._epoch is not None
        self._epoch = epoch
        if changed:
            self.reconnects += 1
            _ctl.kv_reconnected()
        return changed

    def _headers(self, method: str, path: str, body: bytes = b"") -> dict:
        import time

        if not self._secret:
            return {}
        ts = repr(time.time())
        msg = signed_message(method, path, ts, body)
        return {
            DIGEST_HEADER: compute_digest(self._secret, msg),
            TS_HEADER: ts,
        }

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None) -> bytes:
        """One signed request with transient-failure retry; the chaos
        ``kv.request`` site sits inside the attempt so injected faults
        exercise the same recovery a real blip would.

        Epoch-aware: an attempt that reaches a server with a NEW
        identity epoch (even via an HTTP error response) resets the
        backoff to its floor and re-opens the attempt budget — fresh
        server, fresh budget (``retry_call(budget_reset=)``). The
        wall-clock deadline remains the hard bound, so a flapping
        server cannot extend the retry loop forever."""
        import urllib.error
        import urllib.request

        from .. import chaos as _chaos
        from ..utils.retry import retry_call

        def attempt() -> bytes:
            if _chaos.enabled():
                fault = _chaos.act("kv.request", method=method, path=path)
                if fault is not None:
                    if fault.kind == "drop":
                        raise urllib.error.URLError(
                            "chaos: injected kv request drop"
                        )
                    if fault.kind == "error":
                        raise urllib.error.HTTPError(
                            f"{self._base}{path}", 500,
                            "chaos: injected server error", None, None,
                        )
            req = urllib.request.Request(
                f"{self._base}{path}", data=body, method=method,
                headers=self._headers(method, path, body or b""),
            )
            resp = urllib.request.urlopen(req, timeout=self._timeout)
            self._note_epoch(resp.headers.get(EPOCH_HEADER))
            return resp.read()

        def epoch_changed(e) -> bool:
            # An HTTP error response still carries the live listener's
            # epoch — a 5xx (or even a 404) from a RESTARTED server is
            # news even though the request failed.
            hdrs = getattr(e, "headers", None)
            return hdrs is not None and self._note_epoch(
                hdrs.get(EPOCH_HEADER)
            )

        def on_retry(e, attempt_no):
            self.retries_seen += 1
            _obs.metrics().counter("recovery.kv_retries").inc()

        return retry_call(
            attempt,
            attempts=self._retries,
            retry_on=(urllib.error.URLError, ConnectionError, TimeoutError),
            should_retry=_transient,
            base=0.1,
            cap=2.0,
            deadline=max(self._timeout, 5.0),
            on_retry=on_retry,
            budget_reset=epoch_changed,
        )

    def put(self, scope: str, key: str, value: bytes) -> None:
        self._request("PUT", f"/{scope}/{key}", value)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        import urllib.error

        try:
            return self._request("GET", f"/{scope}/{key}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def delete(self, scope: str, key: str) -> None:
        self._request("DELETE", f"/{scope}/{key}")

    def wait(self, scope: str, key: str, deadline: float = 60.0) -> bytes:
        import time

        from ..utils.retry import Backoff

        t0 = time.time()
        backoff = Backoff(base=0.02, cap=1.0)
        epoch = self._epoch
        while time.time() - t0 < deadline:
            val = self.get(scope, key)
            if val is not None:
                return val
            if self._epoch != epoch:
                # The server restarted under the poll: the key may have
                # been (re)published by whoever owns it — snap back to
                # the fast poll rate instead of riding the max delay.
                epoch = self._epoch
                backoff.reset()
            backoff.sleep()
        raise TimeoutError(f"rendezvous key {scope}/{key} not published")

    def keys(self, scope: str):
        body = self._request("GET", f"/_scope/{scope}")
        return [k for k in body.decode().split("\n") if k]
