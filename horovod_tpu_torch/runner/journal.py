"""Durable control-plane journal: CRC-framed WAL + compacted snapshots.

The port of the JAX package's ``runner/journal.py``, with the same
on-disk format, so a journal written by either package recovers to the
same store in the other. The rendezvous KV store
(:mod:`.http_server`) and the elastic driver's authoritative state
(:mod:`.elastic_driver`) both live in one process's memory; this module
is the durability layer both lean on:

* an **append-only journal** (``journal.jsonl``) of mutation records,
  each line CRC-framed (``<crc32 hex> <compact json>``), flushed and
  fsync'd per append so a post-crash replay reconstructs the exact
  pre-crash state;
* **compacted snapshots** (``snapshot.json``, written atomically via
  tmp + fsync + rename) taken on round advance / size triggers, after
  which the journal restarts empty -- bounding replay time and disk
  growth (the compaction pass doubles as the KV garbage collector: only
  the current, already-GC'd store is snapshotted).

Recovery (:meth:`ControlPlaneJournal.recover`) loads the snapshot (if its
embedded CRC verifies), then replays journal records in order. A torn
tail -- the driver died mid-append -- stops the replay at the last intact
frame: the longest valid prefix wins, a damaged journal never crashes the
adopter. Records are idempotent full-value writes, so the
rename-then-truncate compaction window replays harmlessly.

Record vocabulary (``op`` key):

====================  ==================================================
``put``               KV write: ``scope``, ``key``, ``value`` (base64)
``del``               KV single-key delete: ``scope``, ``key``
``delscope``          KV scope drop: ``scope``
``clear``             KV full reset (a fresh rendezvous round 0)
``driver``            full driver-state snapshot: ``state`` (dict)
====================  ==================================================
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import zlib
from typing import Dict, Optional, Tuple

from ..obs import control as _ctl

log = logging.getLogger("horovod_tpu_torch.runner.journal")

JOURNAL_NAME = "journal.jsonl"
SNAPSHOT_NAME = "snapshot.json"

Store = Dict[str, Dict[str, bytes]]


def _frame(payload: str) -> str:
    """One journal line: crc32-of-payload, space, payload."""
    raw = payload.encode()
    return f"{zlib.crc32(raw) & 0xFFFFFFFF:08x} {payload}\n"


def _unframe(line: str) -> Optional[dict]:
    """Parse one framed line; None when the frame is damaged (torn tail,
    bit-rot) — the caller stops replaying there."""
    line = line.rstrip("\n")
    if len(line) < 10 or line[8] != " ":
        return None
    crc_hex, payload = line[:8], line[9:]
    try:
        want = int(crc_hex, 16)
    except ValueError:
        return None
    if zlib.crc32(payload.encode()) & 0xFFFFFFFF != want:
        return None
    try:
        rec = json.loads(payload)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


def _encode_value(value: bytes) -> str:
    return base64.b64encode(value).decode("ascii")


def _decode_value(raw: str) -> bytes:
    return base64.b64decode(raw.encode("ascii"))


def _apply(store: Store, rec: dict, driver_box: list) -> None:
    """Apply one recovered record to the store / driver-state box."""
    op = rec.get("op")
    if op == "put":
        store.setdefault(rec["scope"], {})[rec["key"]] = _decode_value(
            rec["value"]
        )
    elif op == "del":
        store.get(rec["scope"], {}).pop(rec["key"], None)
    elif op == "delscope":
        store.pop(rec["scope"], None)
    elif op == "clear":
        store.clear()
    elif op == "driver":
        driver_box[0] = rec.get("state")
    # Unknown ops are skipped (forward compatibility), not fatal.


class ControlPlaneJournal:
    """Write-ahead journal + snapshot pair under one directory.

    Thread-safe: the KV server's handler threads and the driver's run
    loop both append. Every append is flushed and fsync'd before it
    returns — control-plane mutation rates are tiny (rounds, beats,
    blacklists), so durability costs nothing that matters here.
    """

    def __init__(self, directory: str, fsync: bool = True):
        self.directory = os.path.abspath(directory)
        # Owner-only: the journal persists the job's HMAC secret (the
        # driver-state records) and the whole KV store — on a shared
        # machine neither may be readable by other local users, or any
        # of them could forge signed control-plane writes.
        os.makedirs(self.directory, mode=0o700, exist_ok=True)
        try:
            os.chmod(self.directory, 0o700)  # pre-existing dirs too
        except OSError:
            pass
        self._fsync = fsync
        self._lock = threading.Lock()
        self._fh = None
        self._records_since_compact = 0
        # Compactions taken, and the last recovery's replayed records and
        # torn-tail flag (the journal.* instruments count the same).
        self.compactions = 0
        self.last_recovery = (0, 0)

    @staticmethod
    def _opener(path, flags):
        return os.open(path, flags, 0o600)

    @property
    def journal_path(self) -> str:
        return os.path.join(self.directory, JOURNAL_NAME)

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.directory, SNAPSHOT_NAME)

    # ---- write side -----------------------------------------------------

    def _handle_locked(self):
        # _locked suffix: caller must hold self._lock (threadlint-checked).
        if self._fh is None or self._fh.closed:
            self._fh = open(self.journal_path, "a", encoding="utf-8",
                            opener=self._opener)
        return self._fh

    def append(self, rec: dict) -> None:
        """Durably append one record (flushed + fsync'd on return)."""
        line = _frame(json.dumps(rec, separators=(",", ":"), sort_keys=True))
        with self._lock:
            fh = self._handle_locked()
            fh.write(line)
            fh.flush()
            if self._fsync:
                os.fsync(fh.fileno())
            self._records_since_compact += 1
            size = fh.tell()
        _ctl.journal_appended(size, self._records_since_compact)

    def record_put(self, scope: str, key: str, value: bytes) -> None:
        self.append(
            {"op": "put", "scope": scope, "key": key,
             "value": _encode_value(value)}
        )

    def record_delete(self, scope: str, key: str) -> None:
        self.append({"op": "del", "scope": scope, "key": key})

    def record_delete_scope(self, scope: str) -> None:
        self.append({"op": "delscope", "scope": scope})

    def record_clear(self) -> None:
        self.append({"op": "clear"})

    def record_driver(self, state: dict) -> None:
        """Full driver-state snapshot record (latest one wins at
        recovery — driver state is small and mutation-driven)."""
        self.append({"op": "driver", "state": state})

    @property
    def journal_bytes(self) -> int:
        try:
            return os.path.getsize(self.journal_path)
        except OSError:
            return 0

    @property
    def records_since_compact(self) -> int:
        return self._records_since_compact

    # ---- compaction -----------------------------------------------------

    def compact(self, store: Store, driver_state: Optional[dict]) -> None:
        """Write an atomic snapshot of the full state, then restart the
        journal empty. Safe against a crash at any point: the snapshot
        rename is atomic, and journal records surviving past it replay
        idempotently over it."""
        payload = json.dumps(
            {
                "store": {
                    scope: {k: _encode_value(v) for k, v in kv.items()}
                    for scope, kv in store.items()
                },
                "driver": driver_state,
            },
            separators=(",", ":"), sort_keys=True,
        )
        doc = {
            "version": 1,
            "algo": "crc32",
            "crc32": zlib.crc32(payload.encode()) & 0xFFFFFFFF,
            "payload": payload,
        }
        with self._lock:
            tmp = self.snapshot_path + ".tmp"
            with open(tmp, "w", encoding="utf-8", opener=self._opener) as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snapshot_path)
            # Truncate AFTER the snapshot is durable; a crash in between
            # leaves already-snapshotted records in the journal, which
            # replay idempotently.
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
            self._fh = open(self.journal_path, "w", encoding="utf-8",
                            opener=self._opener)
            self._fh.flush()
            if self._fsync:
                os.fsync(self._fh.fileno())
            self._records_since_compact = 0
            self.compactions += 1
        _ctl.journal_compacted()
        _ctl.journal_appended(0, 0)

    # ---- recovery -------------------------------------------------------

    def _load_snapshot(self) -> Tuple[Store, Optional[dict]]:
        try:
            with open(self.snapshot_path, encoding="utf-8") as f:
                doc = json.load(f)
            payload = doc["payload"]
            if zlib.crc32(payload.encode()) & 0xFFFFFFFF != doc["crc32"]:
                raise ValueError("snapshot crc mismatch")
            data = json.loads(payload)
        except FileNotFoundError:
            return {}, None
        except (OSError, ValueError, KeyError, TypeError) as e:
            # A torn snapshot write never replaced the previous file
            # (atomic rename), so reaching here means genuine damage:
            # fall back to journal-only replay rather than crashing.
            log.warning("control-plane snapshot unreadable (%s); ignoring", e)
            return {}, None
        store: Store = {
            scope: {k: _decode_value(v) for k, v in kv.items()}
            for scope, kv in data.get("store", {}).items()
        }
        return store, data.get("driver")

    def recover(self) -> Tuple[Store, Optional[dict]]:
        """Reconstruct ``(kv_store, driver_state)``: snapshot first, then
        the journal's longest valid prefix. Never raises on damage."""
        store, driver_state = self._load_snapshot()
        driver_box = [driver_state]
        replayed = torn = 0
        try:
            with open(self.journal_path, encoding="utf-8") as f:
                for line in f:
                    rec = _unframe(line)
                    if rec is None:
                        # Torn tail: the writer died mid-append (or the
                        # tail bit-rotted). Everything before this frame
                        # is intact and already applied — stop here.
                        torn = 1
                        break
                    _apply(store, rec, driver_box)
                    replayed += 1
        except FileNotFoundError:
            pass
        if torn:
            log.warning(
                "journal tail damaged after %d intact record(s); "
                "recovered the longest valid prefix", replayed,
            )
        self.last_recovery = (replayed, torn)
        _ctl.journal_recovered(replayed, torn)
        return store, driver_box[0]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
            self._fh = None
