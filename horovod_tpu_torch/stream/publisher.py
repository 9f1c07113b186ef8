"""Trainer side of the weight stream: capture, gate, frame, publish.

The port of the JAX package's ``stream/publisher.py``; the frames, keys and
manifests on the KV are byte for byte the JAX package's for the same
parameters, so either package's subscriber reads the other's versions.

:class:`WeightPublisher` turns the training plane's committed parameter
state into versioned per-bucket blobs on the journaled rendezvous KV
(scope ``stream``), at every ``HVDTPU_PUBLISH_EVERY`` committed steps.
Three properties the serving plane depends on:

* **Guard-gated** — with a guard runtime attached (``guard=True`` train
  steps), a delta captured at step ``S`` leaves the training plane only
  after a cross-replica audit has *verified* step ``>= S``
  (:meth:`GuardRuntime.last_verified_step`).  Until then it waits in a
  bounded pending queue; if the audit instead reports a divergence at
  or beyond ``S``, the suspect capture is discarded outright — a
  resync heals the live state, not a snapshot taken before the heal.
* **Delta-encoded** — buckets ride :func:`ops.batching.pack`'s fused
  layout; a bucket whose bytes did not change since the last *written*
  copy keeps its old KV key in the new manifest instead of being
  re-uploaded.
* **Captured at the commit** -- the port's optimizer updates the
  parameters in place, so a capture is a host copy of every bucket taken
  in :meth:`WeightPublisher.maybe_publish`, before the next step runs: a
  capture that waits behind the guard gate or a KV outage keeps its own
  step's bytes. The copy walks the parameters in the JAX package's tree
  order (:func:`as_tree`), and a bf16 bucket goes on the wire under the
  JAX package's dtype name ``"bfloat16"`` with the same bytes.
* **Torn-proof ordering** — bucket blobs are written first, the
  manifest (``head``) strictly last, so a reader never sees a manifest
  naming buckets the publisher has not finished writing.  The death of
  a publisher mid-set leaves the previous ``head`` intact.  The
  ``publish.delta`` chaos site injects the failure modes anyway
  (drop/corrupt/torn/delay), and the subscriber's CRC staging must
  reject them.

Publishes are epoch-stamped (``HVDTPU_SPAWN_ROUND`` by default): a
respawned trainer publishes under a higher epoch, and subscribers drop
late writes still arriving from its dead predecessor.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

import zlib

import numpy as np
import torch

from .. import chaos as _chaos
from ..obs import stream as _sobs
from ..ops.batching import pack
from ..utils import env as _env
from ..utils.retry import retry_call
from . import protocol as _proto

log = logging.getLogger("horovod_tpu_torch.stream")

SCOPE = "stream"

# Wire dtype names (numpy's, as the JAX package writes them) of the
# torch dtypes a parameter bucket can hold. bf16 has no numpy dtype: its
# bytes travel through a 16-bit integer view.
WIRE_DTYPES = {
    torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.float64: "float64",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64",
}
TORCH_DTYPES = {name: dt for dt, name in WIRE_DTYPES.items()}


def as_tree(params):
    """The JAX package's pytree for a parameter set: a flat dict of dotted
    names (what ``make_train_step`` trains) nests on the dots, a level
    whose keys are exactly ``0..n-1`` becoming a list, so a trainer's
    ``{"layers.0.wq": ...}`` packs in the order of the nested tree
    ``{"layers": [{"wq": ...}]}`` the serving model holds (numeric, not
    string, order of the layer indices). Anything else is returned as it
    is."""
    if not isinstance(params, dict) or not any(
            isinstance(k, str) and "." in k for k in params):
        return params
    root: dict = {}
    for name, leaf in params.items():
        node = root
        *path, last = str(name).split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out) and sorted(
                int(k) for k in out) == list(range(len(out))):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def host_copy(buf: torch.Tensor):
    """``(numpy array, wire dtype name)``: a host copy of one packed bucket
    (a fresh copy even of a CPU tensor, whose pack may be a view of a live
    parameter)."""
    t = buf.detach().to("cpu", copy=True).contiguous()
    name = WIRE_DTYPES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _corrupt(blob: bytes, rng) -> bytes:
    """Chaos ``publish.delta:corrupt`` — flip one payload byte using the
    rule's seeded stream (deterministic per seed, like ckpt.corrupt)."""
    if not blob:
        return blob
    b = bytearray(blob)
    i = (rng.randrange(len(b)) if rng is not None else len(b) - 1)
    b[i] ^= 0xFF
    return bytes(b)


class WeightPublisher:
    """Publishes committed weights as versioned per-bucket deltas.

    ``kv`` is anything with ``put(scope, key, bytes)`` — the elastic
    :class:`RendezvousClient` (default, when an elastic world is
    configured) or an in-process :class:`RendezvousServer`.  ``version``
    is the committed step the delta was captured at; versions are
    strictly increasing within one publisher epoch.
    """

    def __init__(
        self,
        kv: Any = None,
        *,
        publish_every: Optional[int] = None,
        epoch: Optional[int] = None,
        guard_runtime: Any = None,
        threshold_bytes: Optional[int] = None,
        max_pending: Optional[int] = None,
        scope: str = SCOPE,
    ):
        if kv is None:
            from ..elastic.worker import _kv_client

            kv = _kv_client()
        self.kv = kv
        self.publish_every = (
            _env.publish_every() if publish_every is None else int(publish_every)
        )
        self.epoch = (
            int(os.environ.get("HVDTPU_SPAWN_ROUND", "0") or 0)
            if epoch is None
            else int(epoch)
        )
        self.guard_runtime = guard_runtime
        self.threshold_bytes = threshold_bytes
        self.max_pending = (
            _env.stream_max_pending() if max_pending is None else int(max_pending)
        )
        self.scope = scope
        self._lock = threading.Lock()
        # step -> (np buffers, layout) captures awaiting the guard gate
        # or a KV recovery, oldest first.
        self._pending: Deque[Tuple[int, List[np.ndarray], dict]] = deque()
        self._purged_below: Optional[int] = None
        # Per-bucket state of the last copy actually WRITTEN to the KV:
        # (key, crc, nbytes).  A dropped/torn bucket never lands here,
        # so the next publish re-writes it instead of dangling a key.
        self._written: dict = {}
        # Bucket keys this publisher believes are live on the KV, and
        # the key set of the previous manifest — the GC pass retires
        # everything outside (current ∪ previous) after head moves.
        self._known_keys: set = set()
        self._prev_keys: set = set()
        self.last_version: Optional[int] = None
        self.n_published = 0
        self.n_blocked = 0
        self.n_torn_injected = 0

    # -- capture -----------------------------------------------------------

    def maybe_publish(self, params, step: int) -> Optional[int]:
        """Commit-path hook: capture a delta when ``step`` hits the
        publish cadence, then flush everything the guard gate allows.
        Returns the newest version published by this call (None when
        nothing went out)."""
        if self.kv is None or self.publish_every <= 0 or params is None:
            return None
        step = int(step)
        if step <= 0 or step % self.publish_every:
            return self.flush()
        # The threshold the buckets are packed with, resolved now and
        # written into the layout: left None, a subscriber would rebuild
        # the layout from its own process's HVDTPU_FUSION_THRESHOLD, which
        # the autotuner rewrites in this one between trials.
        threshold = (_env.fusion_threshold_bytes()
                     if self.threshold_bytes is None
                     else self.threshold_bytes)
        with torch.no_grad():
            buffers, spec = pack(as_tree(params), threshold)
            copies = [host_copy(b) for b in buffers]
        np_bufs = [a for a, _ in copies]
        layout = {
            "threshold": threshold,
            "n_buckets": len(np_bufs),
            "dtypes": [name for _, name in copies],
            "sizes": [int(b.size) for b in np_bufs],
        }
        with self._lock:
            self._pending.append((step, np_bufs, layout))
            while len(self._pending) > max(1, self.max_pending):
                dropped_step, _, _ = self._pending.popleft()
                _sobs.record_publish_dropped()
                log.warning(
                    "weight stream: pending delta at step %d dropped "
                    "(HVDTPU_STREAM_MAX_PENDING=%d exceeded while the "
                    "guard gate / KV held publishes back)",
                    dropped_step, self.max_pending,
                )
        return self.flush()

    # -- gate --------------------------------------------------------------

    def _verified_through(self) -> Optional[int]:
        """Highest step the guard plane has attested, or ``None`` for
        "ungated" (no guard runtime, or audits not armed).  An armed
        runtime whose first audit has not yet landed returns ``-1`` —
        a floor below every publishable step — so "armed but nothing
        verified yet" blocks everything instead of reading as
        ungated (e.g. ``audit_every`` ≫ ``publish_every``: the deltas
        captured before the first audit window must wait for it)."""
        gr = self.guard_runtime
        if gr is None or not getattr(gr, "audit_armed", False):
            return None
        verified = gr.last_verified_step
        return -1 if verified is None else int(verified)

    def _purge_suspect(self) -> None:
        """Drop pending captures a divergence report covers: a capture
        at step ``<= report.step`` may hold pre-heal (corrupt) bytes —
        the healed live state re-enters via a later commit instead."""
        gr = self.guard_runtime
        report = getattr(gr, "last_report", None) if gr is not None else None
        if report is None or not getattr(report, "diverged", False):
            return
        horizon = int(report.step)
        if self._purged_below is not None and horizon <= self._purged_below:
            return
        self._purged_below = horizon
        kept: Deque = deque()
        for item in self._pending:
            if item[0] <= horizon:
                _sobs.record_publish_dropped()
                log.warning(
                    "weight stream: discarding pending delta at step %d — "
                    "audit at step %d reported divergence (captures from "
                    "before the heal are not trustworthy)",
                    item[0], horizon,
                )
            else:
                kept.append(item)
        self._pending = kept

    def flush(self) -> Optional[int]:
        """Publish every pending delta the audit verdict covers."""
        if self.kv is None:
            return None
        last = None
        with self._lock:
            self._purge_suspect()
            verified = self._verified_through()
            while self._pending:
                step, bufs, layout = self._pending[0]
                if verified is not None and step > verified:
                    self.n_blocked += 1
                    _sobs.record_publish_blocked()
                    log.info(
                        "weight stream: delta at step %d held — guard "
                        "audit has only verified through %s",
                        step, verified,
                    )
                    break
                self._pending.popleft()
                v = self._publish(step, bufs, layout)
                if v is None:
                    # KV outage outlived the retry budget: put the
                    # capture back and try again on the next commit.
                    self._pending.appendleft((step, bufs, layout))
                    break
                last = v
        return last

    # -- the wire ----------------------------------------------------------

    def _put(self, key: str, blob: bytes) -> None:
        retry_call(
            lambda: self.kv.put(self.scope, key, blob),
            attempts=4,
            retry_on=(OSError,),
        )

    def _publish(self, step: int, bufs: List[np.ndarray], layout) -> Optional[int]:
        version = step
        chaos_on = _chaos.enabled()
        entries = []
        torn = False
        try:
            for i, buf in enumerate(bufs):
                payload = buf.tobytes()
                meta = {
                    "kind": "bucket",
                    "version": version,
                    "epoch": self.epoch,
                    "index": i,
                    "dtype": layout["dtypes"][i],
                    "size": int(buf.size),
                }
                blob = _proto.frame_blob(meta, payload)
                crc = zlib.crc32(payload) & 0xFFFFFFFF
                prev = self._written.get(i)
                entry = {
                    "index": i,
                    "crc": crc,
                    "nbytes": len(payload),
                    "dtype": layout["dtypes"][i],
                    "size": int(buf.size),
                }
                if prev is not None and prev[1] == crc and prev[2] == len(payload):
                    # Unchanged since the last written copy: the delta —
                    # reuse the old key, upload nothing.
                    entry["key"] = prev[0]
                    entries.append(entry)
                    continue
                key = _proto.bucket_key(version, i)
                entry["key"] = key
                entries.append(entry)
                if torn:
                    continue  # set aborted mid-write; manifest still moves
                corrupted = False
                if chaos_on:
                    fault = _chaos.act("publish.delta", step=step, bucket=i)
                    if fault is not None:
                        if fault.kind == "drop":
                            # Bucket silently lost: its key is named by
                            # the manifest but never written.
                            continue
                        if fault.kind == "torn":
                            # Abort the set mid-write but STILL move
                            # head: the torn-manifest case the staging
                            # CRC check must reject wholesale.
                            torn = True
                            self.n_torn_injected += 1
                            continue
                        if fault.kind == "corrupt":
                            blob = _corrupt(blob, fault.rng)
                            corrupted = True
                self._put(key, blob)
                if not corrupted:
                    # A chaos-corrupted write must NOT enter the
                    # unchanged-bucket cache, or every later manifest
                    # would keep pointing at the bad copy.
                    self._written[i] = (key, crc, len(payload))
        except OSError:
            log.warning(
                "weight stream: KV unreachable publishing version %d; "
                "delta stays pending", version, exc_info=True,
            )
            return None
        manifest = _proto.frame_manifest(
            version=version, epoch=self.epoch, step=step,
            layout=layout, buckets=entries,
        )
        try:
            self._put(_proto.HEAD_KEY, manifest)
        except OSError:
            log.warning(
                "weight stream: KV unreachable writing manifest for "
                "version %d; delta stays pending", version, exc_info=True,
            )
            return None
        self.last_version = version
        self.n_published += 1
        self._gc_superseded({e["key"] for e in entries})
        _sobs.record_published(version)
        log.info(
            "weight stream: published version %d (epoch %d, %d buckets)%s",
            version, self.epoch, len(entries),
            " [chaos: torn]" if torn else "",
        )
        return version

    def _gc_superseded(self, current_keys: set) -> None:
        """Retire bucket blobs no manifest can reach any more, so a
        long-running trainer does not grow the journaled KV (and its
        WAL) without bound.  Keys named by the current or the
        immediately previous manifest are protected — an in-flight
        reader may still be staging the head this one just replaced.
        Best-effort: per-key deletes need a KV with ``delete`` (the
        in-process server, or a :class:`RendezvousClient` against it);
        either way ``stream.kv_retained_keys`` makes the live set —
        and any growth — visible to operators."""
        protect = current_keys | self._prev_keys
        delete = getattr(self.kv, "delete", None)
        if delete is not None:
            for key in sorted(self._known_keys - protect):
                try:
                    delete(self.scope, key)
                    self._known_keys.discard(key)
                except OSError:
                    pass  # stays known; retried after the next publish
        self._known_keys |= current_keys
        self._prev_keys = current_keys
        _sobs.set_kv_retained(len(self._known_keys))


# -- module-level commit hook ----------------------------------------------
#
# ``elastic.State.commit`` fires :func:`on_commit` when a publisher is
# active; the double-checked module global keeps the disabled-path cost
# of every commit at one attribute read (mirrors the chaos plane).

_ACTIVE: Optional[WeightPublisher] = None


def activate(pub: WeightPublisher) -> WeightPublisher:
    global _ACTIVE
    _ACTIVE = pub
    return pub


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[WeightPublisher]:
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def on_commit(state, commit_count: int) -> Optional[int]:
    """Called by ``State.commit`` after the committed state is durable.
    Publishes ``state.params`` (states without a ``params`` field are
    not streamable and no-op)."""
    pub = _ACTIVE
    if pub is None:
        return None
    params = getattr(state, "params", None)
    if params is None:
        return None
    step = getattr(state, "step", None)
    try:
        step = int(step) if step is not None else int(commit_count)
    except (TypeError, ValueError):
        step = int(commit_count)
    try:
        return pub.maybe_publish(params, step)
    except Exception:  # noqa: BLE001 - publishing must never kill training
        log.exception("weight stream: publish hook failed (non-fatal)")
        return None
