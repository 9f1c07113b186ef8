"""Serving side of the weight stream: stage, verify, atomically flip.

The port of the JAX package's ``stream/subscriber.py``: it reads the JAX
package's frames as its own (a ``"bfloat16"`` bucket is read as torch's
bf16 from the same bytes), and the buckets land on the template's device
before they are unpacked.

:class:`StreamSubscriber` polls the ``stream`` KV scope from a daemon
thread and drives :meth:`DecodeEngine.hot_swap`'s streamed mode.  The
delivery contract, in order of what can go wrong:

* **Torn-set-proof** — every bucket the manifest names is staged and
  CRC-verified against the manifest *before* anything flips; a missing,
  truncated, corrupted, or mismatched bucket rejects the whole version
  (``stream.torn_rejected``) and the previous weights keep serving.
  The flip itself is one :meth:`hot_swap` call under the engine's
  condition lock — decode workers pick the new set up between rounds,
  never mid-round, and never see a partial set.
* **Epoch-guarded** — a manifest from a lower publisher epoch than the
  highest ever seen is a late write from a dead/replaced trainer:
  dropped (``stream.epoch_rejected``).  Within an epoch versions must
  strictly increase; an epoch bump resets the version floor (the
  respawned trainer resumes from its restored checkpoint step).
* **Guard walk-back** — a ``guard`` scope divergence report at or past
  the step of the currently-served version means the audited training
  plane disowned what we are serving: serving walks back to the newest
  intact checkpoint via the manifest-verified
  :func:`checkpoint.hot_swap_restore` path (``stream.rollbacks``).
* **Staleness fallback** — when no version has applied for
  ``HVDTPU_STREAM_STALENESS_SECS`` (trainer gone, KV wedged, guard gate
  stuck shut), the subscriber falls back to the
  :class:`~horovod_tpu.checkpoint.CheckpointWatcher` path and serves
  whole checkpoints until the stream resumes (``stream.fallbacks``).
* **KV outages** — reads ride :class:`utils.retry.Backoff`; the poll
  loop degrades to capped exponential backoff and recovers without
  operator action.

Int8 serving: with ``weight_dtype="int8"`` each *changed* bucket is
re-quantized on arrival through :func:`..ops.quantization.quantize_params`
(kernel 4 at block = K on the card); unchanged buckets keep their
already-quantized leaves -- the delta encoding carries through
quantization.

The layout is the JAX package's: the template is walked in its tree order
(:func:`~.publisher.as_tree`, so a flat dict of dotted names matches the
nested tree a trainer or a server holds), and a template given as a flat
dict gets a flat dict back.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..obs import stream as _sobs
from ..ops.batching import pack_spec, tree_flatten, tree_unflatten, unpack
from ..utils import env as _env
from ..utils.retry import Backoff
from . import protocol as _proto
from .protocol import TornSetError
from .publisher import TORCH_DTYPES, as_tree

log = logging.getLogger("horovod_tpu_torch.stream")

SCOPE = "stream"


def _kv_get(kv, scope: str, key: str) -> Optional[bytes]:
    """One-key read against either a :class:`RendezvousClient`
    (``get``) or an in-process :class:`RendezvousServer`
    (``scope_items``)."""
    if hasattr(kv, "get"):
        return kv.get(scope, key)
    return kv.scope_items(scope).get(key)


def _kv_scope(kv, scope: str) -> Dict[str, bytes]:
    if hasattr(kv, "scope_items"):
        return kv.scope_items(scope)
    out: Dict[str, bytes] = {}
    for key in kv.keys(scope):
        val = kv.get(scope, key)
        if val is not None:
            out[key] = val
    return out


class StreamSubscriber:
    """Applies published weight versions to a decode engine.

    ``engine`` needs ``params`` (the template tree the pack layout is
    derived from) and ``hot_swap(params, version=...)``; ``apply``
    overrides the flip for non-engine targets.  ``kv`` may be a client,
    an in-process server, or a zero-arg callable returning the current
    one (re-evaluated every poll, so a driver adoption that replaces
    the server object is followed automatically).
    """

    def __init__(
        self,
        engine: Any,
        template_params: Any = None,
        *,
        kv: Any = None,
        scope: str = SCOPE,
        poll_secs: float = 0.25,
        staleness_secs: Optional[float] = None,
        watcher: Any = None,
        ckpt_dir: Optional[str] = None,
        restore_target: Any = None,
        weight_dtype: Optional[str] = None,
        threshold_bytes: Optional[int] = None,
        apply: Optional[Callable[[Any, Optional[int]], None]] = None,
    ):
        if kv is None:
            from ..elastic.worker import _kv_client

            kv = _kv_client()
        self._kv_source = kv
        self.engine = engine
        self.scope = scope
        self.poll_secs = max(0.01, float(poll_secs))
        self.staleness_secs = (
            _env.stream_staleness_secs()
            if staleness_secs is None
            else float(staleness_secs)
        )
        self.ckpt_dir = ckpt_dir
        self.watcher = watcher
        if watcher is None and ckpt_dir is not None:
            from ..checkpoint import CheckpointWatcher

            self.watcher = CheckpointWatcher(ckpt_dir)
        self.restore_target = restore_target
        self.weight_dtype = weight_dtype
        self.threshold_bytes = threshold_bytes
        self._apply_fn = apply
        self._template = (
            template_params
            if template_params is not None
            else getattr(engine, "params", None)
        )
        if self._template is None:
            raise ValueError(
                "StreamSubscriber needs a parameter template (engine.params "
                "or template_params=) to reproduce the pack layout"
            )
        self._tree = as_tree(self._template)
        self._flat_names = (
            list(self._template) if self._tree is not self._template
            else None)
        leaves, _ = tree_flatten(self._tree)
        self.device = (leaves[0].device if leaves
                       and isinstance(leaves[0], torch.Tensor)
                       else torch.device("cpu"))
        # All mutable subscription state below is touched by the poll
        # thread and read by harnesses/tests under this one lock.
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._spec = None  # lazily: pack layout from the template
        self._spec_threshold: Optional[int] = None
        self._head_raw: Optional[bytes] = None  # last head bytes processed
        self._max_epoch = -1
        self._last_version: Optional[int] = None
        self._last_version_step: Optional[int] = None
        self._bucket_crcs: Dict[int, int] = {}  # applied crc per bucket
        self._q_leaves: Optional[List[Any]] = None  # int8 leaf cache
        self._guard_seen: Dict[str, bytes] = {}
        self._progress_t = time.time()
        self.applied_log: List[Tuple[int, int]] = []  # (version, epoch)
        self.n_applied = 0
        self.n_torn = 0
        self.n_epoch_rejected = 0
        self.n_fallbacks = 0
        self.n_rollbacks = 0
        self.last_error: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StreamSubscriber":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="hvdtpu-stream-sub", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout)

    def _kv(self):
        src = self._kv_source
        return src() if callable(src) else src

    def _run(self) -> None:
        backoff = Backoff(base=0.05, cap=2.0)
        while not self._stop.is_set():
            try:
                self.poll_once()
                backoff.reset()
                delay = self.poll_secs
            except OSError as e:
                # KV outage: degrade to capped exponential backoff and
                # keep serving the weights already flipped in.
                with self._lock:
                    self.last_error = repr(e)
                delay = backoff.next_delay()
            except Exception:  # noqa: BLE001 - subscription must not die
                log.exception("weight stream: subscriber poll failed")
                delay = backoff.next_delay()
            self._stop.wait(delay)

    # -- one poll ----------------------------------------------------------

    def poll_once(self) -> Optional[int]:
        """One subscription round: ingest the head (if new), then run
        the guard walk-back check and the staleness watchdog.  Returns
        the version applied by this call, if any.  Raises ``OSError``
        on KV outages (the loop backs off); never raises on torn or
        stale data — those are *rejections*, counted and logged."""
        kv = self._kv()
        applied = None
        if kv is not None:
            applied = self._ingest_head(kv)
            self._check_guard_strike(kv)
        staleness = time.time() - self._progress_t
        _sobs.set_staleness(staleness)
        if applied is None:
            self._maybe_fallback(staleness)
        return applied

    def _ingest_head(self, kv) -> Optional[int]:
        head = _kv_get(kv, self.scope, _proto.HEAD_KEY)
        if head is None or head == self._head_raw:
            return None
        # Mark processed BEFORE verification: a torn/stale head is
        # counted once, not once per poll tick.
        self._head_raw = head
        try:
            manifest = _proto.unframe_manifest(head)
        except TornSetError as e:
            self._reject_torn(f"manifest: {e}")
            return None
        epoch = int(manifest.get("epoch", 0))
        version = int(manifest.get("version", 0))
        if epoch < self._max_epoch:
            with self._lock:
                self.n_epoch_rejected += 1
            _sobs.record_epoch_rejected()
            log.warning(
                "weight stream: rejected version %d from stale epoch %d "
                "(highest seen %d) — late write from a dead trainer",
                version, epoch, self._max_epoch,
            )
            return None
        if epoch == self._max_epoch and (
            self._last_version is not None and version <= self._last_version
        ):
            return None  # nothing new (or a same-epoch replay)
        t0 = time.time()
        try:
            tree, crcs = self._stage(kv, manifest)
        except TornSetError as e:
            self._reject_torn(f"version {version}: {e}")
            return None
        self._flip(tree, version)
        with self._lock:
            self._max_epoch = epoch
            self._last_version = version
            self._last_version_step = int(manifest.get("step", version))
            self._bucket_crcs = crcs
            self.n_applied += 1
            self.applied_log.append((version, epoch))
            self._progress_t = time.time()
        _sobs.record_applied(version, (time.time() - t0) * 1e3)
        log.info(
            "weight stream: applied version %d (epoch %d) in %.1f ms",
            version, epoch, (time.time() - t0) * 1e3,
        )
        return version

    def _reject_torn(self, why: str) -> None:
        with self._lock:
            self.n_torn += 1
            self.last_error = why
        _sobs.record_torn_rejected()
        log.warning(
            "weight stream: REJECTED torn/corrupt set (%s) — previous "
            "weights keep serving", why,
        )

    # -- staging -----------------------------------------------------------

    def _local_spec(self, layout: dict):
        threshold = layout.get("threshold")
        if threshold is None:
            threshold = self.threshold_bytes
        if self._spec is None or self._spec_threshold != threshold:
            _, spec = pack_spec(self._tree, threshold)
            self._spec = spec
            self._spec_threshold = threshold
            self._q_leaves = None  # layout changed: quant cache is void
        sizes = list(self._spec.padded_sizes())
        if (
            int(layout.get("n_buckets", -1)) != len(self._spec.buckets)
            or [int(s) for s in layout.get("sizes", [])] != sizes
        ):
            raise TornSetError(
                "pack layout mismatch between publisher and this "
                f"subscriber's template (theirs {layout.get('sizes')}, "
                f"ours {sizes}) — refusing to scatter into the wrong slots"
            )
        return self._spec

    def _stage(self, kv, manifest: dict):
        """Fetch + verify EVERY bucket of the manifest, then unpack.
        All-or-nothing: any failure raises :class:`TornSetError` before
        anything is visible to the engine."""
        spec = self._local_spec(manifest.get("layout") or {})
        entries = manifest.get("buckets") or []
        if len(entries) != len(spec.buckets):
            raise TornSetError(
                f"manifest names {len(entries)} buckets, layout has "
                f"{len(spec.buckets)}"
            )
        buffers: List[torch.Tensor] = [None] * len(entries)  # type: ignore
        changed: List[int] = []
        for entry in sorted(entries, key=lambda e: int(e["index"])):
            i = int(entry["index"])
            if not 0 <= i < len(buffers) or buffers[i] is not None:
                # A CRC-valid frame can still carry a malformed bucket
                # list; out-of-range or duplicate indices must reject
                # through the same torn-set accounting as every other
                # bad manifest, not escape as an IndexError.
                raise TornSetError(
                    f"manifest bucket index {i} out of range or "
                    f"duplicated (need each of 0..{len(buffers) - 1} "
                    "exactly once)"
                )
            blob = _kv_get(kv, self.scope, entry["key"])
            header, payload = _proto.unframe_blob(blob)  # raises on damage
            _proto.verify_bucket(header, payload, entry)
            dtype = TORCH_DTYPES.get(entry["dtype"])
            if dtype is None:
                raise TornSetError(
                    f"bucket {i} has an unknown dtype {entry['dtype']!r}")
            buffers[i] = torch.frombuffer(
                bytearray(payload), dtype=dtype).to(self.device)
            if self._bucket_crcs.get(i) != int(entry["crc"]):
                changed.append(i)
        tree = self._unpack(buffers, spec, changed)
        return tree, {
            int(e["index"]): int(e["crc"]) for e in entries
        }

    def _untree(self, tree):
        """The applied set in the template's own form (a flat dict of
        dotted names back from the nested tree)."""
        if self._flat_names is None:
            return tree
        leaves, _ = tree_flatten(tree)
        by_path = dict(zip(self._tree_paths(), leaves))
        return {name: by_path[name] for name in self._flat_names}

    def _tree_paths(self) -> List[str]:
        paths: List[str] = []

        def walk(node, prefix):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], f"{prefix}{k}.")
            elif isinstance(node, (list, tuple)):
                for i, c in enumerate(node):
                    walk(c, f"{prefix}{i}.")
            else:
                paths.append(prefix[:-1])

        walk(self._tree, "")
        return paths

    def _unpack(self, buffers, spec, changed: List[int]):
        tree = unpack(buffers, spec)
        if self.weight_dtype != "int8":
            return self._untree(tree)
        # Per-bucket re-quantization on arrival: only the buckets whose
        # bytes changed re-quantize; untouched buckets keep their
        # already-quantized leaves from the previous version.
        from ..ops.quantization import quantize_params

        leaves, treedef = tree_flatten(tree)
        if self._q_leaves is None or len(self._q_leaves) != len(leaves):
            self._q_leaves = [None] * len(leaves)
            changed = list(range(len(spec.buckets)))
        q = list(self._q_leaves)
        for b in changed:
            for slot in spec.buckets[b]:
                q[slot.index] = quantize_params(leaves[slot.index])
        for i, leaf in enumerate(leaves):
            if q[i] is None:
                q[i] = quantize_params(leaf)
        self._q_leaves = q
        return self._untree(tree_unflatten(treedef, q))

    def _flip(self, tree, version: Optional[int]) -> None:
        if self._apply_fn is not None:
            self._apply_fn(tree, version)
        else:
            self.engine.hot_swap(tree, version=version)

    # -- guard walk-back ---------------------------------------------------

    def _check_guard_strike(self, kv) -> None:
        """A divergence report (``guard`` scope, ``divergent/<host>`` =
        ``b"count:step"``) at or past the served version's step means
        the training plane disowned what we are serving — walk back to
        the newest intact checkpoint."""
        if self.ckpt_dir is None or self._last_version is None:
            return
        try:
            items = _kv_scope(kv, "guard")
        except OSError:
            return  # the walk-back is best-effort under KV outage
        fresh: Dict[str, bytes] = {}
        strike_step = None
        for key, raw in items.items():
            if not key.startswith("divergent/"):
                continue
            if self._guard_seen.get(key) == raw:
                continue
            fresh[key] = raw
            try:
                strike_step = max(
                    strike_step or 0, int(raw.decode().rsplit(":", 1)[1])
                )
            except (ValueError, IndexError):
                continue
        if not fresh:
            return
        served_step = self._last_version_step or self._last_version
        if strike_step is None or strike_step < served_step:
            # Unparseable, or the strike predates what we serve:
            # consumed with no action owed.
            self._guard_seen.update(fresh)
            return
        log.warning(
            "weight stream: guard divergence at step %d covers the served "
            "version %d — walking serving back via the checkpoint manifest",
            strike_step, self._last_version,
        )
        if self._restore_from_checkpoint(step=None):
            # Only a SUCCESSFUL walk-back consumes the strike; a failed
            # restore (transient FS/KV error, no intact checkpoint yet)
            # leaves it fresh so every later poll retries instead of
            # serving disowned weights forever on the strength of one
            # log line.  A post-heal version applying meanwhile advances
            # served_step past the strike, which then retires above.
            self._guard_seen.update(fresh)
            with self._lock:
                self.n_rollbacks += 1
                # The walked-back weights supersede the stream until a
                # post-heal version arrives (which is > last_version).
            _sobs.record_rollback()

    # -- staleness fallback ------------------------------------------------

    def _maybe_fallback(self, staleness: float) -> None:
        if self.watcher is None or staleness <= self.staleness_secs:
            return
        step = self.watcher.poll()
        if step is None:
            return
        log.warning(
            "weight stream: stalled %.1fs (> %.1fs) — falling back to "
            "checkpoint step %d via CheckpointWatcher",
            staleness, self.staleness_secs, step,
        )
        if self._restore_from_checkpoint(step=step):
            with self._lock:
                self.n_fallbacks += 1
                self._progress_t = time.time()
            _sobs.record_fallback()

    def _restore_from_checkpoint(self, step: Optional[int]) -> bool:
        if self.ckpt_dir is None:
            return False
        from ..checkpoint import hot_swap_restore

        target = (
            self.restore_target
            if self.restore_target is not None
            else self._template
        )
        try:
            state, got_step, rolled_back = hot_swap_restore(
                self.ckpt_dir, target, step=step
            )
        except Exception:  # noqa: BLE001 - keep serving current weights
            log.exception(
                "weight stream: checkpoint fallback restore failed; "
                "previous weights keep serving"
            )
            return False
        params = getattr(state, "params", state)
        if self.weight_dtype == "int8":
            from ..ops.quantization import quantize_params

            params = quantize_params(params)
            self._q_leaves = None  # whole-tree reload voids the cache
        self._flip(params, None)
        if rolled_back and step is not None and self.watcher is not None:
            # The pinned step was corrupt and quarantined; the watcher
            # never re-offers it (forward-only), nothing to rewind.
            pass
        return True
