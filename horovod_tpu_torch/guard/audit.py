"""Cross-replica consistency audit: detect, localize and heal silent state
divergence.

The port of the JAX package's ``guard/audit.py``. Every replica must hold
the same state; a bit flip in one host's memory breaks that while every
heartbeat stays green. The audit closes the loop:

1. **Detect** -- every ``audit_every`` committed steps each rank takes a
   crc32 fingerprint of its replicated training state (parameters, the
   optimizer state's replicated part and the step; the guard's own
   bookkeeping is left out) and the fingerprints are all-gathered.
2. **Localize** -- a majority vote over them: ranks off the majority
   value are the corrupt minority.
3. **Heal** -- broadcast-resync from the lowest majority rank (every rank
   takes part, so the collective schedule stays aligned; majority ranks
   get their own bytes back). With no strict majority (a tie), or with
   rank-sharded state whose integrity a vote cannot attest, the audit
   raises a recoverable :class:`~..exceptions.HorovodInternalError`
   instead and the elastic restore path walks back to the last commit.

The fingerprint hashes each tensor's raw bytes (a bf16 tensor through its
``uint8`` view), its shape and dtype, in the reference's walk order:
dict keys sorted, fields in order. The ZeRO-1 flat shards and the EF
residuals (:class:`~..ops.fusion.FlatBuckets`) are rank-local in the
port -- each rank holds its own -- so the walk skips them; a state that
carries them escalates to walk-back on divergence, as the reference's
sharded state does.

The transport is injectable (``allgather_object`` / ``broadcast_leaf``)
so the vote and heal logic runs in tests without a live world; the
default rides :func:`~..functions.allgather_object` and
:func:`~..ops.collectives.broadcast`. A minority host is reported to the
elastic driver's health scoring through the rendezvous KV (scope
``guard``, key ``divergent/<host>``; :meth:`ConsistencyAuditor._kv_report`)
-- outside a launch the report is only logged -- or to the caller's
``on_report`` hook.
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..exceptions import HorovodInternalError
from ..obs import registry as _obs
from ..ops.fusion import FlatBuckets

__all__ = [
    "AuditReport",
    "ConsistencyAuditor",
    "fingerprint",
    "majority_vote",
]

log = logging.getLogger("horovod_tpu_torch.guard")


def _walk(tree):
    """The audited leaves of ``tree``, in walk order."""
    if tree is None or isinstance(tree, FlatBuckets):
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def _leaf_bytes(leaf) -> Tuple[str, str, bytes]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return (str(tuple(t.shape)), str(t.dtype).replace("torch.", ""),
                raw)
    arr = np.asarray(leaf)
    return (str(arr.shape), str(arr.dtype),
            np.ascontiguousarray(arr).tobytes())


def fingerprint(tree) -> int:
    """Deterministic crc32 of every audited leaf of ``tree`` (values,
    shapes and dtypes, in walk order); a leaf numpy cannot hold hashes its
    repr. Equal to the reference's fingerprint of the same values."""
    crc = 0
    for leaf in _walk(tree):
        try:
            shape, dtype, raw = _leaf_bytes(leaf)
        except (TypeError, ValueError):
            crc = zlib.crc32(repr(leaf).encode(), crc)
            continue
        crc = zlib.crc32(shape.encode() + dtype.encode(), crc)
        crc = zlib.crc32(raw, crc)
    return crc & 0xFFFFFFFF


def majority_vote(checksums: List[int]) -> Tuple[Optional[int], List[int]]:
    """``(majority_value, minority_ranks)`` over per-rank checksums. A
    strict majority (> half the ranks) is needed to localize; without one
    (a 1-1 tie at world 2) the vote returns ``(None, [])``: divergence is
    detected but cannot be blamed, so healing falls back to walk-back."""
    counts: Dict[int, int] = {}
    for c in checksums:
        counts[c] = counts.get(c, 0) + 1
    value, n = max(counts.items(), key=lambda kv: (kv[1], -kv[0]))
    if n * 2 <= len(checksums):
        return None, []
    return value, [r for r, c in enumerate(checksums) if c != value]


@dataclasses.dataclass
class AuditReport:
    """Outcome of one audit round (the same on every rank)."""

    step: int
    checksums: List[int]
    hosts: List[str]
    diverged: bool
    minority_ranks: List[int] = dataclasses.field(default_factory=list)
    root_rank: int = 0
    healed: str = ""  # "" | "resync" | "walkback"

    def as_record(self) -> dict:
        return {
            "kind": "guard_audit",
            "step": self.step,
            "diverged": self.diverged,
            "minority_ranks": list(self.minority_ranks),
            "minority_hosts": [self.hosts[r] for r in self.minority_ranks],
            "root_rank": self.root_rank,
            "healed": self.healed,
        }


def _default_transport():
    from .. import context as _ctx
    from ..functions import allgather_object
    from ..ops.collectives import broadcast

    def broadcast_leaf(t, root: int, name: str):
        del name
        return broadcast(t, root)

    rank = _ctx.rank() if _ctx.is_initialized() else 0
    return rank, allgather_object, broadcast_leaf


class ConsistencyAuditor:
    """One process's audit endpoint.

    ``audit(tree, step)`` must be called by **every** rank of the world at
    the same step (the guarded step's wrapper keys it to the committed
    step count). Returns ``(tree, AuditReport)``, the tree healed in place
    where it diverged. ``has_sharded`` marks trees carrying rank-sharded
    state a replicated vote cannot attest: divergence there escalates to
    walk-back. ``on_report(host, count)`` hears each minority host, from
    the lowest majority rank only (one report per divergence)."""

    def __init__(
        self,
        *,
        rank: Optional[int] = None,
        host_id: str = "",
        allgather_object: Optional[Callable] = None,
        broadcast_leaf: Optional[Callable] = None,
        on_report: Optional[Callable[[str, int], None]] = None,
    ):
        if allgather_object is None or broadcast_leaf is None or rank is None:
            d_rank, d_ag, d_bc = _default_transport()
            rank = d_rank if rank is None else rank
            allgather_object = allgather_object or d_ag
            broadcast_leaf = broadcast_leaf or d_bc
        self.rank = rank
        self.host_id = host_id
        self._allgather_object = allgather_object
        self._broadcast_leaf = broadcast_leaf
        self._on_report = on_report if on_report is not None else self._kv_report
        self._report_counts: Dict[str, int] = {}
        self._audits = 0
        self._current_step = 0  # the KV report's job-monotonic nonce
        # Set before the walk-back raise, so a harness still sees the
        # evidence of a divergence healed by restore rather than resync.
        self.last_report: Optional[AuditReport] = None
        self._last_verified_step: Optional[int] = None

    @property
    def last_verified_step(self) -> Optional[int]:
        """Step of the latest audit that left this rank holding
        vote-verified state (a clean round, or a resync); a walk-back
        does not count."""
        return self._last_verified_step

    @staticmethod
    def _log_report(host: str, count: int) -> None:
        log.warning("consistency audit: host %s diverged (%d times)",
                    host, count)

    def _kv_report(self, host: str, count: int) -> None:
        """Default report channel: the elastic rendezvous KV (scope
        ``guard``, key ``divergent/<host>``), which the driver's main loop
        polls into ``HostManager`` health scoring. The value embeds the
        audit STEP -- a job-monotonic nonce -- because the reporter's own
        tally is process-local: a respawned (or newly elected) reporter
        restarts at 1, and the driver must still see a CHANGED value for
        every new divergence. Outside a launch it only logs."""
        from ..elastic import worker as _worker

        self._log_report(host, count)
        client = _worker._kv_client()
        if client is None:
            return
        try:
            client.put(
                "guard",
                f"divergent/{host}",
                f"{count}:{self._current_step}".encode(),
            )
        except OSError:
            pass  # telemetry-grade: the resync itself already healed us

    def _report(self, hosts: List[str], minority_ranks: List[int]) -> None:
        for r in minority_ranks:
            host = hosts[r] or f"rank{r}"
            self._report_counts[host] = self._report_counts.get(host, 0) + 1
            self._on_report(host, self._report_counts[host])

    def audit(self, tree, step: int, *, has_sharded: bool = False):
        """Run one audit round; see the class docstring."""
        self._audits += 1
        self._current_step = step  # nonce for the default KV channel
        reg = _obs.metrics()
        reg.counter("guard.audits").inc()
        local = fingerprint(tree)
        gathered = self._allgather_object(
            {"rank": self.rank, "host": self.host_id, "crc": local}
        )
        gathered = sorted(gathered, key=lambda d: d["rank"])
        checksums = [d["crc"] for d in gathered]
        hosts = [d.get("host", "") for d in gathered]
        majority, minority = majority_vote(checksums)
        diverged = len(set(checksums)) > 1
        report = AuditReport(
            step=step, checksums=checksums, hosts=hosts, diverged=diverged
        )
        self.last_report = report
        if not diverged:
            self._last_verified_step = step
            return tree, report
        reg.counter("guard.divergences").inc()
        reg.event(
            "guard.divergence", step=step,
            minority=[hosts[r] for r in minority] or "unlocalized",
        )
        if majority is None or has_sharded:
            report.healed = "walkback"
            if majority is not None:
                report.minority_ranks = minority
                if self.rank == self._lowest_majority(checksums, majority):
                    self._report(hosts, minority)
            reg.counter("guard.walkbacks").inc()
            raise HorovodInternalError(
                f"silent replica divergence at step {step} "
                f"(checksums {checksums}); "
                + ("no majority to resync from"
                   if majority is None
                   else "sharded state cannot be vote-verified")
                + " -- restoring the last committed state"
            )
        report.minority_ranks = minority
        root = self._lowest_majority(checksums, majority)
        report.root_rank = root
        if self.rank == root:
            self._report(hosts, minority)
        healed = self.resync(tree, root)
        report.healed = "resync"
        self._last_verified_step = step
        reg.counter("guard.resyncs").inc()
        reg.event(
            "guard.resync", step=step, root=root,
            minority=[hosts[r] for r in minority],
        )
        return healed, report

    @staticmethod
    def _lowest_majority(checksums: List[int], majority: int) -> int:
        return min(r for r, c in enumerate(checksums) if c == majority)

    def resync(self, tree, root: int):
        """Broadcast every audited leaf from ``root`` (every rank calls it).
        Tensors and numpy arrays are overwritten in place, so a module
        trained in place keeps its parameters; the tree is returned."""
        for i, leaf in enumerate(_walk(tree)):
            if isinstance(leaf, torch.Tensor):
                healed = self._broadcast_leaf(leaf.detach(), root,
                                              f"guard.resync.{i}")
                with torch.no_grad():
                    leaf.copy_(torch.as_tensor(healed).reshape(leaf.shape))
            elif isinstance(leaf, np.ndarray):
                healed = self._broadcast_leaf(torch.from_numpy(leaf), root,
                                              f"guard.resync.{i}")
                leaf[...] = torch.as_tensor(healed).numpy().reshape(
                    leaf.shape)
        return tree
