"""Whole-program SPMD certification: collective-schedule fingerprints.

The port of ``horovod_tpu/analysis/certify.py``: the same entry layout,
digest recipe and ``CERT_VERSION``, so a port rank's cert and a reference
rank's cert of the same schedule compare equal. An eager step has no
negotiator either: two ranks that assembled different programs (an
autotune retrace switch half-applied, an elastic rejoin under drifted env
knobs, one host flipping ``HVDTPU_COMPUTE_DTYPE``) hang at the first
collective whose sequence disagrees, with zero diagnostics. This module
turns "same program" into a checkable artifact:

* :func:`schedule_entries` — one plain-data record per collective of a
  fake-tensor record of the step (:mod:`.record`), in issue order,
  carrying exactly the co-executability surface (op kind, axis names,
  operand/result shapes+dtypes, payload bytes, enclosing frame kinds,
  reducing-ness). Op positions and frame paths are excluded, so
  refactors that don't change the wire don't change the cert.
* :class:`ScheduleCert` — the entries plus the world size and the
  predicted wire layout (``bucket_byte_layout`` /
  ``quantized_bucket_layout``), hashed into one stable sha256 digest.
  Every step built by ``dp.make_train_step`` exposes
  ``step.certify(state, batch) -> ScheduleCert``.
* :func:`diff_certs` — structured first-divergence diagnosis between
  two certs (the index where the schedules fork, both entries).
* :func:`publish_and_verify` — the cross-rank preflight gate: publish
  the cert to the launcher's KV under ``cert/<round>/<host>`` and verify
  that all ranks published an identical digest before dispatching a
  newly built program. A mismatch or a timeout surfaces as a loud
  structured diagnosis (trace-plane instant event + flight-recorder dump
  + ``cert.mismatch`` counter) and, under ``HVDTPU_CERT=raise``, a
  :class:`CertMismatchError` — never a silent hang.

The preflight arms automatically (default ``HVDTPU_CERT=warn``) on the
first call of every built step and after every autotune retrace rebuild,
but only where an elastic KV world exists
(:func:`horovod_tpu_torch.elastic.worker.cert_channel`); standalone
processes pay nothing but the env check.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

from .record import REDUCING_COLLECTIVE_PRIMS

# Bump when the canonical entry layout changes: certs of different
# versions never compare equal, so a mixed-version world is caught as a
# mismatch instead of a false match over differently-shaped hashes.
CERT_VERSION = 1

SCOPE = "cert"  # KV scope of the preflight protocol


def _aval_str(aval) -> str:
    """``dtype[d0,d1,...]`` — the shape/dtype identity of one aval,
    independent of var naming and weak-type spelling."""
    shape = ",".join(str(int(d)) for d in getattr(aval, "shape", ()))
    return f"{getattr(aval, 'dtype', aval)}[{shape}]"


def schedule_entries(record) -> List[Dict[str, Any]]:
    """One canonical record per collective of the recorded program, in
    issue order. Everything a peer rank must agree on to co-execute —
    and nothing else (no op positions, no frame paths)."""
    walk = record
    entries: List[Dict[str, Any]] = []
    for idx, site in enumerate(walk.collectives):
        entries.append(
            {
                "index": idx,
                "kind": site.kind,
                "axes": list(site.axes),
                "in": sorted(_aval_str(a) for a in site.in_avals),
                "out": sorted(_aval_str(a) for a in site.out_avals),
                "in_bytes": site.in_bytes,
                "out_bytes": site.out_bytes,
                "reduces": site.kind in REDUCING_COLLECTIVE_PRIMS,
                "control_flow": [f.kind for f in site.control_flow],
            }
        )
    return entries


@dataclasses.dataclass(frozen=True)
class ScheduleCert:
    """A stable fingerprint of one build's collective schedule.

    ``digest`` covers the schedule entries, the world size and the
    predicted wire layout — the full co-executability surface. ``meta``
    is informational (model/variant labels, build knobs) and excluded
    from the hash: two ranks labeling the same program differently must
    still certify equal.
    """

    digest: str
    n_collectives: int
    entries: Tuple[Dict[str, Any], ...]
    world: Optional[int] = None
    wire: Tuple[Any, ...] = ()
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "version": CERT_VERSION,
            "digest": self.digest,
            "n_collectives": self.n_collectives,
            "entries": list(self.entries),
            "world": self.world,
            "wire": list(self.wire),
            "meta": dict(self.meta),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleCert":
        return cls(
            digest=d["digest"],
            n_collectives=d["n_collectives"],
            entries=tuple(d.get("entries", ())),
            world=d.get("world"),
            wire=tuple(d.get("wire", ())),
            meta=dict(d.get("meta", {})),
        )


def _digest(entries, world, wire) -> str:
    canon = json.dumps(
        {
            "version": CERT_VERSION,
            "world": world,
            "wire": wire,
            "entries": entries,
        },
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def schedule_cert(
    record,
    *,
    world: Optional[int] = None,
    wire: Optional[List[Any]] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> ScheduleCert:
    """Fingerprint a recorded program. ``wire`` is the predicted bucket
    layout (``bucket_byte_layout`` rows as ``[dtype, bytes]`` pairs or
    ``quantized_bucket_layout`` dicts) — part of the digest, because two
    ranks disagreeing on the fusion policy produce different collective
    groups even when the un-fused schedule matches."""
    entries = schedule_entries(record)
    wire = list(wire or ())
    return ScheduleCert(
        digest=_digest(entries, world, wire),
        n_collectives=len(entries),
        entries=tuple(entries),
        world=world,
        wire=tuple(wire),
        meta=dict(meta or {}),
    )


def diff_certs(a: ScheduleCert, b: ScheduleCert) -> Optional[dict]:
    """Structured first-divergence diagnosis, or None when the certs
    match. The ``first_divergent_index`` is the schedule position where
    the two programs stop being co-executable — the collective a pod
    would hang at."""
    if a.digest == b.digest:
        return None
    if a.world != b.world:
        return {
            "reason": "world-mismatch",
            "first_divergent_index": None,
            "a_world": a.world,
            "b_world": b.world,
        }
    for i, (ea, eb) in enumerate(zip(a.entries, b.entries)):
        if ea != eb:
            return {
                "reason": "entry-mismatch",
                "first_divergent_index": i,
                "a_entry": dict(ea),
                "b_entry": dict(eb),
            }
    if a.n_collectives != b.n_collectives:
        i = min(a.n_collectives, b.n_collectives)
        longer = a if a.n_collectives > b.n_collectives else b
        return {
            "reason": "length-mismatch",
            "first_divergent_index": i,
            "a_n": a.n_collectives,
            "b_n": b.n_collectives,
            "extra_entry": dict(longer.entries[i]),
        }
    # Same schedule, different digest: the wire layouts disagree (same
    # un-fused collectives grouped into different buckets).
    return {
        "reason": "wire-mismatch",
        "first_divergent_index": None,
        "a_wire": list(a.wire),
        "b_wire": list(b.wire),
    }


class CertMismatchError(RuntimeError):
    """Preflight verification failed: ranks hold different programs (or
    the cert exchange timed out). ``report`` carries the structured
    diagnosis :func:`publish_and_verify` assembled."""

    def __init__(self, report: dict):
        self.report = report
        mism = report.get("mismatch")
        if mism:
            idx = mism.get("diff", {}).get("first_divergent_index")
            detail = (
                f"rank programs diverge (vs host {mism['host']}, first "
                f"divergent schedule index {idx})"
            )
        else:
            detail = (
                f"cert exchange incomplete: {report.get('n_published', 0)}"
                f"/{report.get('n_hosts', '?')} hosts published within "
                f"{report.get('timeout')}s"
            )
        super().__init__(
            f"SPMD certification preflight failed for round "
            f"{report.get('round')}: {detail}. Diagnose with "
            f"horovod_tpu_torch/tools/hvdtpu_verify.py (see docs/runbook.md: "
            f"'ranks built different programs')."
        )


def _diagnose(report: dict) -> None:
    """Loud and structured: trace-plane instant + flight dump + counter.
    The mode decides raise-vs-warn, not the diagnosis plumbing."""
    from ..obs import registry as _obs
    from ..obs import trace as _trace

    _trace.instant(
        "cert.mismatch",
        cat="cert",
        args={
            "round": report.get("round"),
            "host": report.get("host"),
            "digest": report.get("digest"),
            "hosts": report.get("hosts"),
            "mismatch": report.get("mismatch"),
        },
    )
    try:
        _trace.flight_dump("cert-mismatch")
    except OSError:  # a full disk must not mask the diagnosis
        pass
    _obs.metrics().counter("cert.mismatch").inc()


def publish_and_verify(
    kv,
    round_: Any,
    host: str,
    cert: ScheduleCert,
    *,
    n_hosts: int,
    mode: Optional[str] = None,
    timeout: Optional[float] = None,
    poll: float = 0.05,
) -> dict:
    """The cross-rank preflight gate (see module docstring).

    Publishes ``cert/<round>/<host>`` (idempotent full-value write) and
    polls the scope until all ``n_hosts`` entries for the round exist or
    ``timeout`` elapses, then verifies every digest equals ours. Returns
    the report dict; under ``mode='warn'`` mismatch/timeout emit a
    Python warning (plus the trace-plane diagnosis), under ``'raise'``
    they raise :class:`CertMismatchError`. KV outages are absorbed into
    the timeout path — the gate degrades loudly, never hangs."""
    from ..utils import env as _env

    if mode is None:
        mode = _env.cert_mode()
    if timeout is None:
        timeout = _env.cert_timeout_secs()
    prefix = f"{round_}/"
    try:
        kv.put(SCOPE, f"{round_}/{host}", json.dumps(cert.to_dict()).encode())
    except OSError:
        pass  # unreachable KV: the poll below times out loudly
    deadline = time.monotonic() + timeout
    published: Dict[str, dict] = {}
    while True:
        # keys() + get() is the worker-side RendezvousClient surface
        # (URLError/HTTPError are OSErrors — outages fall through to
        # the bounded-timeout path, never an exception or a hang).
        try:
            names = [k for k in kv.keys(SCOPE) if k.startswith(prefix)]
        except OSError:
            names = []
        published = {}
        for key in names:
            try:
                raw = kv.get(SCOPE, key)
            except OSError:
                raw = None
            if raw is None:
                continue
            try:
                published[key[len(prefix):]] = json.loads(raw.decode())
            except (ValueError, AttributeError):
                continue
        if len(published) >= n_hosts or time.monotonic() >= deadline:
            break
        time.sleep(min(poll, max(0.0, deadline - time.monotonic())))

    report: dict = {
        "round": round_,
        "host": host,
        "digest": cert.digest,
        "n_hosts": n_hosts,
        "n_published": len(published),
        "timeout": timeout,
        "hosts": {h: d.get("digest") for h, d in published.items()},
        "mismatch": None,
        "ok": True,
    }
    for other, d in sorted(published.items()):
        if other == host or d.get("digest") == cert.digest:
            continue
        report["mismatch"] = {
            "host": other,
            "diff": diff_certs(cert, ScheduleCert.from_dict(d)),
        }
        report["ok"] = False
        break
    if report["ok"] and len(published) < n_hosts:
        report["ok"] = False  # timed out short-handed: not certified
    if not report["ok"]:
        _diagnose(report)
        if mode == "raise":
            raise CertMismatchError(report)
        warnings.warn(
            f"hvdtpu cert preflight: {CertMismatchError(report)}",
            stacklevel=2,
        )
    return report


class KVCertChannel:
    """One worker's handle on the preflight protocol: the elastic KV
    client, this host's id, the joined round and the round's world size.
    Built by :func:`horovod_tpu_torch.elastic.worker.cert_channel` (the seam
    that owns the worker-side KV plumbing); unit-testable against any
    object with ``put``/``get``/``keys``."""

    def __init__(self, kv, host_id: str, round_: int, n_hosts: int):
        self.kv = kv
        self.host_id = host_id
        self.round_ = round_
        self.n_hosts = n_hosts

    def preflight(
        self,
        cert: ScheduleCert,
        *,
        tag: str = "",
        mode: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> dict:
        """Publish+verify under ``cert/<round>[.<tag>]/<host>``. ``tag``
        namespaces mid-round rebuilds (autotune retrace switches) so a
        rebuilt program's cert never races the pre-rebuild entry under
        the same key."""
        round_key = f"{self.round_}.{tag}" if tag else str(self.round_)
        return publish_and_verify(
            self.kv,
            round_key,
            self.host_id,
            cert,
            n_hosts=self.n_hosts,
            mode=mode,
            timeout=timeout,
        )
