"""Wire framing for the trainer → decode-fleet weight stream: the JAX
package's ``stream/protocol.py``, byte for byte the same frames.

One published **version** is a set of per-bucket blobs plus one
manifest, all living in the ``stream`` KV scope:

* ``v<version>/<i>`` — bucket ``i``'s payload: the raw bytes of one
  fused 1-D buffer from :func:`horovod_tpu_torch.ops.batching.pack`, framed
  by :func:`frame_blob` (JSON header + payload, each CRC-guarded).
* ``head`` — the manifest (:func:`frame_manifest`), written **last**:
  version, publisher epoch, trained step, the pack layout the
  subscriber must reproduce locally, and for every bucket the KV key
  holding its current bytes plus the payload CRC.  A bucket unchanged
  since an earlier version keeps its old ``v<old>/<i>`` key — that is
  the delta encoding: only changed buckets are rewritten.

The subscriber treats the whole version as one atomic unit: it stages
every bucket the manifest names, re-checks every CRC against the
manifest, and only then flips serving.  Anything missing, truncated,
mis-framed, or CRC-mismatched raises :class:`TornSetError` — the
version is rejected wholesale and the previous weights keep serving.
Epoch and version ordering are the subscriber's business
(:mod:`horovod_tpu_torch.stream.subscriber`); this module only guarantees
"these bytes are exactly what one publisher framed".
"""

from __future__ import annotations

import json
import zlib
from typing import Any, Dict, Tuple

MAGIC = b"HVWS1"
HEAD_KEY = "head"


class TornSetError(Exception):
    """A version's staged set is incomplete or corrupt: a bucket is
    missing, a frame is truncated/mis-framed, or a CRC does not match.
    Never applied — the subscriber keeps serving the previous set."""


def bucket_key(version: int, index: int) -> str:
    return f"v{version}/{index}"


def frame_blob(meta: Dict[str, Any], payload: bytes) -> bytes:
    """``MAGIC <header-crc> <header-json>\\n<payload>``.  The header
    embeds ``crc`` (payload crc32) and ``nbytes``, so truncation and
    bit-rot are both caught by :func:`unframe_blob`."""
    header = dict(meta)
    header["crc"] = zlib.crc32(payload) & 0xFFFFFFFF
    header["nbytes"] = len(payload)
    hjson = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    hcrc = zlib.crc32(hjson) & 0xFFFFFFFF
    return MAGIC + f" {hcrc:08x} ".encode() + hjson + b"\n" + payload


def unframe_blob(blob: bytes) -> Tuple[Dict[str, Any], bytes]:
    """Inverse of :func:`frame_blob`; raises :class:`TornSetError` on
    any framing or checksum violation."""
    if blob is None:
        raise TornSetError("missing blob")
    if not blob.startswith(MAGIC + b" "):
        raise TornSetError("bad magic: not a weight-stream frame")
    try:
        rest = blob[len(MAGIC) + 1:]
        hcrc_hex, rest = rest.split(b" ", 1)
        hjson, payload = rest.split(b"\n", 1)
        want_hcrc = int(hcrc_hex, 16)
    except ValueError as e:
        raise TornSetError(f"truncated frame header: {e}") from None
    if zlib.crc32(hjson) & 0xFFFFFFFF != want_hcrc:
        raise TornSetError("frame header failed its crc")
    try:
        header = json.loads(hjson)
    except ValueError as e:
        raise TornSetError(f"unparseable frame header: {e}") from None
    if len(payload) != header.get("nbytes"):
        raise TornSetError(
            f"payload truncated: {len(payload)} bytes, header says "
            f"{header.get('nbytes')}"
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != header.get("crc"):
        raise TornSetError("payload failed its crc")
    return header, payload


def frame_manifest(
    *,
    version: int,
    epoch: int,
    step: int,
    layout: Dict[str, Any],
    buckets,
) -> bytes:
    """The version manifest: an empty-payload frame whose header names
    every bucket's KV key + payload CRC and the pack layout
    (``threshold``/per-bucket dtypes + padded element counts) the
    subscriber must reproduce from its own parameter template."""
    return frame_blob(
        {
            "kind": "manifest",
            "version": version,
            "epoch": epoch,
            "step": step,
            "layout": layout,
            "buckets": list(buckets),
        },
        b"",
    )


def unframe_manifest(blob: bytes) -> Dict[str, Any]:
    header, _ = unframe_blob(blob)
    if header.get("kind") != "manifest":
        raise TornSetError("head key does not hold a manifest frame")
    return header


def verify_bucket(header: Dict[str, Any], payload: bytes, entry) -> None:
    """Cross-check one staged bucket against its manifest entry — the
    frame's own CRC already passed; this catches a *wrong* (stale or
    substituted) blob sitting under the right key."""
    if header.get("crc") != entry["crc"] or len(payload) != entry["nbytes"]:
        raise TornSetError(
            f"bucket {entry['index']} does not match its manifest entry "
            f"(crc {header.get('crc')} != {entry['crc']})"
        )
