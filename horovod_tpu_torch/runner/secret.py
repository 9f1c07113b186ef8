"""Shared-secret HMAC helpers for launcher<->worker traffic.

A copy of the JAX package's ``runner/secret.py`` (this package imports
nothing of it), so either package's client talks to either package's
rendezvous server under one job key. Parity: ``horovod/runner/common/
util/secret.py`` -- the launcher mints a per-job key, workers receive it
through their env, and every rendezvous request is authenticated with an
HMAC-SHA256 digest over method, path, timestamp and body. Without a key
the KV stays open, matching the reference's unauthenticated HTTP
rendezvous.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets as _secrets
from typing import Optional

ENV_SECRET = "HVDTPU_SECRET"
DIGEST_HEADER = "X-Hvdtpu-Digest"
TS_HEADER = "X-Hvdtpu-Ts"

# Default clock-skew / replay tolerance; the live value is always read
# through replay_window_seconds().
REPLAY_WINDOW_SECONDS = 90.0


def replay_window_seconds() -> float:
    """Signed requests with a timestamp further than this from server
    time are rejected, which bounds both clock-skew tolerance and the
    server's replay-cache size. ``HVDTPU_REPLAY_WINDOW`` widens it for
    clusters with drifting clocks (the 403 reason is also sent in the
    response body so skew is diagnosable)."""
    try:
        return float(
            os.environ.get("HVDTPU_REPLAY_WINDOW", str(REPLAY_WINDOW_SECONDS))
        )
    except ValueError:
        return REPLAY_WINDOW_SECONDS


def make_secret_key() -> str:
    """Fresh per-job key (hex, 32 random bytes)."""
    return _secrets.token_hex(32)


def signed_message(method: str, path: str, ts: str, body: bytes = b"") -> bytes:
    """Canonical byte string covered by the request HMAC. The timestamp
    is inside the digest so a network observer cannot replay a captured
    PUT (e.g. re-publish a stale elastic round) outside the window."""
    return f"{method} {path} {ts} ".encode() + body


def compute_digest(key: str, message: bytes) -> str:
    return hmac.new(key.encode(), message, hashlib.sha256).hexdigest()


def check_digest(key: str, message: bytes, digest: str) -> bool:
    return hmac.compare_digest(compute_digest(key, message), digest or "")


def env_secret() -> Optional[str]:
    return os.environ.get(ENV_SECRET) or None
