"""Retry/backoff primitives for the control plane (a copy of the JAX
package's ``utils/retry.py``; this package imports nothing of it).

* :class:`Backoff` -- capped exponential backoff with jitter for polling
  loops (``join_world``, ``RendezvousClient.wait``): jittered exponential
  spread keeps the early polls snappy while decorrelating the
  steady-state load on the rendezvous server.
* :func:`retry_call` -- bounded attempts with backoff and an overall
  deadline for transient failures: the checkpoint writer's filesystem
  blips and the KV client's requests (a connection reset, a listener
  restart, an injected chaos fault must not kill a worker that could
  have succeeded 100 ms later).

:class:`Backoff` takes an explicit ``rng`` so seeded runs stay
reproducible; callers that don't care get a module-private stream that
never perturbs ``random``'s global state.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Sequence, Type

_rng = random.Random()  # jitter-only stream; isolated from random.seed()


class Backoff:
    """Capped exponential backoff with jitter for polling loops.

    ``delay(i) = min(cap, base * factor**i)``, then scaled by a uniform
    factor in ``[1 - jitter, 1]`` so callers never sleep *longer* than
    the cap (deadline math stays simple) but decorrelate below it.
    """

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self._rng = rng if rng is not None else _rng
        self._attempt = 0

    def reset(self) -> None:
        """Back to the initial delay (the awaited event made progress)."""
        self._attempt = 0

    def next_delay(self) -> float:
        d = min(self.cap, self.base * (self.factor ** self._attempt))
        self._attempt += 1
        if self.jitter:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def sleep(self) -> float:
        """Sleep for the next delay; returns the slept duration."""
        d = self.next_delay()
        time.sleep(d)
        return d


def retry_call(
    fn: Callable,
    *,
    attempts: int = 4,
    retry_on: Sequence[Type[BaseException]] = (OSError,),
    should_retry: Optional[Callable[[BaseException], bool]] = None,
    base: float = 0.1,
    cap: float = 2.0,
    deadline: Optional[float] = None,
    on_retry: Optional[Callable[[BaseException, int], None]] = None,
    budget_reset: Optional[Callable[[BaseException], bool]] = None,
):
    """Call ``fn()``; on a transient failure, back off and try again.

    ``attempts`` bounds total calls (not just retries). ``retry_on``
    selects by type; ``should_retry`` (when given) additionally filters
    the caught exception — return False to re-raise immediately (e.g.
    an HTTP 4xx inside the URLError family is not transient).
    ``deadline`` is a wall-clock budget in seconds across all attempts;
    the final exception is always the last real failure, never a
    synthetic timeout. ``on_retry(exc, attempt)`` fires before each
    backoff sleep — the hook where callers count ``recovery.*`` metrics.

    ``budget_reset(exc)`` — inspected on EVERY caught failure, before
    the ``should_retry`` re-raise (so a reset-worthy signal on a
    non-retryable failure is still observed): return True to reset the
    attempt counter and the backoff to their initial state. The KV
    client uses this for its reconnect epochs ("fresh server = fresh
    budget"); the wall-clock ``deadline`` stays the hard bound, so a
    flapping trigger cannot extend the loop forever.
    """
    backoff = Backoff(base=base, cap=cap)
    t0 = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except tuple(retry_on) as e:
            if budget_reset is not None and budget_reset(e):
                attempt = 0
                backoff.reset()
            if should_retry is not None and not should_retry(e):
                raise
            out_of_budget = (
                attempt >= attempts
                or (deadline is not None
                    and time.monotonic() - t0 >= deadline)
            )
            if out_of_budget:
                raise
            if on_retry is not None:
                on_retry(e, attempt)
            backoff.sleep()
