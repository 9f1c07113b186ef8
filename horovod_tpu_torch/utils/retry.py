"""Retry/backoff primitives (a copy of the JAX package's
``utils/retry.py``; this package imports nothing of it).

* :class:`Backoff` — capped exponential backoff with jitter.
* :func:`retry_call` — bounded attempts with backoff for transient
  failures; the checkpoint writer retries a filesystem blip through it
  instead of aborting the save.

Both take an explicit ``rng`` so seeded runs stay reproducible; callers
that don't care get a module-private stream that never perturbs
``random``'s global state.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Sequence, Type

_rng = random.Random()  # jitter-only stream; isolated from random.seed()


class Backoff:
    """Capped exponential backoff with jitter.

    ``delay(i) = min(cap, base * factor**i)``, then scaled by a uniform
    factor in ``[1 - jitter, 1]`` so callers never sleep *longer* than
    the cap but decorrelate below it.
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
    base: float = 0.1,
    cap: float = 2.0,
    on_retry: Optional[Callable[[BaseException, int], None]] = None,
):
    """Call ``fn()``; on a failure of a ``retry_on`` type, back off and try
    again, at most ``attempts`` calls in all; the last failure is raised.
    ``on_retry(exc, attempt)`` fires before each backoff sleep."""
    backoff = Backoff(base=base, cap=cap)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except tuple(retry_on) as e:
            if attempt >= attempts:
                raise
            if on_retry is not None:
                on_retry(e, attempt)
            backoff.sleep()
