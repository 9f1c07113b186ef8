"""Scoring plane: turn the obs gauges into one number per trial (the JAX
package's ``tune/scoring.py``, over the port's ``step.*`` and
``serve.request_ms`` instruments).

A trial is scored over a **window** of steps with a **warmup discard**
in front (``ParameterManager::CloseSample`` discards its warmup samples
the same way — a knob switch is followed by cold caches and, for
retrace knobs, a fresh compile; scoring those steps would bias every
trial toward "whatever we already run").

Scores are maximized (the GP convention the C++ sets with B/s):

* training: ``-mean step ms`` over the window (or ``+MFU`` when the
  step publishes it — ``metric="mfu"``);
* serving: ``-p95 request ms`` from the ``serve.request_ms`` histogram
  under live load.

The readers are injectable: the deterministic tuner tests feed analytic
fake gauges, the real planes feed wall time / the metrics registry.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..obs import registry as _obs
from ..utils import env as _env


class WindowScorer:
    """Accumulate per-step observations; emit a score per closed window.

    ``add(value)`` returns the window score once ``warmup_steps`` have
    been discarded and ``window_steps`` accumulated, else ``None``.
    ``reset()`` starts the next trial's warmup (called at every knob
    switch).
    """

    def __init__(self, window_steps: Optional[int] = None,
                 warmup_steps: Optional[int] = None,
                 reduce: str = "mean", sign: float = -1.0):
        self.window_steps = (
            window_steps if window_steps is not None
            else _env.autotune_window_steps()
        )
        self.warmup_steps = (
            warmup_steps if warmup_steps is not None
            else _env.autotune_warmup_steps()
        )
        if self.window_steps < 1:
            raise ValueError("window_steps must be >= 1")
        if reduce not in ("mean", "max", "min"):
            raise ValueError(f"unknown reduce {reduce!r}")
        self.reduce = reduce
        # sign=-1: lower observations (step ms, p95) are better; the
        # search maximizes score. sign=+1 for already-higher-is-better
        # observations (MFU, tokens/s).
        self.sign = sign
        self._warmup_left = self.warmup_steps
        self._acc: list = []

    def reset(self) -> None:
        self._warmup_left = self.warmup_steps
        self._acc = []

    def add(self, value: float) -> Optional[float]:
        if self._warmup_left > 0:
            self._warmup_left -= 1
            return None
        self._acc.append(float(value))
        if len(self._acc) < self.window_steps:
            return None
        acc, self._acc = self._acc, []
        if self.reduce == "mean":
            v = sum(acc) / len(acc)
        elif self.reduce == "max":
            v = max(acc)
        else:
            v = min(acc)
        return self.sign * v


def step_time_reader() -> Callable[[], Optional[float]]:
    """Latest ``step.total_ms`` p50 from the metrics registry (None
    until the histogram has data). The wall-clock path in the autotune
    wrapper usually feeds durations directly; this reader exists for
    external loops that only have the obs plane."""
    hist = _obs.metrics().histogram("step.total_ms")

    def read() -> Optional[float]:
        s = hist.summary()
        return s.get("p50")

    return read


def mfu_reader() -> Callable[[], Optional[float]]:
    gauge = _obs.metrics().gauge("step.mfu")

    def read() -> Optional[float]:
        v = gauge.get()
        return v if v else None

    return read


class ServeLatencyScorer:
    """Serving twin: score a trial as ``-p95`` of the requests answered
    *during* the trial, warmup-discarded in responses instead of steps.

    Reads the cumulative ``serve.request_ms`` histogram; a trial closes
    once ``window_responses`` new responses landed after discarding the
    first ``warmup_responses``. The p95 is the histogram's (recent ring
    window), observed at close — under continuous load that window is
    dominated by the trial's own traffic.
    """

    def __init__(self, window_responses: int = 64,
                 warmup_responses: int = 16,
                 histogram=None):
        self._hist = (
            histogram if histogram is not None
            else _obs.metrics().histogram("serve.request_ms")
        )
        self.window_responses = max(1, window_responses)
        self.warmup_responses = max(0, warmup_responses)
        self._base_count = 0
        self.reset()

    def reset(self) -> None:
        self._base_count = int(self._hist.summary().get("count") or 0)

    def poll(self) -> Optional[float]:
        """Score once enough post-warmup responses landed, else None."""
        s = self._hist.summary()
        seen = int(s.get("count") or 0) - self._base_count
        if seen < self.warmup_responses + self.window_responses:
            return None
        p95 = s.get("p95")
        if p95 is None:
            return None
        return -float(p95)
