"""The runtime's ParameterManager: Bayesian tuning of the fusion threshold
and the cycle time inside the background loop.

The port of the JAX package's ``csrc/parameter_manager.{h,cc}`` (after
Horovod's ``horovod/common/parameter_manager.h:42``):

* :class:`ParameterManager` -- rank 0's runtime feeds it every cycle's
  negotiated bytes (:meth:`~ParameterManager.update`); only busy cycles
  count toward a sample of ``steps_per_sample`` cycles. A closed sample
  scores bytes over its window's seconds; the first ``warmup_samples``
  windows are thrown away, each later one becomes a point of the GP, and
  the next knobs are the expected-improvement argmax over 256 candidates
  of the unit square (fusion threshold log2 in [20, 29], cycle time ln us
  in [4.605, 10.82]). Tuning ends after 10 windows without improvement or
  at 40, with the best knobs current;
* :class:`GpTuner1D` -- the same GP and acquisition over one log-scaled
  range (the ``hvt_tuner_*`` C ABI's tuner): lo, hi and the geometric mid
  first, then EI with the second coordinate pinned at 0.

The GP is :class:`..tune.gp.GaussianProcess`. The candidates are the C++'s
own stream, so proposals match it draw for draw: ``std::mt19937`` (seed
12345 for the manager, 20240731 for the 1-D tuner) through libstdc++'s
``uniform_real_distribution<double>(0, 1)`` -- two 32-bit words ``a``,
``b`` a double, ``(a + b * 2**32) / 2**64`` -- the first coordinate drawn
before the second. ``random.Random`` is the same generator: it is given
``std::mt19937``'s seeded state and read 32 bits at a time.
"""

from __future__ import annotations

import logging
import math
import random
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

from ..tune.gp import N_CANDIDATES, GaussianProcess, best_by_ei

log = logging.getLogger("horovod_tpu_torch.native")

# The search box (parameter_manager.cc:110-113): fusion threshold in
# [1 MB, 512 MB] as log2 bytes, cycle time in [100 us, 50 ms] as ln us.
FUSION_LO, FUSION_HI = 20.0, 29.0
CYCLE_LO, CYCLE_HI = 4.605, 10.82
MANAGER_SEED = 12345
TUNER_SEED = 20240731
MAX_SAMPLES = 40
PATIENCE = 10  # windows without improvement -> done


def mt19937(seed: int) -> random.Random:
    """A generator whose ``getrandbits(32)`` yields ``std::mt19937(seed)``'s
    words (``init_genrand``: the 624-word state of the C++ constructor)."""
    mt = [int(seed) & 0xFFFFFFFF]
    for i in range(1, 624):
        prev = mt[-1]
        mt.append((1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF)
    rng = random.Random()
    rng.setstate((3, tuple(mt) + (624,), None))
    return rng


def uniform01(rng: random.Random) -> float:
    """libstdc++'s ``generate_canonical<double, 53>`` on a 32-bit engine."""
    a = rng.getrandbits(32)
    b = rng.getrandbits(32)
    x = (float(a) + float(b) * 4294967296.0) / 18446744073709551616.0
    return x if x < 1.0 else math.nextafter(1.0, 0.0)


def best_by_expected_improvement(gp: GaussianProcess, y_best: float,
                                 rng: random.Random,
                                 fixed_dim1: Optional[float] = None
                                 ) -> List[float]:
    """``BestByExpectedImprovement`` (``parameter_manager.cc:180-206``):
    the EI argmax (:func:`..tune.gp.best_by_ei`: candidates with ``sd <
    1e-12`` skipped) over 256 draws of the unit square, each candidate's
    first coordinate drawn before its second; ``(0.5, 0.5)`` (``(0.5,
    fixed_dim1)``) when nothing beats -1."""
    pinned = fixed_dim1 is not None
    candidates = [[uniform01(rng), fixed_dim1 if pinned else uniform01(rng)]
                  for _ in range(N_CANDIDATES)]
    idx, _ = best_by_ei(gp, y_best, candidates)
    if idx is None:
        return [0.5, fixed_dim1 if pinned else 0.5]
    return candidates[idx]


class Params(NamedTuple):
    fusion_threshold_bytes: int
    cycle_time_us: int


def normalize(p: Params) -> List[float]:
    f = (math.log2(float(p.fusion_threshold_bytes)) - FUSION_LO) / (
        FUSION_HI - FUSION_LO)
    c = (math.log(float(p.cycle_time_us)) - CYCLE_LO) / (CYCLE_HI - CYCLE_LO)
    return [min(max(f, 0.0), 1.0), min(max(c, 0.0), 1.0)]


def denormalize(x: Sequence[float]) -> Params:
    """Unit square to knobs, truncated to int64 as ``static_cast`` does."""
    return Params(
        int(math.exp2(FUSION_LO + x[0] * (FUSION_HI - FUSION_LO))),
        int(math.exp(CYCLE_LO + x[1] * (CYCLE_HI - CYCLE_LO))))


class ParameterManager:
    """``hvt::ParameterManager``: see the module doc. ``clock`` returns
    seconds (``time.monotonic``, the C++'s ``steady_clock``)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.active = False
        self.done = False
        self.current = self.best = Params(128 << 20, 1000)
        self.best_score = 0.0
        self.warmup_left = 3
        self.steps_per_sample = 10
        self.steps_in_sample = 0
        self.bytes_in_sample = 0
        self.sample_start = 0.0
        self.samples_without_improvement = 0
        self.gp = GaussianProcess()
        self.xs: List[List[float]] = []
        self.ys: List[float] = []
        self.rng = mt19937(MANAGER_SEED)
        self._log = None
        # (fusion, cycle_us, score) of every scored window, in order.
        self.samples: List[tuple] = []

    def initialize(self, fusion0: int, cycle0_us: int, log_path: str = "",
                   warmup_samples: int = 3, steps_per_sample: int = 10
                   ) -> None:
        self.current = self.best = Params(int(fusion0), int(cycle0_us))
        self.warmup_left = int(warmup_samples)
        self.steps_per_sample = int(steps_per_sample)
        self.sample_start = self.clock()
        if log_path:
            self._log = open(log_path, "w")
        self.active = True

    def update(self, bytes_this_cycle: int) -> bool:
        """Record one cycle's negotiated bytes; True when a sample window
        closed (and the knobs may have changed)."""
        if not self.active or self.done:
            return False
        self.bytes_in_sample += int(bytes_this_cycle)
        if bytes_this_cycle > 0:
            self.steps_in_sample += 1
        if self.steps_in_sample < self.steps_per_sample:
            return False
        self.close_sample()
        return True

    def close_sample(self) -> None:
        now = self.clock()
        secs = now - self.sample_start
        score = self.bytes_in_sample / secs if secs > 0 else 0.0
        if self.warmup_left > 0:
            # Warm-up windows are thrown away (cold caches, first launches).
            self.warmup_left -= 1
        else:
            self.xs.append(normalize(self.current))
            self.ys.append(score)
            if score > self.best_score:
                self.best_score = score
                self.best = self.current
                self.samples_without_improvement = 0
            else:
                self.samples_without_improvement += 1
            self.samples.append((self.current.fusion_threshold_bytes,
                                 self.current.cycle_time_us, score))
            if self._log is not None:
                # Doubles as C++'s default operator<< prints them (%g).
                self._log.write(
                    f"{self.current.fusion_threshold_bytes}\t"
                    f"{self.current.cycle_time_us}\t{score:g}\t"
                    f"{self.best_score:g}\n")
                self._log.flush()
            if (self.samples_without_improvement >= PATIENCE
                    or len(self.xs) >= MAX_SAMPLES):
                self.done = True
                self.current = self.best
                log.info("autotune converged: fusion=%d cycle_us=%d "
                         "score=%g B/s", self.best.fusion_threshold_bytes,
                         self.best.cycle_time_us, self.best_score)
            else:
                self.gp.fit(self.xs, self.ys)
                self.current = self.propose()
        self.bytes_in_sample = 0
        self.steps_in_sample = 0
        self.sample_start = now

    def propose(self) -> Params:
        return denormalize(best_by_expected_improvement(
            self.gp, self.best_score, self.rng))

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None


class GpTuner1D:
    """``hvt::GpTuner1D``: a Bayesian search over ``[lo, hi]`` in log
    scale. ``propose()`` the next point, ``record(x, score)`` its score
    (higher is better), ``best()`` the best point recorded."""

    def __init__(self, lo: float, hi: float):
        lo, hi = float(lo), float(hi)
        if lo <= 0:
            lo = 1.0
        if hi <= lo:
            hi = lo * 2
        self.lo, self.hi = lo, hi
        self.best_x = lo
        self.best_score = -1e300
        self.gp = GaussianProcess()
        self.xs: List[List[float]] = []
        self.ys: List[float] = []
        self.rng = mt19937(TUNER_SEED)

    def to_unit(self, x: float) -> float:
        u = math.log(x / self.lo) / math.log(self.hi / self.lo)
        return min(max(u, 0.0), 1.0)

    def from_unit(self, u: float) -> float:
        return self.lo * math.exp(u * math.log(self.hi / self.lo))

    def propose(self) -> float:
        n = len(self.xs)
        if n == 0:
            return self.lo
        if n == 1:
            return self.hi
        if n == 2:
            return self.from_unit(0.5)
        self.gp.fit(self.xs, self.ys)
        return self.from_unit(best_by_expected_improvement(
            self.gp, self.best_score, self.rng, fixed_dim1=0.0)[0])

    def record(self, x: float, score: float) -> None:
        self.xs.append([self.to_unit(float(x)), 0.0])
        self.ys.append(float(score))
        if score > self.best_score:
            self.best_score = float(score)
            self.best_x = float(x)

    def best(self) -> float:
        return self.best_x

    @property
    def samples(self) -> int:
        return len(self.xs)
