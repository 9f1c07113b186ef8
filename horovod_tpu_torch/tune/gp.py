"""Gaussian-process expected-improvement engine.

A copy of the JAX package's ``tune/gp.py`` (pure Python: ``math`` and
``random``, no tensor library), itself the Python form of the native
autotuner's math (``csrc/parameter_manager.cc`` at the repository root):
the ``GaussianProcess`` (RBF kernel, target standardization, jittered
Cholesky, triangular solves) and ``BestByExpectedImprovement`` (EI argmax
over uniform candidate draws with the sd==0 guard). It is pinned against
the C++ by ``tests/fixtures/gp_parity.json`` to 1e-9
(``tests/test_torch_port_tune.py``), and draws the same candidates as the
JAX package's copy for the same seed and trial.

Differences from the C++, all generalizations rather than divergences:

* dimensionality is free (the C++ hard-codes ``std::array<double, 2>``;
  the knob registry produces d-dimensional unit vectors) — at d=2 the
  arithmetic is identical, which is what the fixture pins;
* candidates are an explicit argument (the C++ draws them from an
  ``std::mt19937`` member). :func:`candidates_for_trial` provides the
  deterministic replacement: draws are a pure function of
  ``(seed, trial index)``, which is what lets a crash-adopted driver
  resume a search from journaled history and land on the *identical*
  remaining trial sequence.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

# Constants mirror the C++ defaults (parameter_manager.h).
LENGTH_SCALE = 0.3
SIGNAL_VAR = 1.0
NOISE = 1e-4
JITTER = 1e-12
# Candidate draws per proposal (BestByExpectedImprovement's loop bound).
N_CANDIDATES = 256
# The sd==0 EI guard: a candidate numerically on top of an observation
# has no improvement potential and would poison the argmax with inf/NaN.
SD_GUARD = 1e-12


class GaussianProcess:
    """RBF-kernel GP with standardized targets (port of
    ``hvt::GaussianProcess``)."""

    def __init__(self, length_scale: float = LENGTH_SCALE,
                 signal_var: float = SIGNAL_VAR, noise: float = NOISE):
        self.length_scale = length_scale
        self.signal_var = signal_var
        self.noise = noise
        self._x: List[Tuple[float, ...]] = []
        self._y: List[float] = []
        self._chol: List[float] = []  # lower factor, row-major n*n
        self._alpha: List[float] = []
        self._y_mean = 0.0
        self._y_std = 1.0

    @property
    def fitted(self) -> bool:
        return bool(self._x)

    def kernel(self, a: Sequence[float], b: Sequence[float]) -> float:
        d2 = sum((ai - bi) * (ai - bi) for ai, bi in zip(a, b))
        return self.signal_var * math.exp(
            -d2 / (2 * self.length_scale * self.length_scale)
        )

    def fit(self, x: Sequence[Sequence[float]], y: Sequence[float]) -> None:
        self._x = [tuple(float(v) for v in p) for p in x]
        n = len(self._x)
        if n == 0:
            return
        # Standardize targets (sample std, floored like the C++).
        mean = sum(y) / n
        var = sum((v - mean) ** 2 for v in y)
        std = math.sqrt(var / (n - 1)) if n > 1 else 1.0
        if std < 1e-12:
            std = 1.0
        self._y_mean, self._y_std = mean, std
        self._y = [(v - mean) / std for v in y]

        # K + noise I, then in-place Cholesky (lower factor).
        chol = [0.0] * (n * n)
        for i in range(n):
            for j in range(i + 1):
                chol[i * n + j] = self.kernel(self._x[i], self._x[j]) + (
                    self.noise if i == j else 0.0
                )
        for i in range(n):
            for j in range(i + 1):
                s = chol[i * n + j]
                for k in range(j):
                    s -= chol[i * n + k] * chol[j * n + k]
                if i == j:
                    chol[i * n + j] = math.sqrt(max(s, JITTER))
                else:
                    chol[i * n + j] = s / chol[j * n + j]
        self._chol = chol
        # alpha = K^-1 y via two triangular solves.
        alpha = list(self._y)
        for i in range(n):  # L z = y
            s = alpha[i]
            for k in range(i):
                s -= chol[i * n + k] * alpha[k]
            alpha[i] = s / chol[i * n + i]
        for i in range(n - 1, -1, -1):  # L^T a = z
            s = alpha[i]
            for k in range(i + 1, n):
                s -= chol[k * n + i] * alpha[k]
            alpha[i] = s / chol[i * n + i]
        self._alpha = alpha

    def predict(self, x: Sequence[float]) -> Tuple[float, float]:
        """Posterior ``(mean, std)`` at ``x`` in original target units."""
        n = len(self._x)
        if n == 0:
            return 0.0, math.sqrt(self.signal_var)
        k = [self.kernel(x, xi) for xi in self._x]
        mu = sum(ki * ai for ki, ai in zip(k, self._alpha))
        # v = L^-1 k; var = k(x,x) - v.v
        v = list(k)
        chol = self._chol
        for i in range(n):
            s = v[i]
            for kk in range(i):
                s -= chol[i * n + kk] * v[kk]
            v[i] = s / chol[i * n + i]
        var = self.kernel(x, x) - sum(vi * vi for vi in v)
        return (
            mu * self._y_std + self._y_mean,
            math.sqrt(max(var, JITTER)) * self._y_std,
        )


def expected_improvement(mean: float, sd: float, y_best: float) -> float:
    """EI of a candidate with posterior ``(mean, sd)`` over the incumbent
    ``y_best`` (maximization). Callers must apply the sd guard first —
    this is the raw formula the C++ computes inline."""
    z = (mean - y_best) / sd
    cdf = 0.5 * math.erfc(-z / math.sqrt(2.0))
    pdf = math.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    return (mean - y_best) * cdf + sd * pdf


def best_by_ei(
    gp: GaussianProcess,
    y_best: float,
    candidates: Sequence[Sequence[float]],
) -> Tuple[Optional[int], List[float]]:
    """Argmax-EI over an explicit candidate list.

    Returns ``(index, ei_values)`` where ``ei_values[i]`` is the EI of
    candidate ``i`` (``nan`` where the sd==0 guard skipped it) and
    ``index`` is the first strict maximum — exactly the C++ ``>``
    comparison, so ties keep the earlier candidate. ``index`` is None
    when every candidate was guard-skipped (the caller falls back to
    its default candidate, as the C++ falls back to ``best_x``)."""
    best_ei = -1.0
    best_idx: Optional[int] = None
    eis: List[float] = []
    for i, x in enumerate(candidates):
        mean, sd = gp.predict(x)
        if sd < SD_GUARD:
            eis.append(float("nan"))
            continue
        ei = expected_improvement(mean, sd, y_best)
        eis.append(ei)
        if ei > best_ei:
            best_ei = ei
            best_idx = i
    return best_idx, eis


def candidates_for_trial(
    seed: int, trial: int, dims: int, n: int = N_CANDIDATES
) -> List[List[float]]:
    """Deterministic uniform candidate draws in ``[0,1]^dims`` for one
    trial: a pure function of ``(seed, trial)`` so resumed searches
    replay the exact fault-free proposal sequence (no shared RNG state
    to lose in a crash)."""
    rng = random.Random((int(seed) << 20) ^ (int(trial) * 0x9E3779B1))
    return [[rng.random() for _ in range(dims)] for _ in range(n)]
