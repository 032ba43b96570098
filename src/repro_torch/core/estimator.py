"""Runtime statistics of per-query processing times (paper Lines 2-3 /
Alg. 2 Line 2).

Everything the D&A arithmetic consumes is a statistic of per-query
processing times: ``t_max`` (Alg. 1), ``t_pre = sum t_i`` and ``t_avg``
(Alg. 2), and the Hoeffding pair ``(t_bar_k, t_hat)`` (Lemma 2).
``RuntimeStats`` holds them. A copy of ``repro.core.estimator.RuntimeStats``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RuntimeStats:
    """Statistics of a set of per-query processing times (seconds)."""

    times: np.ndarray

    def __post_init__(self) -> None:
        t = np.asarray(self.times, dtype=np.float64)
        if t.ndim != 1 or t.size == 0:
            raise ValueError("times must be a non-empty 1-D array")
        if np.any(t < 0) or not np.all(np.isfinite(t)):
            raise ValueError("times must be finite and non-negative")
        object.__setattr__(self, "times", t)

    @property
    def n(self) -> int:
        return int(self.times.size)

    @property
    def t_max(self) -> float:
        """max_i t_i  (Alg. 1 Line 3)."""
        return float(self.times.max())

    @property
    def t_avg(self) -> float:
        """mean t_i  (Alg. 2 Line 2). Clamped to ``t_max``: the float mean
        of equal samples can round one ulp above them, which would put the
        Lemma 2 upper bound ``t_hat`` below the mean."""
        return min(float(self.times.mean()), self.t_max)

    @property
    def t_pre(self) -> float:
        """sum t_i — preprocessing wall time on c=1 core (Alg. 2 Line 2)."""
        return float(self.times.sum())

    def t_pre_on(self, c: int) -> float:
        """Preprocessing wall time when the s samples run on ``c`` cores
        (LPT makespan approximation: ceil-balanced greedy)."""
        if c < 1:
            raise ValueError("c must be >= 1")
        if c == 1:
            return self.t_pre
        if c >= self.n:
            return self.t_max
        # Greedy longest-processing-time makespan (exact enough for stats).
        loads = np.zeros(c)
        for t in np.sort(self.times)[::-1]:
            loads[np.argmin(loads)] += t
        return float(loads.max())

    def t_hat(self, safety: float = 1.0) -> float:
        """Upper bound on query time for Lemma 2 (observed max x safety)."""
        if safety < 1.0:
            raise ValueError("safety factor must be >= 1")
        return self.t_max * safety

    def merged(self, other: "RuntimeStats") -> "RuntimeStats":
        return RuntimeStats(np.concatenate([self.times, other.times]))

    def scaled(self, factor: float) -> "RuntimeStats":
        """The same sample under a uniform time rescale — how the serving
        runtime models DCAF-style degradation (a cheaper answer per query)
        before any degraded measurement has been observed."""
        if factor <= 0:
            raise ValueError("factor must be > 0")
        return RuntimeStats(self.times * factor)
