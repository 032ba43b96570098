"""Lower bounds on the required core count (paper Lemma 1 and Lemma 2).

Lemma 1 (from Algorithm 1's balance argument):
    k >= X * t_max / T

Lemma 2 (Hoeffding baseline, the paper's comparison target):
    C >= (X / T) * ( t_bar_k + sqrt( t_hat^2 * ln(2/p_f) / (2k) ) )

Both are pure arithmetic over runtime statistics; they are algorithm-agnostic
(nothing PPR-specific), which is what lets the same admission logic govern
LM/GNN/recsys serving in ``launch/serve.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .estimator import RuntimeStats


def lemma1_lower_bound(num_queries: int, t_max: float, deadline: float) -> float:
    """Minimum cores (Lemma 1): ``X * t_max / T``. Raises if infeasible
    (deadline shorter than a single worst-case query)."""
    _validate(num_queries, deadline)
    if t_max < 0:
        raise ValueError("t_max must be >= 0")
    if t_max > deadline:
        raise InfeasibleDeadline(
            f"single-query worst case t_max={t_max:.6g}s exceeds deadline "
            f"T={deadline:.6g}s — no core count suffices")
    return num_queries * t_max / deadline


def lemma2_hoeffding_bound(
    num_queries: int,
    deadline: float,
    stats: RuntimeStats,
    p_f: float = 0.05,
    t_hat: float | None = None,
) -> float:
    """Hoeffding lower bound on C (Lemma 2).

    ``stats`` supplies the k sample times (t_bar_k) and, unless overridden,
    the upper bound ``t_hat`` (observed max). ``p_f`` is the failure
    probability of the deadline constraint (Eq. 6)."""
    _validate(num_queries, deadline)
    if not 0.0 < p_f < 1.0:
        raise ValueError(f"p_f must be in (0,1), got {p_f}")
    k = stats.n
    t_bar = stats.t_avg
    th = stats.t_hat() if t_hat is None else t_hat
    if th < t_bar:
        raise ValueError(f"t_hat={th} below sample mean {t_bar}")
    slack = math.sqrt(th * th * math.log(2.0 / p_f) / (2.0 * k))
    return (num_queries / deadline) * (t_bar + slack)


def required_cores(bound: float) -> int:
    """Integer core requirement from a real-valued lower bound."""
    if bound < 0:
        raise ValueError("bound must be >= 0")
    return max(1, math.ceil(bound))


def minimal_feasible_deadline(num_queries: int, t_max: float,
                              capacity: int) -> float:
    """Paper §III-A "prolong the duration": the smallest T' at which
    ``capacity`` cores pass the Lemma-1 admission — ``X * t_max / T' <=
    capacity`` with ``T' >= t_max`` so a single worst-case query fits.
    Shared by ``DeviceAllocator.readmit`` and the serving runtime's
    admission ladder so the extension arithmetic cannot drift."""
    if num_queries < 1:
        raise ValueError("num_queries must be >= 1")
    if t_max < 0:
        raise ValueError("t_max must be >= 0")
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    return max(t_max, num_queries * t_max / capacity)


@dataclass(frozen=True)
class BoundReport:
    """Both bounds side by side, as compared in the paper's Fig. 2."""

    lemma1: float
    lemma2: float
    lemma1_cores: int
    lemma2_cores: int

    @staticmethod
    def from_stats(num_queries: int, deadline: float, stats: RuntimeStats,
                   p_f: float = 0.05) -> "BoundReport":
        l1 = lemma1_lower_bound(num_queries, stats.t_max, deadline)
        l2 = lemma2_hoeffding_bound(num_queries, deadline, stats, p_f=p_f)
        return BoundReport(lemma1=l1, lemma2=l2,
                           lemma1_cores=required_cores(l1),
                           lemma2_cores=required_cores(l2))

    def reduction_vs_lemma2(self, achieved_cores: int) -> float:
        """Paper's headline metric: % fewer cores than the Lemma-2 baseline."""
        if self.lemma2_cores <= 0:
            return 0.0
        return 100.0 * (self.lemma2_cores - achieved_cores) / self.lemma2_cores


class InfeasibleDeadline(ValueError):
    """Deadline cannot be met at any core count (t_max > T), or the
    D&A_REAL admission check failed (C_max < ceil(C)) — Alg. 2 Line 5."""


def _validate(num_queries: int, deadline: float) -> None:
    if num_queries < 1:
        raise ValueError("num_queries must be >= 1")
    if deadline <= 0:
        raise ValueError("deadline must be > 0")
