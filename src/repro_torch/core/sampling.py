"""Sample-size estimation (paper §II).

Implements Cochran's sample-size formula (Eq. 1 of the paper):

    s = Z^2 * p * (1 - p) / e^2

where ``Z`` is the standard score for the chosen confidence interval, ``p``
the (assumed) population proportion and ``e`` the acceptable sampling error.
The paper's worked example (Eq. 2): CI=99%, p=0.50, e=0.05 -> 663.58 -> 664.

Also provides the finite-population correction (Cochran 1977, §4.2) used when
the number of queries ``X`` is not huge relative to ``s`` — the paper assumes
``X`` is large, but the correction keeps the framework honest for small
workloads (and is exercised by the property tests).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# Two-sided z-scores for the confidence levels used in practice (paper §II
# names 90/95/99 as the common choices). Values are the standard normal
# quantiles z_{1-alpha/2}, quoted to the 3-decimal convention the paper uses
# (2.576 for 99%).
Z_TABLE: dict[float, float] = {
    0.80: 1.282,
    0.85: 1.440,
    0.90: 1.645,
    0.95: 1.960,
    0.98: 2.326,
    0.99: 2.576,
    0.995: 2.807,
    0.999: 3.291,
}


def z_score(confidence: float) -> float:
    """Two-sided z-score for a confidence level in (0, 1).

    Uses the conventional table for the standard levels; falls back to the
    Acklam/Beasley-Springer-Moro rational approximation of the normal
    quantile for non-tabled levels (no scipy in this environment).
    """
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0,1), got {confidence}")
    if confidence in Z_TABLE:
        return Z_TABLE[confidence]
    return _norm_ppf(0.5 + confidence / 2.0)


def _norm_ppf(q: float) -> float:
    """Inverse standard-normal CDF (Acklam's algorithm, |rel err| < 1.15e-9)."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0,1), got {q}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    p_low, p_high = 0.02425, 1 - 0.02425
    if q < p_low:
        u = math.sqrt(-2 * math.log(q))
        return (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / \
               ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    if q <= p_high:
        u = q - 0.5
        r = u * u
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * u / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    u = math.sqrt(-2 * math.log(1 - q))
    return -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / \
           ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)


@dataclass(frozen=True)
class SamplePlan:
    """Resolved sampling plan for the preprocessing stage."""

    size: int                 # s, after rounding up
    raw: float                # the un-rounded Eq.-1 value
    confidence: float
    proportion: float
    error: float
    population: int | None    # X if the finite-population correction applied

    def __post_init__(self) -> None:
        if self.size < 1:
            raise ValueError("sample size must be >= 1")


def cochran_sample_size(
    confidence: float = 0.99,
    proportion: float = 0.50,
    error: float = 0.05,
    population: int | None = None,
) -> SamplePlan:
    """Eq. 1 of the paper: ``s = Z^2 p (1-p) / e^2`` (+ optional FPC).

    ``population=None`` reproduces the paper exactly (X assumed large).
    With a population ``X``, Cochran's finite-population correction
    ``s' = s / (1 + (s - 1)/X)`` is applied and the result additionally
    clamped to ``X`` (cannot sample more queries than exist).
    """
    if not 0.0 < proportion < 1.0:
        raise ValueError(f"proportion must be in (0,1), got {proportion}")
    if not 0.0 < error < 1.0:
        raise ValueError(f"error must be in (0,1), got {error}")
    z = z_score(confidence)
    raw = (z * z) * proportion * (1.0 - proportion) / (error * error)
    if population is not None:
        if population < 1:
            raise ValueError("population must be >= 1")
        raw = raw / (1.0 + (raw - 1.0) / population)
        size = min(math.ceil(raw), population)
    else:
        size = math.ceil(raw)
    return SamplePlan(size=size, raw=raw, confidence=confidence,
                      proportion=proportion, error=error, population=population)


def fraction_sample_size(population: int, fraction: float = 0.05,
                         minimum: int = 1) -> int:
    """Paper §IV-A: for the large graphs (DBLP/Pokec/LiveJournal) the sample
    size is fixed at ``fraction`` (5%) of the smallest query count instead of
    Eq. 1, because per-query time is long. Returns max(minimum, ceil(f*X))."""
    if population < 1:
        raise ValueError("population must be >= 1")
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0,1], got {fraction}")
    return max(minimum, min(population, math.ceil(fraction * population)))
