"""Runtime statistics and pluggable time sources (paper Lines 2-3 / Alg. 2
Line 2).

Everything the D&A arithmetic consumes is a statistic of per-query
processing times: ``t_max`` (Alg. 1), ``t_pre = sum t_i`` and ``t_avg``
(Alg. 2), and the Hoeffding pair ``(t_bar_k, t_hat)`` (Lemma 2).
``RuntimeStats`` holds them. Times come from a strategy object:

* ``MeasuredTimeSource``  — wall-clocks a real executor callable per query
  (on the card, the port's ``ForaExecutor`` is one such executor itself).
* ``SimulatedTimeSource`` — draws from a seeded heavy-tailed distribution
  (allocator tests, and the deadline-serving scenario).
* ``RooflineTimeSource``  — derives per-query time from a step's roofline
  terms, for admission where nothing can be measured.

A copy of ``repro.core.estimator``; its ``t_avg`` is clamped to ``t_max``
(see there).
"""

from __future__ import annotations

import math
import time
from collections.abc import Callable, Sequence
from dataclasses import dataclass, field

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


class TimeSource:
    """Strategy interface: produce per-query times for a set of query ids."""

    def measure(self, query_ids: Sequence[int]) -> RuntimeStats:
        raise NotImplementedError


@dataclass
class MeasuredTimeSource(TimeSource):
    """Times a real executor. ``run_query(qid) -> None`` does the work and
    returns when it is done (on the card: after a device synchronisation);
    we wall-clock it. ``warmup`` extra calls keep kernel builds and
    first-call allocations out of the sample, so the statistics reflect
    steady state (the paper's Xeon numbers are steady-state too)."""

    run_query: Callable[[int], None]
    warmup: int = 1

    def measure(self, query_ids: Sequence[int]) -> RuntimeStats:
        ids = list(query_ids)
        if not ids:
            raise ValueError("need at least one query id")
        for qid in ids[: self.warmup]:
            self.run_query(qid)
        out = np.empty(len(ids), dtype=np.float64)
        for i, qid in enumerate(ids):
            t0 = time.perf_counter()
            self.run_query(qid)
            out[i] = time.perf_counter() - t0
        return RuntimeStats(out)


@dataclass
class SimulatedTimeSource(TimeSource):
    """Draws times from ``base + Lognormal(mu, sigma)`` — heavy-tailed, like
    FORA's random-walk fluctuation (paper §IV-B attributes the variance to
    the random functions). Deterministic under a fixed seed."""

    mean: float = 1.0
    cv: float = 0.3          # coefficient of variation of the lognormal part
    base: float = 0.0        # deterministic floor (push phase)
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self) -> None:
        if self.mean <= 0 or self.cv < 0 or self.base < 0:
            raise ValueError("mean>0, cv>=0, base>=0 required")
        self._rng = np.random.default_rng(self.seed)

    def measure(self, query_ids: Sequence[int]) -> RuntimeStats:
        n = len(list(query_ids))
        if n == 0:
            raise ValueError("need at least one query id")
        if self.cv == 0.0:
            return RuntimeStats(np.full(n, self.base + self.mean))
        sigma2 = np.log1p(self.cv**2)
        mu = np.log(self.mean) - sigma2 / 2.0
        draw = self._rng.lognormal(mean=mu, sigma=np.sqrt(sigma2), size=n)
        return RuntimeStats(self.base + draw)

    def state_dict(self) -> dict:
        """Exact generator position (bit_generator state is a JSON-able dict
        of arbitrary-precision ints) — the WAL snapshot path needs the next
        draw after a restore to equal the next draw of the uncrashed run."""
        return {"rng": self._rng.bit_generator.state}

    def load_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng"]


@dataclass
class CacheAwareCostModel:
    """Expected-work discount for cache-aware D&A admission (DESIGN.md §11).

    The paper's estimator prices every query as fresh work. A serving
    system with a result cache and a walk index executes LESS than that:
    repeated sources are answered from the cache mid-flight, and index-
    covered walk lanes cost a gather instead of an L-step draw. This model
    turns those two effects into multiplicative discounts the admission
    arithmetic can consume *honestly*:

    * ``work_discount`` multiplies the query count — the expected fraction
      of still-pending queries that will MISS the cache, learned as an EWMA
      of observed lookup outcomes (arrival-time and slot-boundary lookups
      both feed it).
    * ``time_discount`` multiplies the per-query time statistics — the walk
      share of a query that the index serves for free. Callers whose
      *measured* sample already ran through the index must leave
      ``index_coverage`` at 0, or the speedup would be counted twice.

    Safety clamp (regression-pinned): with no observations the EWMA is
    absent and both discounts are exactly 1.0 — a cold cache degenerates to
    today's behaviour bit-for-bit. ``max_trust`` bounds how much of either
    estimate admission may shave even at a perfect observed hit rate, so a
    sudden traffic shift (hit rate collapsing) degrades into the runtime's
    replan/degrade ladder instead of into SLA misses.
    """

    decay: float = 0.7           # EWMA weight kept on the PAST estimate
    max_trust: float = 0.9       # cap on the shaved fraction of either term
    walk_share: float = 0.5      # fraction of a cold query's time in walks
    index_coverage: float = 0.0  # fraction of the walk budget index-served
    _ewma: float | None = field(default=None, init=False)

    def __post_init__(self) -> None:
        if not 0.0 <= self.decay < 1.0:
            raise ValueError("decay must be in [0,1)")
        if not 0.0 <= self.max_trust < 1.0:
            raise ValueError("max_trust must be in [0,1)")
        if not 0.0 <= self.walk_share <= 1.0:
            raise ValueError("walk_share must be in [0,1]")
        if not 0.0 <= self.index_coverage <= 1.0:
            raise ValueError("index_coverage must be in [0,1]")

    def observe(self, hits: int, lookups: int) -> None:
        """Fold a batch of cache-lookup outcomes into the hit-rate EWMA."""
        if lookups < 0 or hits < 0 or hits > lookups:
            raise ValueError("need 0 <= hits <= lookups")
        if lookups == 0:
            return
        rate = hits / lookups
        self._ewma = rate if self._ewma is None else (
            self.decay * self._ewma + (1.0 - self.decay) * rate)

    @property
    def hit_rate(self) -> float:
        """Learned hit-rate estimate; 0.0 until the first observation."""
        return 0.0 if self._ewma is None else self._ewma

    def work_discount(self) -> float:
        """Multiplier on pending-query counts: expected miss fraction,
        clamped so at least ``1 - max_trust`` of the work is always
        provisioned for. Cold -> exactly 1.0."""
        return 1.0 - min(self.hit_rate, self.max_trust)

    def time_discount(self) -> float:
        """Multiplier on t_avg / t_max: the walk share the index serves,
        clamped by ``max_trust``. No index -> exactly 1.0."""
        return 1.0 - min(self.walk_share * self.index_coverage,
                         self.max_trust)

    def discounted_queries(self, num_queries: int) -> int:
        """Expected cache misses among ``num_queries`` pending queries."""
        if num_queries <= 0:
            return num_queries
        return max(1, math.ceil(num_queries * self.work_discount()))

    def discounted_stats(self, stats: RuntimeStats) -> RuntimeStats:
        """The sample under the per-query time discount (identity cold)."""
        d = self.time_discount()
        return stats if d == 1.0 else stats.scaled(d)

    @classmethod
    def seeded_from_tuning(cls, cache, *, backend: str | None = None,
                           bucket: str | None = None,
                           **kwargs) -> "CacheAwareCostModel":
        """Seed ``walk_share`` from measured kernel device times instead of
        the 0.5 guess.

        ``cache`` is a ``kernels.autotune.TuningCache`` (or None). For every
        shape bucket (or just ``bucket``) that has BOTH a push entry
        (layout 'sliced' or 'dense') and a 'walk' entry on ``backend``
        (default: the process's, ``autotune.current_backend()``),
        walk_share = walk_us / (walk_us + push_us); buckets average. Steady-
        state ``device_us`` only — ``compile_us`` never prices a query. An
        empty/cold cache returns the default model unchanged, and an
        explicit ``walk_share`` kwarg always wins (caller knows best)."""
        if cache is None or "walk_share" in kwargs:
            return cls(**kwargs)
        if backend is None:
            from ..kernels import autotune

            backend = autotune.current_backend()
        pushes: dict[str, float] = {}
        walks: dict[str, float] = {}
        for key, cfg in cache.entries.items():
            be, layout, bkt = key.split("|", 2)
            if be != backend or (bucket is not None and bkt != bucket):
                continue
            if cfg.device_us <= 0.0:
                continue
            if layout in ("sliced", "dense"):
                # keep the faster push config if a bucket has both layouts
                pushes[bkt] = min(pushes.get(bkt, float("inf")),
                                  cfg.device_us)
            elif layout == "walk":
                walks[bkt] = cfg.device_us
        shares = [walks[b] / (walks[b] + pushes[b])
                  for b in pushes.keys() & walks.keys()]
        if shares:
            kwargs["walk_share"] = sum(shares) / len(shares)
        return cls(**kwargs)


@dataclass(frozen=True)
class RooflineTerms:
    """Three-term roofline of one executed step (seconds each)."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def step_time_s(self) -> float:
        """Bound-limited step estimate: the dominant term (perfect overlap of
        the other two is assumed; the no-overlap sum is the pessimistic dual
        and is reported alongside in the roofline benchmark)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)  # type: ignore[arg-type]


@dataclass
class RooflineTimeSource(TimeSource):
    """Per-query time from a step's roofline terms.

    ``terms`` describe one executed *block* of ``queries_per_block`` queries;
    per-query time is the block step time divided down. Used for dry-run
    admission control where no hardware exists to measure."""

    terms: RooflineTerms
    queries_per_block: int = 1
    jitter_cv: float = 0.0   # optional modelled fluctuation
    seed: int = 0

    def measure(self, query_ids: Sequence[int]) -> RuntimeStats:
        n = len(list(query_ids))
        if n == 0:
            raise ValueError("need at least one query id")
        per_q = self.terms.step_time_s / max(1, self.queries_per_block)
        if self.jitter_cv <= 0.0:
            return RuntimeStats(np.full(n, per_q))
        rng = np.random.default_rng(self.seed)
        sigma2 = np.log1p(self.jitter_cv**2)
        mu = np.log(per_q) - sigma2 / 2.0
        return RuntimeStats(rng.lognormal(mu, np.sqrt(sigma2), size=n))
