"""The D&A framework (paper Algorithms 1 and 2).

``dna``       — Algorithm 1: unconstrained cores, preprocess s samples on s
                cores, slot the remainder, retry on deadline miss.
``dna_real``  — Algorithm 2: real-world variant with ``c << s`` preprocessing
                cores, the Lemma-1 admission check against ``C_max``, and the
                scaling factor ``d <= 1`` absorbing run-time fluctuation.

Both are generic over the query executor: PPR/FORA in the paper and in
``repro_torch.ppr.executor.ForaExecutor``. A copy of ``repro.core.dna``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bounds import (BoundReport, InfeasibleDeadline, lemma1_lower_bound,
                     required_cores)
from .estimator import RuntimeStats
from .sampling import SamplePlan, cochran_sample_size
from .slots import (Executor, SlotExecution, SlotPlan, build_slot_plan,
                    execute_plan, num_slots, queries_per_slot)


@dataclass(frozen=True)
class DnaResult:
    """Everything Algorithm 1/2 decided and observed, for reporting."""

    cores: int                      # k — the paper's answer
    accepted: bool                  # t_pre + T_max <= T held
    deadline: float
    num_queries: int
    sample: SamplePlan | None       # None when s was supplied directly
    sample_stats: RuntimeStats
    preprocess_time: float          # t_max (Alg. 1) or t_pre on c cores (Alg. 2)
    ell: int
    plan: SlotPlan
    execution: SlotExecution
    bounds: BoundReport
    scaling_factor: float = 1.0
    attempts: int = 1
    log: tuple[str, ...] = field(default_factory=tuple)

    @property
    def completion_time(self) -> float:
        return self.preprocess_time + self.execution.t_max_core

    @property
    def reduction_vs_lemma2_pct(self) -> float:
        return self.bounds.reduction_vs_lemma2(self.cores)


def _draw_sample(rng: np.random.Generator, num_queries: int,
                 s: int) -> tuple[list[int], list[int]]:
    """A uniform size-s sample WITHOUT replacement and its complement.

    Eq. 1's premise is a random sample of the query population — the first s
    ids would bias t_max/t_avg whenever query cost correlates with id order
    (e.g. sources sorted by degree). Both lists come back sorted for
    deterministic slot assignment.
    """
    sample = np.sort(rng.choice(num_queries, size=s, replace=False))
    rest = np.setdiff1d(np.arange(num_queries), sample, assume_unique=True)
    return sample.tolist(), rest.tolist()


def dna(
    num_queries: int,
    deadline: float,
    executor: Executor,
    *,
    confidence: float = 0.99,
    proportion: float = 0.50,
    error: float = 0.05,
    sample_size: int | None = None,
    p_f: float = 0.05,
    max_attempts: int = 3,
    seed: int | None = 0,
) -> DnaResult:
    """Algorithm 1: D&A(X, T).

    Line-by-line correspondence:
      L1  sample size s from Eq. 1 (or caller-fixed ``sample_size``)
      L2  preprocess a RANDOM sample of s queries in parallel on s cores
      L3  t_max over the sample
      L4  ell = floor((T - t_max) / t_max)
      L5  k = ceil((X - s)/ell), slot execution
      L6-7  per-core totals T_j, T_max
      L8-11 accept iff t_max + T_max <= T, else retry (fresh sample)

    ``seed`` drives the sample draws (deterministic per seed); every retry
    redraws a FRESH sample, so a one-off unlucky draw cannot pin t_max.
    """
    _check_args(num_queries, deadline)
    plan_info = None
    if sample_size is None:
        plan_info = cochran_sample_size(confidence, proportion, error,
                                        population=num_queries)
        s = plan_info.size
    else:
        s = sample_size
    s = min(s, num_queries)
    rng = np.random.default_rng(seed)
    log: list[str] = [f"s={s}"]

    last_exc: Exception | None = None
    for attempt in range(1, max_attempts + 1):
        # L2-3: preprocess a fresh random sample in parallel on s cores ->
        # wall time is t_max.
        sample_ids, rest_ids = _draw_sample(rng, num_queries, s)
        stats = executor(sample_ids)
        t_max = stats.t_max
        if t_max > deadline:
            last_exc = InfeasibleDeadline(
                f"t_max={t_max:.6g} > T={deadline:.6g} (attempt {attempt})")
            log.append(str(last_exc))
            continue
        remaining = num_queries - s
        if remaining <= 0:
            # §III-A: if s >= k no further action is needed; s cores suffice.
            plan = build_slot_plan([], 1, 1)
            execution = execute_plan(plan, executor) if plan.slots else \
                SlotExecution(plan=plan, core_totals=_zeros(1), per_query_times={})
            bounds = BoundReport.from_stats(num_queries, deadline, stats, p_f)
            return DnaResult(cores=s, accepted=True, deadline=deadline,
                             num_queries=num_queries, sample=plan_info,
                             sample_stats=stats, preprocess_time=t_max,
                             ell=0, plan=plan, execution=execution,
                             bounds=bounds, attempts=attempt, log=tuple(log))
        # L4: slots from the remaining duration, per-slot budget t_max.
        ell = num_slots(deadline - t_max, t_max)
        if ell < 1:
            last_exc = InfeasibleDeadline(
                f"no slots: T-t_max={deadline - t_max:.6g} < t_max={t_max:.6g}")
            log.append(str(last_exc))
            continue
        # L5: k queries per slot, executed slot-parallel.
        k = queries_per_slot(remaining, ell)
        plan = build_slot_plan(rest_ids, ell, k)
        execution = execute_plan(plan, executor)
        # L7-9: accept iff t_max + T_max <= T.
        t_total = t_max + execution.t_max_core
        log.append(f"attempt {attempt}: ell={ell} k={k} "
                   f"t_max={t_max:.6g} T_max={execution.t_max_core:.6g} "
                   f"total={t_total:.6g} T={deadline:.6g}")
        if t_total <= deadline:
            # the answer covers both stages: s cores preprocessed, k slotted
            cores = max(k, s)
            bounds = BoundReport.from_stats(num_queries, deadline, stats, p_f)
            return DnaResult(cores=cores, accepted=True,
                             deadline=deadline, num_queries=num_queries,
                             sample=plan_info, sample_stats=stats,
                             preprocess_time=t_max, ell=ell, plan=plan,
                             execution=execution, bounds=bounds,
                             attempts=attempt, log=tuple(log))
        last_exc = InfeasibleDeadline(f"missed deadline: {t_total:.6g} > {deadline:.6g}")
    raise last_exc if last_exc else InfeasibleDeadline("D&A failed")


def dna_real(
    num_queries: int,
    deadline: float,
    executor: Executor,
    max_cores: int,
    *,
    sample_size: int,
    preprocess_cores: int = 1,
    scaling_factor: float = 1.0,
    p_f: float = 0.05,
    sample_executor: Executor | None = None,
    seed: int | None = 0,
) -> DnaResult:
    """Algorithm 2: D&A_REAL(X, T, C_max).

    Line-by-line correspondence:
      L1   preprocess a RANDOM sample of s queries on c << s cores (c=1 in
           the paper's runs)
      L2   t_max, t_pre = sum t_i, t_avg
      L3   Lemma-1 lower bound C
      L4-5 admission: error if C_max < ceil(C)
      L7   ell = floor((d*T - t_pre) / t_avg)   with scaling factor d <= 1
      L8   k = ceil((X - s)/ell); slot execution with at most k cores
      L9-10 T_j totals, T_max
      L11-14 accept iff t_pre + T_max <= T, else error

    ``seed`` drives the sample draw (deterministic per seed).
    """
    _check_args(num_queries, deadline)
    if not 0.0 < scaling_factor <= 1.0:
        raise ValueError(f"scaling factor d must be in (0,1], got {scaling_factor}")
    if max_cores < 1:
        raise ValueError("max_cores must be >= 1")
    if sample_size < 1:
        raise ValueError("sample_size must be >= 1")
    s = min(sample_size, num_queries)
    rng = np.random.default_rng(seed)
    log: list[str] = [f"s={s} c={preprocess_cores} d={scaling_factor}"]

    # L1-2: sample on c cores; wall time is the c-core makespan of the times.
    src = sample_executor if sample_executor is not None else executor
    sample_ids, rest_ids = _draw_sample(rng, num_queries, s)
    stats = src(sample_ids)
    t_pre = stats.t_pre_on(preprocess_cores)
    t_avg, t_max = stats.t_avg, stats.t_max

    # L3-5: admission via Lemma 1.
    c_bound = lemma1_lower_bound(num_queries, t_max, deadline)
    if max_cores < required_cores(c_bound):
        raise InfeasibleDeadline(
            f"admission failed: need >= {required_cores(c_bound)} cores "
            f"(Lemma 1 bound {c_bound:.4g}), have C_max={max_cores}")
    remaining = num_queries - s
    bounds = BoundReport.from_stats(num_queries, deadline, stats, p_f)
    if remaining <= 0:
        plan = build_slot_plan([], 1, 1)
        execution = SlotExecution(plan=plan, core_totals=_zeros(1),
                                  per_query_times={})
        return DnaResult(cores=preprocess_cores, accepted=t_pre <= deadline,
                         deadline=deadline, num_queries=num_queries,
                         sample=None, sample_stats=stats,
                         preprocess_time=t_pre, ell=0, plan=plan,
                         execution=execution, bounds=bounds,
                         scaling_factor=scaling_factor, log=tuple(log))

    # L7: slots from the d-scaled remaining budget, per-slot estimate t_avg.
    budget = scaling_factor * deadline - t_pre
    if budget <= 0:
        raise InfeasibleDeadline(
            f"preprocessing consumed the scaled budget: t_pre={t_pre:.6g} "
            f">= d*T={scaling_factor * deadline:.6g}")
    ell = num_slots(budget, t_avg)
    if ell < 1:
        raise InfeasibleDeadline(
            f"no slots: d*T-t_pre={budget:.6g} < t_avg={t_avg:.6g}")
    # L8: k per slot; cap at C_max (the real-world constraint).
    k = queries_per_slot(remaining, ell)
    if k > max_cores:
        raise InfeasibleDeadline(
            f"k={k} exceeds available cores C_max={max_cores}")
    plan = build_slot_plan(rest_ids, ell, k)
    execution = execute_plan(plan, executor)
    t_total = t_pre + execution.t_max_core
    accepted = t_total <= deadline
    log.append(f"ell={ell} k={k} t_pre={t_pre:.6g} t_avg={t_avg:.6g} "
               f"T_max={execution.t_max_core:.6g} total={t_total:.6g} "
               f"T={deadline:.6g} accepted={accepted}")
    if not accepted:
        # Alg. 2 L14 raises; we attach the full result for diagnosis.
        err = InfeasibleDeadline(f"missed deadline: {t_total:.6g} > {deadline:.6g}")
        err.result = DnaResult(  # type: ignore[attr-defined]
            cores=k, accepted=False, deadline=deadline,
            num_queries=num_queries, sample=None, sample_stats=stats,
            preprocess_time=t_pre, ell=ell, plan=plan, execution=execution,
            bounds=bounds, scaling_factor=scaling_factor, log=tuple(log))
        raise err
    return DnaResult(cores=k, accepted=True, deadline=deadline,
                     num_queries=num_queries, sample=None, sample_stats=stats,
                     preprocess_time=t_pre, ell=ell, plan=plan,
                     execution=execution, bounds=bounds,
                     scaling_factor=scaling_factor, log=tuple(log))


def _check_args(num_queries: int, deadline: float) -> None:
    if num_queries < 1:
        raise ValueError("num_queries must be >= 1")
    if deadline <= 0:
        raise ValueError("deadline must be > 0")


def _zeros(n: int):
    return np.zeros(n, dtype=np.float64)
