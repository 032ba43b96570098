"""Deadline-tagged jobs for the online serving runtime (DESIGN.md §10).

A :class:`Job` is one D&A request — X queries due ``deadline`` seconds
after ``arrival`` — plus everything the runtime learns while serving it:
the rolling runtime statistics (sample + completed slots), the live core
grant, the resumable :class:`repro_torch.core.slots.SlotStepper`, and the
degradation / deadline-extension state. :class:`JobRecord` is the immutable
outcome row the report aggregates.

A copy of ``repro.serving.job`` (host only).
"""

from __future__ import annotations

import enum
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Any, Callable

from ..core.estimator import RuntimeStats
from ..core.slots import SlotStepper

# Executors may optionally expose degrade(factor) (DCAF-style graceful
# degradation) and run_chunk(qids) (single-device-step chunks); the runtime
# feature-detects both.
JobExecutor = Callable[[Sequence[int]], RuntimeStats]


class JobState(enum.Enum):
    PENDING = "pending"        # submitted, not yet arrived/admitted
    RUNNING = "running"        # admitted, slots in flight
    DONE = "done"              # all queries answered
    REJECTED = "rejected"      # admission failed beyond repair


@dataclass
class Job:
    """One in-flight request and its evolving serving state."""

    job_id: int
    num_queries: int
    deadline: float                  # relative SLA window (seconds)
    arrival: float                   # absolute virtual arrival time
    executor: JobExecutor
    seed: int = 0                    # drives the job's own sample draw
    sources: tuple[int, ...] | None = None   # explicit per-query sources
    #                                  (trace replays / cache keying; PPR
    #                                  jobs derive them from the workload)

    # -- runtime state (owned by ServingRuntime) ---------------------------
    state: JobState = JobState.PENDING
    stats: RuntimeStats | None = None      # rolling merged estimate
    stepper: SlotStepper | None = None
    t_pre: float = 0.0                     # preprocessing wall time
    slots_t0: float = 0.0                  # absolute time slot 0 started
    abs_deadline: float = 0.0              # arrival + deadline (+ extensions)
    completion: float | None = None        # absolute finish time
    est_scale: float = 1.0                 # planning-time degradation factor
    degraded: bool = False
    degrade_count: int = 0
    extended: bool = False
    replans: int = 0
    core_seconds: float = 0.0
    cache_hits: int = 0                    # queries answered at arrival
    late_hits: int = 0                     # pending queries answered mid-job
    effective_queries: int = 0             # misses admission actually sized
    mesh: Any = None                       # MeshPlan of the current grant
    reissue_rng: Any = None                # per-job straggler re-issue stream
    #                                        (seeded off job.seed; snapshotted
    #                                        so recovery replays identically)
    # -- engine mode (continuous lane batching, DESIGN.md §14) -------------
    engine_total: int = 0                  # queries routed through the engine
    engine_done: int = 0                   # completed or shed by late hits
    inflight: int = 0                      # queries on lanes right now
    draw_scale: float = 1.0                # executor scale when durations
    #                                        were drawn — insertion rescales
    #                                        by current/draw for degradation
    #                                        and slowdowns applied since
    engine_pending: list | None = None     # [[qid, duration], ...] awaiting
    #                                        the engine_ready event (t_pre)
    _accounted_to: float = 0.0             # core-seconds integration cursor
    log: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.num_queries < 1:
            raise ValueError("num_queries must be >= 1")
        if self.deadline <= 0:
            raise ValueError("deadline must be > 0")
        if self.sources is not None:
            self.sources = tuple(int(s) for s in self.sources)
            if len(self.sources) != self.num_queries:
                raise ValueError(
                    f"{len(self.sources)} sources for {self.num_queries} "
                    "queries")
        self.abs_deadline = self.arrival + self.deadline
        self.effective_queries = self.num_queries

    # -- accounting --------------------------------------------------------
    def account(self, now: float, grant: int) -> None:
        """Integrate ``grant`` held cores over [_accounted_to, now]."""
        if now > self._accounted_to:
            self.core_seconds += grant * (now - self._accounted_to)
        self._accounted_to = max(self._accounted_to, now)

    @property
    def original_deadline(self) -> float:
        """The SLA as asked: arrival + deadline. ``abs_deadline`` is the
        *operative* (possibly extended) deadline the planner works against;
        hits and lateness are always judged against the original, or an
        extension would launder a miss into a hit."""
        return self.arrival + self.deadline

    @property
    def lateness(self) -> float:
        """max(0, completion - original SLA deadline); 0 while unfinished."""
        if self.completion is None:
            return 0.0
        return max(0.0, self.completion - self.original_deadline)

    @property
    def remaining(self) -> int:
        if self.stepper is not None:
            return self.stepper.remaining
        if self.engine_total:
            return max(0, self.engine_total - self.engine_done)
        return 0

    def t_avg_estimate(self) -> float:
        """Planning-time per-query estimate: rolling mean, scaled by the
        degradation factor still unreflected in the observed times."""
        if self.stats is None:
            raise ValueError("no statistics yet")
        return self.stats.t_avg * self.est_scale


@dataclass(frozen=True)
class JobRecord:
    """Immutable outcome row for the serving report."""

    job_id: int
    num_queries: int
    arrival: float
    deadline: float                  # relative, as asked
    state: str
    completion: float | None
    lateness: float
    grant_peak: int
    core_seconds: float
    lemma2_core_seconds: float       # static per-job Lemma-2 provisioning
    degraded: bool
    extended: bool
    replans: int
    cache_hits: int = 0              # arrival-time cache answers
    late_hits: int = 0               # slot-boundary cache answers
    mesh_devices: int = 0            # devices x lanes the final grant mapped to
    mesh_lanes: int = 0

    @property
    def hit(self) -> bool:
        return self.state == JobState.DONE.value and self.lateness == 0.0

    @staticmethod
    def of(job: Job, grant_peak: int, lemma2_core_seconds: float,
           **_: Any) -> "JobRecord":
        return JobRecord(job_id=job.job_id, num_queries=job.num_queries,
                         arrival=job.arrival, deadline=job.deadline,
                         state=job.state.value, completion=job.completion,
                         lateness=job.lateness, grant_peak=grant_peak,
                         core_seconds=job.core_seconds,
                         lemma2_core_seconds=lemma2_core_seconds,
                         degraded=job.degraded, extended=job.extended,
                         replans=job.replans, cache_hits=job.cache_hits,
                         late_hits=job.late_hits,
                         mesh_devices=getattr(job.mesh, "devices", 0),
                         mesh_lanes=getattr(job.mesh, "lanes", 0))
