"""Online D&A serving runtime (DESIGN.md §10).

The paper's pipeline is one-shot: sample, grant, execute a static slot
plan, report. This module turns it into a *continuous* runtime: a seeded
arrival process (Poisson or a replayed trace) delivers deadline-tagged
:class:`Job`s; each passes Lemma-1 admission against the shared
:class:`CorePool`, receives a D&A grant, and executes its slots
incrementally through a :class:`repro_torch.core.slots.SlotStepper`. Between
slots the runtime folds the completed slot's times into the job's rolling
estimate and re-runs the Algorithm-2 arithmetic against live statistics:

* **ahead**  -> shrink the grant, release cores back to the pool;
* **behind** -> grow the grant from the pool's free cores;
* **pool exhausted & miss predicted** -> DCAF-style graceful degradation
  (the executor's ``degrade`` hook raises epsilon / caps the walk budget
  for the *remaining* queries), preferring degraded answers over rejected
  jobs; deadline extension (paper §III-A) is the last resort.

Failures plug in through :class:`repro_torch.ft.elastic.ElasticController`: a
failure event shrinks the pool, overcommitted grants are shed largest-first
(:meth:`CorePool.shed_plan`) and every affected job is *readmitted* over its
remaining work (``DeviceAllocator.readmit``), extending its deadline when
capacity no longer suffices — jobs complete late rather than being lost.

Time is virtual: per-query durations come from the executor's
:class:`RuntimeStats` (measured wall time for the real FORA engine,
seeded draws for simulation) and drive an event heap, so the same loop
serves a live daemon and a deterministic, replayable simulation.

The one-shot path is the degenerate case — a single job, no arrivals,
``replan=False`` reproduces ``dna_real``'s cores/completion numbers
bit-for-bit (regression-tested), so paper-faithful results are unchanged.

A copy of ``repro.serving.runtime`` over the port's modules. It is host
code: the executors do the device work, and a ``WalkIndex``'s arrays go to
a snapshot through the host and come back as int32 tensors on the device
they were taken from.
"""

from __future__ import annotations

import heapq
from collections import deque
from collections.abc import Sequence
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..core.allocator import MeshPlan, StragglerMonitor
from ..core.bounds import (BoundReport, InfeasibleDeadline,
                           lemma1_lower_bound, minimal_feasible_deadline,
                           required_cores)
from ..core.dna import _draw_sample
from ..core.estimator import (CacheAwareCostModel, RuntimeStats,
                              SimulatedTimeSource)
from ..core.sampling import fraction_sample_size
from ..core.slots import SlotStepper, num_slots, queries_per_slot
from ..ft.elastic import ElasticController, FailureInjector, HeartbeatMonitor
from ..index import ResultCache
from ..index.result_cache import CacheEntry, CacheStats
from .job import Job, JobRecord, JobState
from .lanes import SimLaneEngine
from .pool import CorePool, LaneLedger
from .wal import RecoveryInfo, WriteAheadLog, pack_state, unpack_state


@dataclass(frozen=True)
class ServingConfig:
    """Knobs of the serving loop (defaults mirror Algorithm 2)."""

    scaling_factor: float = 0.9        # d <= 1, absorbs run-time fluctuation
    sample_frac: float = 0.05          # preprocessing fraction (paper §IV-A)
    sample_size: int | None = None     # fixed s overriding the fraction
    preprocess_cores: int = 1          # c << s (Alg. 2 Line 1)
    replan: bool = True                # re-run Alg. 2 arithmetic between slots
    degrade: bool = True               # DCAF-style graceful degradation
    degrade_factor: float = 0.5        # per-step time scale when degrading
    max_degrades: int = 2              # degradation depth cap per job
    extend: bool = True                # §III-A deadline extension fallback
    p_f: float = 0.05                  # Lemma-2 failure prob (reporting only)
    graph_version: int = 0             # structure snapshot for cache keys —
    #                                    bumping it cold-starts the cache
    #                                    (DESIGN.md §11 staleness rule)
    cache_recheck: bool = True         # re-probe pending queries at slot
    #                                    boundaries (late hits shed work)
    index_coverage: float = 0.0        # operator-declared walk-index share
    #                                    for MODELLED admission times; leave 0
    #                                    when the measured sample already ran
    #                                    index-backed (no double counting)
    stragglers: bool = False           # slot-boundary speculative re-issue of
    #                                    straggling lanes on pool spares
    #                                    (DESIGN.md §12; needs spares_fraction
    #                                    > 0 on the pool to ever fire)
    engine: bool = False               # continuous-batching lane engine
    #                                    (DESIGN.md §14): per-lane occupancy
    #                                    accounting replaces slot grants,
    #                                    admission reserves lane-seconds,
    #                                    free lanes take the EDF-earliest
    #                                    admitted query from ANY job
    lane_pool: int = 0                 # engine lane count (0 = pool.total)
    cold_compile_s: float = 0.0        # daemon cold-start compile surcharge
    #                                    billed into the FIRST admitted job's
    #                                    preprocess reservation (DESIGN.md §15
    #                                    — the Alg.-2 c-core term the
    #                                    persistent compilation cache shrinks)
    warm_start: bool = False           # compilation cache already populated:
    #                                    the cold_compile_s surcharge is
    #                                    waived (second daemon start)

    def __post_init__(self) -> None:
        if not 0.0 < self.scaling_factor <= 1.0:
            raise ValueError("scaling factor d must be in (0,1]")
        if not 0.0 < self.degrade_factor < 1.0:
            raise ValueError("degrade_factor must be in (0,1)")
        if self.preprocess_cores < 1:
            raise ValueError("preprocess_cores must be >= 1")
        if self.lane_pool < 0:
            raise ValueError("lane_pool must be >= 0")
        if self.cold_compile_s < 0.0:
            raise ValueError("cold_compile_s must be >= 0")


@dataclass(frozen=True)
class ServingReport:
    """Aggregate outcome of a runtime drive (deterministic under a seed)."""

    records: tuple[JobRecord, ...]
    end_time: float

    @property
    def completed(self) -> int:
        return sum(r.state == JobState.DONE.value for r in self.records)

    @property
    def rejected(self) -> int:
        return sum(r.state == JobState.REJECTED.value for r in self.records)

    @property
    def degraded(self) -> int:
        return sum(r.degraded for r in self.records)

    @property
    def extended(self) -> int:
        return sum(r.extended for r in self.records)

    @property
    def hit_rate(self) -> float:
        """Fraction of ALL submitted jobs answered by their original
        deadline (rejections and extensions that finish late count as
        misses)."""
        if not self.records:
            return 1.0
        return sum(r.hit for r in self.records) / len(self.records)

    def lateness_quantile(self, q: float) -> float:
        """Lateness quantile over COMPLETED jobs only — a rejected or
        unfinished job has no lateness to report, and folding it in as 0.0
        would let the best-looking entries of the distribution be the worst
        outcomes (rejections are surfaced separately, like hit_rate)."""
        late = [r.lateness for r in self.records
                if r.state == JobState.DONE.value]
        return float(np.quantile(late, q)) if late else 0.0

    @property
    def cache_hits(self) -> int:
        """Queries answered from the result cache (arrival + late hits)."""
        return sum(r.cache_hits + r.late_hits for r in self.records)

    @property
    def core_seconds(self) -> float:
        return sum(r.core_seconds for r in self.records)

    @property
    def lemma2_core_seconds(self) -> float:
        """Static per-job Lemma-2 provisioning: every job books its
        Hoeffding core count for its whole SLA window."""
        return sum(r.lemma2_core_seconds for r in self.records)

    def summary(self) -> str:
        n = len(self.records)
        ratio = (self.core_seconds / self.lemma2_core_seconds
                 if self.lemma2_core_seconds else float("nan"))
        cache = (f" cache_hits={self.cache_hits}" if self.cache_hits else "")
        return (f"jobs={n} done={self.completed} rejected={self.rejected} "
                f"hit_rate={self.hit_rate:.3f} "
                f"lateness_p50={self.lateness_quantile(0.5):.3f}s "
                f"p99={self.lateness_quantile(0.99):.3f}s "
                f"degraded={self.degraded} extended={self.extended} "
                f"core_s={self.core_seconds:.1f} "
                f"lemma2_core_s={self.lemma2_core_seconds:.1f} "
                f"ratio={ratio:.3f}" + cache)


class SimJobExecutor:
    """Seeded simulated executor with a DCAF degradation hook: ``degrade``
    scales every subsequent per-query time (a coarser answer is a cheaper
    answer). One instance per job -> interleaving jobs cannot perturb each
    other's RNG streams, keeping replays deterministic."""

    def __init__(self, mean: float = 0.05, cv: float = 0.3, seed: int = 0):
        self._src = SimulatedTimeSource(mean=mean, cv=cv, seed=seed)
        self.scale = 1.0

    def __call__(self, ids: Sequence[int]) -> RuntimeStats:
        return self._src.measure(ids).scaled(self.scale)

    def degrade(self, factor: float) -> None:
        if not 0.0 < factor < 1.0:
            raise ValueError("factor must be in (0,1)")
        self.scale *= factor

    def state_dict(self) -> dict:
        """Exact mid-job position (RNG + degradation scale) for WAL
        snapshots — the next simulated draw after a restore must equal the
        uncrashed run's next draw."""
        return {"src": self._src.state_dict(), "scale": self.scale}

    def load_state(self, state: dict) -> None:
        self._src.load_state(state["src"])
        self.scale = float(state["scale"])


# executor_factory(job_id, num_queries, seed) -> executor for that job
ExecutorFactory = Callable[[int, int, int], Any]


class ServingRuntime:
    """Event-driven serving loop over a shared :class:`CorePool`.

    ``cache`` attaches a :class:`repro_torch.index.ResultCache` (DESIGN.md §11):
    arrivals are probed BEFORE Lemma-1 admission — known answers bypass the
    pool entirely (a fully-cached job completes even against an exhausted
    pool), misses proceed through sampling/admission sized on the remaining
    work. Completed slots insert their queries; at every slot boundary the
    still-pending queries are re-probed so answers produced by concurrent
    jobs shed work mid-flight (late hits -> replan releases cores).
    ``cost_model`` (default: a fresh cold :class:`CacheAwareCostModel`)
    learns the observed hit rate and discounts the admission arithmetic —
    cold it is exactly neutral, so a runtime without a cache (or with an
    empty one and no repeats) reproduces the cache-free decisions bit-for-bit
    (regression-pinned).
    """

    def __init__(self, pool: CorePool, executor_factory: ExecutorFactory,
                 config: ServingConfig = ServingConfig(),
                 controller: ElasticController | None = None,
                 cache: ResultCache | None = None,
                 cost_model: CacheAwareCostModel | None = None):
        self.pool = pool
        self.factory = executor_factory
        self.cfg = config
        self.controller = controller or ElasticController(
            allocator=pool.allocator)
        self.cache = cache
        self.model = cost_model or CacheAwareCostModel(
            index_coverage=config.index_coverage)
        self.clock = 0.0
        # live structure version (DESIGN.md §16): seeded from the config but
        # MUTABLE — each applied mutation batch bumps it, so cache keys made
        # after an update stop matching pre-update answers without any sweep
        self.graph_version = config.graph_version
        # mutation stream state (schedule_mutations): per-ordinal batch
        # descriptors plus the refresh-vs-rebuild core-second ledgers the
        # churn bench gates on
        self._mutation_batches: list[dict] = []
        self._mutation_cfg: dict | None = None
        self._on_mutate: Callable[[int, float], Any] | None = None
        self.mutations_applied = 0
        self.pending_refresh = 0
        self.refresh_core_s = 0.0
        self.rebuild_core_s = 0.0
        self.jobs: list[Job] = []
        self._heap: list[tuple[float, int, str, Any]] = []
        self._seq = 0
        # engine mode (DESIGN.md §14): the virtual lane pool + the
        # lane-second admission ledger replace slot grants entirely
        self.engine: SimLaneEngine | None = None
        self.ledger: LaneLedger | None = None
        if config.engine:
            self.engine = SimLaneEngine(config.lane_pool or pool.total)
            self.ledger = LaneLedger()
        self._grant_peak: dict[int, int] = {}
        self._lemma2_cs: dict[int, float] = {}
        self._waiting: list[Job] = []
        # -- durability (DESIGN.md §12) --
        self.wal: WriteAheadLog | None = None
        self._snapshot_every = 0
        self._compact_keep = 0
        self.events_processed = 0          # total heap events handled
        self._replay_expect: deque[dict] = deque()   # logged events to verify
        self._in_replay = False            # current event is a replayed one
        self._mute_wal = False             # recovery rebuild: don't re-log
        self.replay_pre_core_s = 0.0       # preprocess core-s re-billed by
        #                                    the last recovery's replay
        self.pre_core_s = 0.0              # total preprocess core-seconds
        #                                    billed (DESIGN.md §15 — the
        #                                    warm-cold-start metric)
        self._compile_billed = False       # cold_compile_s surcharge applied

    # -- durability (DESIGN.md §12) ----------------------------------------
    def attach_wal(self, wal: WriteAheadLog, snapshot_every: int = 0,
                   compact_keep: int = 0, _log_init: bool = True) -> None:
        """Start logging this runtime's inputs and events to ``wal``;
        snapshot full state every ``snapshot_every`` processed events
        (0 = never — recovery then replays from event 0). Must be attached
        before any submission so the init record captures a clean slate.

        ``compact_keep > 0`` bounds the log: after each snapshot the WAL
        keeps the newest ``compact_keep`` restorable snapshots and truncates
        the event prefix the oldest of them covers
        (:meth:`WriteAheadLog.compact`). Recovery then starts from a
        retained snapshot — replay-from-zero is gone, and ``recover``
        refuses a log whose retained snapshots are all lost rather than
        silently serving a partial history."""
        if _log_init and (self.jobs or self._heap):
            raise ValueError("attach_wal before submitting work — the WAL "
                             "must capture the runtime's inputs from zero")
        self.wal = wal
        self._snapshot_every = snapshot_every
        self._compact_keep = int(compact_keep)
        if _log_init:
            alloc = self.pool.allocator
            cache = None
            if self.cache is not None:
                cache = {"capacity": self.cache.capacity,
                         "ttl": self.cache.ttl,
                         "ttl_update_factor": self.cache.ttl_update_factor}
            wal.append({
                "type": "init",
                "config": asdict(self.cfg),
                "pool": {"num_devices": len(alloc.devices),
                         "lanes_per_device": self.pool.lanes_per_device,
                         "spares_fraction": alloc.spares_fraction},
                "cache": cache,
                "model": {"decay": self.model.decay,
                          "max_trust": self.model.max_trust,
                          "walk_share": self.model.walk_share,
                          "index_coverage": self.model.index_coverage},
                "snapshot_every": snapshot_every,
                "compact_keep": int(compact_keep),
            })

    def _wal_note(self, what: str, **fields: Any) -> None:
        """Informational record (admission outcome, grant change, shed...).
        Suppressed during replay — the original run already logged it."""
        if self.wal is None or self._in_replay or self._mute_wal:
            return
        self.wal.append({"type": "note", "t": self.clock, "what": what,
                         **fields})

    # -- submission --------------------------------------------------------
    def submit(self, num_queries: int, deadline: float, at: float = 0.0,
               seed: int | None = None,
               sources: Sequence[int] | None = None) -> Job:
        job_id = len(self.jobs)
        seed = job_id if seed is None else seed
        job = Job(job_id=job_id, num_queries=num_queries, deadline=deadline,
                  arrival=at, seed=seed,
                  sources=None if sources is None else tuple(sources),
                  executor=self.factory(job_id, num_queries, seed))
        if self.wal is not None and not self._mute_wal:
            rec = {"type": "submit", "queries": num_queries,
                   "deadline": deadline, "at": at, "seed": seed}
            if sources is not None:
                rec["sources"] = [int(s) for s in sources]
            self.wal.append(rec)
        self.jobs.append(job)
        self._push(at, "arrive", job)
        return job

    def submit_poisson(self, num_jobs: int, rate: float, *,
                       queries: int | tuple[int, int],
                       deadline: float | tuple[float, float],
                       seed: int = 0) -> list[Job]:
        """Seeded Poisson arrival process: exponential gaps at ``rate``
        jobs/second; per-job size/deadline drawn uniformly when given as
        (lo, hi) ranges. Deterministic per seed."""
        if num_jobs < 1 or rate <= 0:
            raise ValueError("num_jobs >= 1 and rate > 0 required")
        rng = np.random.default_rng(seed)
        t = 0.0
        out = []
        for i in range(num_jobs):
            t += float(rng.exponential(1.0 / rate))
            if isinstance(queries, tuple):
                x = int(rng.integers(queries[0], queries[1] + 1))
            else:
                x = queries
            if isinstance(deadline, tuple):
                T = float(rng.uniform(deadline[0], deadline[1]))
            else:
                T = deadline
            out.append(self.submit(x, T, at=t,
                                   seed=int(rng.integers(0, 1 << 31))))
        return out

    def submit_trace(self, trace: Sequence[dict]) -> list[Job]:
        """Replay a recorded trace: [{"at":, "queries":, "deadline":,
        "seed"?:, "sources"?:}, ...] — the format :meth:`trace_records`
        captures, so a recorded serve replays through the same admission
        decisions."""
        return [self.submit(int(row["queries"]), float(row["deadline"]),
                            at=float(row["at"]), seed=row.get("seed"),
                            sources=row.get("sources"))
                for row in trace]

    def trace_records(self, *, completed_only: bool = True) -> list[dict]:
        """Completed-job arrival/deadline/source records in the exact shape
        :meth:`submit_trace` consumes (ROADMAP follow-up: replay traces
        captured from real serve logs). Call after :meth:`run`."""
        jobs = [j for j in self.jobs
                if j.state is JobState.DONE or not completed_only]
        rows: list[dict] = []
        for j in sorted(jobs, key=lambda j: (j.arrival, j.job_id)):
            row = {"at": j.arrival, "queries": j.num_queries,
                   "deadline": j.deadline, "seed": j.seed}
            if j.sources is not None:
                row["sources"] = list(j.sources)
            rows.append(row)
        return rows

    def inject_failures(self, schedule: dict[float, list[int]]) -> None:
        """Schedule device failures at virtual times. Routed through the
        ElasticController: tick ``i`` of its injector fires at the i-th
        scheduled time, marks the devices failed (shrinking the pool) and
        records the readmission event."""
        times = sorted(schedule)
        if self.wal is not None and not self._mute_wal:
            self.wal.append({"type": "inject",
                             "schedule": [[t, [int(d) for d in schedule[t]]]
                                          for t in times]})
        self.controller.injector = FailureInjector(
            schedule={i: list(schedule[t]) for i, t in enumerate(times)})
        for i, t in enumerate(times):
            self._push(t, "fail", i)

    def schedule_slowdowns(self, schedule: dict[float, float]) -> None:
        """Schedule multiplicative executor slowdowns at virtual times
        (chaos harness: a degraded NIC / thermal-throttled device inflates
        every subsequent per-query time). A fired event slows all jobs
        RUNNING at that instant; the straggler hook then sees their lanes
        cross the re-issue threshold."""
        for t, f in schedule.items():
            if f <= 0:
                raise ValueError(f"slowdown factor must be > 0 (got {f})")
        times = sorted(schedule)
        if self.wal is not None and not self._mute_wal:
            self.wal.append({"type": "slowdown",
                             "schedule": [[t, float(schedule[t])]
                                          for t in times]})
        for t in times:
            self._push(t, "slow", float(schedule[t]))

    def schedule_mutations(self, num: int, rate: float, *, seed: int = 0,
                           graph_n: int = 0, affected_frac: float = 0.05,
                           refresh_budget: int = 0, node_cost: float = 0.0,
                           on_mutate: Callable[[int, float], Any] | None
                           = None) -> list[dict]:
        """Schedule a seeded stream of graph-update arrivals (DESIGN.md §16):
        ``num`` mutation batches with exponential inter-arrival gaps at
        ``rate`` batches/second. Each fired batch bumps ``graph_version``
        (cache keys roll over), notes the update cadence to the cache's TTL
        tuner, and books the incremental-invalidation accounting: a batch
        touches ``~affected_frac * graph_n`` sources, of which up to
        ``refresh_budget`` are refreshed immediately (the rest join the
        ``pending_refresh`` backlog); ``node_cost`` core-seconds per
        refreshed node accrue to ``refresh_core_s`` while the counterfactual
        full rebuild (every node) accrues to ``rebuild_core_s`` — the
        refresh-vs-rebuild ratio the churn bench gates.

        ``on_mutate(ordinal, t)`` is the daemon's hook to apply a REAL
        :class:`repro_torch.dyn.DynamicGraph` batch (returning its ``ApplyInfo``
        overrides the simulated affected count). The hook is NOT recovered
        from the WAL — recovery replays the simulated accounting only, and
        a daemon re-attaches its own hook after :meth:`recover` — so it
        must not influence event ordering.

        The full spec is one WAL ``mutations`` input record; batch times
        and affected counts are drawn HERE (seeded), so recovery's
        re-dispatch reproduces the identical event stream.
        """
        if num < 0 or (num > 0 and rate <= 0):
            raise ValueError("num >= 0 and rate > 0 required")
        if self._mutation_cfg is not None:
            raise ValueError("mutation stream already scheduled")
        if self.wal is not None and not self._mute_wal:
            self.wal.append({"type": "mutations", "num": int(num),
                             "rate": float(rate), "seed": int(seed),
                             "graph_n": int(graph_n),
                             "affected_frac": float(affected_frac),
                             "refresh_budget": int(refresh_budget),
                             "node_cost": float(node_cost)})
        self._mutation_cfg = {"graph_n": int(graph_n),
                              "refresh_budget": int(refresh_budget),
                              "node_cost": float(node_cost)}
        self._on_mutate = on_mutate
        rng = np.random.default_rng(seed)
        t = 0.0
        mean_affected = max(1.0, affected_frac * graph_n)
        for ordinal in range(num):
            t += float(rng.exponential(1.0 / rate))
            affected = int(1 + rng.poisson(mean_affected - 1.0))
            self._mutation_batches.append({"at": t, "affected": affected})
            self._push(t, "mutate", ordinal)
        return list(self._mutation_batches)

    # -- event loop --------------------------------------------------------
    def _push(self, t: float, kind: str, payload: Any) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, payload))
        self._seq += 1

    def run(self, max_events: int | None = None) -> ServingReport | None:
        """Drain the event heap; returns the aggregate report. With
        ``max_events`` set, stop (returning None) after that many events —
        the chaos harness's crash point: the process "dies" there and a
        recovery must carry on from the WAL."""
        processed = 0
        while self._heap:
            if max_events is not None and processed >= max_events:
                return None
            t, _, kind, payload = heapq.heappop(self._heap)
            self.clock = max(self.clock, t)
            self.events_processed += 1
            processed += 1
            self._wal_event(t, kind, payload)
            if kind == "arrive":
                self._handle_arrival(payload, self.clock)
            elif kind == "slot":
                self._handle_slot(payload, t)
            elif kind == "pre_release":
                # a preprocessing reservation ends (Alg. 2's c cores return
                # to the pool); a waiter may now fit — and in engine mode
                # the lane cap just rose, so free lanes refill too
                if self.pool.unreserve(payload.job_id):
                    self._pop_waiter(self.clock)
                    self._engine_fill(self.clock)
            elif kind == "publish":
                # preprocessing-sample answers become visible only once the
                # sample has actually finished computing (t_pre elapsed) —
                # publishing at arrival-handling time would let concurrent
                # jobs hit answers that do not exist yet in virtual time
                job, qids, stats = payload
                self._record_answers(job, qids, stats, self.clock)
            elif kind == "engine_ready":
                # a job's preprocessing finished: its queries join the
                # engine's EDF ready queue and grab any free lanes
                self._handle_engine_ready(payload, self.clock)
            elif kind == "engine":
                self._handle_engine_done(payload, self.clock)
            elif kind == "fail":
                self._handle_failure(payload, self.clock)
            elif kind == "slow":
                self._handle_slowdown(payload, self.clock)
            elif kind == "mutate":
                self._handle_mutation(payload, t)
            if self.controller.heartbeat is not None:
                self._poll_heartbeat(self.clock)
            self._maybe_snapshot()
        records = tuple(
            JobRecord.of(j, self._grant_peak.get(j.job_id, 0),
                         self._lemma2_cs.get(j.job_id, 0.0))
            for j in self.jobs)
        return ServingReport(records=records, end_time=self.clock)

    # -- WAL event stream ---------------------------------------------------
    @staticmethod
    def _event_tag(kind: str, payload: Any) -> Any:
        """Identity of an event independent of object graph (job ids,
        failure ordinals, slowdown factors) — what replay verification
        compares against the log."""
        if kind in ("arrive", "slot", "pre_release", "engine_ready"):
            return payload.job_id
        if kind == "publish":
            return payload[0].job_id
        if kind == "engine":
            # a list, not a tuple: the logged tag round-trips through JSON
            # and replay compares the deserialised value
            return [int(x) for x in payload]
        if kind in ("fail", "mutate"):
            return int(payload)
        if kind == "slow":
            return float(payload)
        return None

    def _wal_event(self, t: float, kind: str, payload: Any) -> None:
        """Write-ahead (or, during recovery, verify) one heap event. Replay
        is re-execution: every replayed event must match the logged one
        exactly, or the rebuilt runtime is NOT the run that crashed."""
        if self.wal is None:
            return
        tag = self._event_tag(kind, payload)
        if self._replay_expect:
            exp = self._replay_expect.popleft()
            if (exp["kind"], exp["tag"], exp["t"]) != (kind, tag, t):
                raise RuntimeError(
                    f"WAL replay diverged at event {self.events_processed}: "
                    f"logged ({exp['kind']!r}, {exp['tag']!r}, {exp['t']!r})"
                    f" but replayed ({kind!r}, {tag!r}, {t!r})")
            self._in_replay = True
        else:
            self._in_replay = False
            self.wal.append({"type": "event", "n": self.events_processed,
                             "t": t, "kind": kind, "tag": tag})
        self.controller.metrics_muted = self._in_replay

    def _maybe_snapshot(self) -> None:
        if (self.wal is None or self._snapshot_every <= 0 or self._in_replay
                or self.events_processed % self._snapshot_every != 0):
            return
        self.snapshot()

    def snapshot(self) -> None:
        """Write a full-state checkpoint (atomic tmp-rename through
        ``checkpoint.store``) and log it as the new compaction point. With
        ``compact_keep`` set, also truncate the WAL prefix this (and the
        other retained) snapshots cover and GC superseded snapshot dirs."""
        if self.wal is None:
            raise ValueError("no WAL attached")
        from ..checkpoint import store as ckpt_store
        leaves = pack_state(self._state_dict())
        # the store's own age-out must never outpace the WAL's retention
        ckpt_store.save(self.wal.snapshot_dir, self.events_processed, leaves,
                        keep=max(3, self._compact_keep))
        self.wal.append({"type": "snapshot", "step": self.events_processed})
        if self._compact_keep > 0:
            self.wal.compact(keep=self._compact_keep)

    # -- state packing ------------------------------------------------------
    def _pack_payload(self, kind: str, payload: Any) -> Any:
        if kind in ("arrive", "slot", "pre_release", "engine_ready"):
            return {"job": payload.job_id}
        if kind == "publish":
            job, qids, stats = payload
            return {"job": job.job_id, "qids": [int(q) for q in qids],
                    "times": np.asarray(stats.times)}
        if kind == "engine":
            return [int(x) for x in payload]     # (lane, qid, job_id)
        return payload                       # fail ordinal / slow factor

    def _unpack_payload(self, kind: str, packed: Any) -> Any:
        if kind in ("arrive", "slot", "pre_release", "engine_ready"):
            return self.jobs[int(packed["job"])]
        if kind == "publish":
            return (self.jobs[int(packed["job"])],
                    [int(q) for q in packed["qids"]],
                    RuntimeStats(np.asarray(packed["times"])))
        if kind == "engine":
            return (int(packed[0]), int(packed[1]), int(packed[2]))
        return packed

    def _pack_job(self, job: Job) -> dict:
        d: dict[str, Any] = {
            "job_id": job.job_id, "state": job.state.value,
            "t_pre": job.t_pre, "slots_t0": job.slots_t0,
            "abs_deadline": job.abs_deadline, "completion": job.completion,
            "est_scale": job.est_scale, "degraded": job.degraded,
            "degrade_count": job.degrade_count, "extended": job.extended,
            "replans": job.replans, "core_seconds": job.core_seconds,
            "cache_hits": job.cache_hits, "late_hits": job.late_hits,
            "effective_queries": job.effective_queries,
            "engine_total": job.engine_total, "engine_done": job.engine_done,
            "inflight": job.inflight, "draw_scale": job.draw_scale,
            "engine_pending": job.engine_pending,
            "accounted_to": job._accounted_to, "log": list(job.log),
            "mesh": (None if job.mesh is None else
                     [job.mesh.cores, job.mesh.devices, job.mesh.lanes]),
            "stats": None if job.stats is None else np.asarray(job.stats.times),
            "stepper": (None if job.stepper is None
                        else job.stepper.state_dict()),
            "executor": (job.executor.state_dict()
                         if hasattr(job.executor, "state_dict") else None),
            "reissue_rng": (None if job.reissue_rng is None
                            else job.reissue_rng.bit_generator.state),
        }
        wi = getattr(job.executor, "walk_index", None)
        if wi is not None:
            d["walk_index"] = {"endpoints": wi.endpoints.cpu().numpy(),
                               "budget": wi.budget.cpu().numpy(),
                               "refreshed": int(wi.refreshed)}
        return d

    def _load_job(self, d: dict) -> None:
        job = self.jobs[int(d["job_id"])]
        job.state = JobState(d["state"])
        job.t_pre = float(d["t_pre"])
        job.slots_t0 = float(d["slots_t0"])
        job.abs_deadline = float(d["abs_deadline"])
        job.completion = (None if d["completion"] is None
                          else float(d["completion"]))
        job.est_scale = float(d["est_scale"])
        job.degraded = bool(d["degraded"])
        job.degrade_count = int(d["degrade_count"])
        job.extended = bool(d["extended"])
        job.replans = int(d["replans"])
        job.core_seconds = float(d["core_seconds"])
        job.cache_hits = int(d["cache_hits"])
        job.late_hits = int(d["late_hits"])
        job.effective_queries = int(d["effective_queries"])
        job.engine_total = int(d.get("engine_total", 0))
        job.engine_done = int(d.get("engine_done", 0))
        job.inflight = int(d.get("inflight", 0))
        job.draw_scale = float(d.get("draw_scale", 1.0))
        pend = d.get("engine_pending")
        job.engine_pending = (None if pend is None else
                              [[int(q), float(t)] for q, t in pend])
        job._accounted_to = float(d["accounted_to"])
        job.log = [str(line) for line in d["log"]]
        job.mesh = (None if d["mesh"] is None else
                    MeshPlan(cores=int(d["mesh"][0]),
                             devices=int(d["mesh"][1]),
                             lanes=int(d["mesh"][2])))
        job.stats = (None if d["stats"] is None
                     else RuntimeStats(np.asarray(d["stats"])))
        if d["executor"] is not None and hasattr(job.executor, "load_state"):
            job.executor.load_state(d["executor"])
        if d["stepper"] is not None:
            slot_exec = getattr(job.executor, "run_chunk", job.executor)
            job.stepper = SlotStepper.from_state(d["stepper"], slot_exec)
        if d["reissue_rng"] is not None:
            # dnalint: disable=prng-discipline,replay-determinism -- shell
            # generator only: its entropy-seeded state is overwritten from
            # the snapshot on the next line before any draw
            job.reissue_rng = np.random.default_rng()
            job.reissue_rng.bit_generator.state = d["reissue_rng"]
        if self.cfg.stragglers and job.stepper is not None:
            job.stepper.straggler = (
                lambda times, j=job: self._mitigate(j, times))
        wi = getattr(job.executor, "walk_index", None)
        if wi is not None and "walk_index" in d:
            # back onto the executor's device, where its index lives
            dev = wi.endpoints.device
            wi.endpoints = torch.as_tensor(d["walk_index"]["endpoints"],
                                           dtype=torch.int32, device=dev)
            wi.budget = torch.as_tensor(d["walk_index"]["budget"],
                                        dtype=torch.int32, device=dev)
            wi.refreshed = int(d["walk_index"]["refreshed"])

    def _state_dict(self) -> dict:
        state: dict[str, Any] = {
            "clock": self.clock,
            "seq": self._seq,
            "events": self.events_processed,
            "heap": [[t, seq, kind, self._pack_payload(kind, payload)]
                     for (t, seq, kind, payload) in self._heap],
            "jobs": [self._pack_job(j) for j in self.jobs],
            "pool": {"grants": [[j, g] for j, g
                                in sorted(self.pool.grants.items())],
                     "reservations": [[j, r] for j, r
                                      in sorted(self.pool.reservations.items())],
                     "failed": sorted(self.pool.allocator.failed)},
            "grant_peak": [[j, g] for j, g
                           in sorted(self._grant_peak.items())],
            "lemma2": [[j, v] for j, v in sorted(self._lemma2_cs.items())],
            "waiting": [j.job_id for j in self._waiting],
            "model": {"ewma": self.model._ewma},
            "pre_core_s": self.pre_core_s,
            "compile_billed": self._compile_billed,
            "graph_version": self.graph_version,
            "mutation": {"applied": self.mutations_applied,
                         "pending_refresh": self.pending_refresh,
                         "refresh_core_s": self.refresh_core_s,
                         "rebuild_core_s": self.rebuild_core_s},
            "controller": {
                "rescale_events": list(self.controller.rescale_events),
                "straggler_events": list(self.controller.straggler_events),
                "occupancy_events": list(self.controller.occupancy_events)},
        }
        if self.engine is not None:
            state["engine"] = self.engine.state_dict()
            state["ledger"] = self.ledger.state_dict()
        if self.cache is not None:
            state["cache"] = {
                "entries": [[list(k), e.cost, e.created, e.hits]
                            for k, e in self.cache._entries.items()],
                "stats": asdict(self.cache.stats),
                "cadence": self.cache.cadence_state()}
        return state

    def _load_state(self, state: dict) -> None:
        """Overlay a snapshot onto a freshly rebuilt runtime (inputs already
        re-submitted with the WAL muted). Replaces the heap wholesale —
        the rebuild's arrival/fail pushes are the event-0 view; the
        snapshot's heap is the as-of-crash view with matching ``seq``."""
        self.clock = float(state["clock"])
        self._seq = int(state["seq"])
        self.events_processed = int(state["events"])
        for d in state["jobs"]:
            self._load_job(d)
        self._heap = [(float(t), int(seq), str(kind),
                       self._unpack_payload(str(kind), packed))
                      for t, seq, kind, packed in state["heap"]]
        # heapify may lay the array out differently than the crashed
        # process's heap, but pop order depends only on the (t, seq) keys
        # and seq is unique — replay order is identical either way
        heapq.heapify(self._heap)
        self.pool.grants = {int(j): int(g)
                            for j, g in state["pool"]["grants"]}
        self.pool.reservations = {int(j): int(r)
                                  for j, r in state["pool"]["reservations"]}
        for idx in state["pool"]["failed"]:
            self.pool.allocator.mark_failed(int(idx))
        self._grant_peak = {int(j): int(g) for j, g in state["grant_peak"]}
        self._lemma2_cs = {int(j): float(v) for j, v in state["lemma2"]}
        self._waiting = [self.jobs[int(i)] for i in state["waiting"]]
        self.model._ewma = state["model"]["ewma"]
        # .get: snapshots from before the cold-start accounting load cleanly
        self.pre_core_s = float(state.get("pre_core_s", 0.0))
        self._compile_billed = bool(state.get("compile_billed", False))
        self.graph_version = int(state.get("graph_version",
                                           self.cfg.graph_version))
        mut = state.get("mutation")
        if mut is not None:
            self.mutations_applied = int(mut["applied"])
            self.pending_refresh = int(mut["pending_refresh"])
            self.refresh_core_s = float(mut["refresh_core_s"])
            self.rebuild_core_s = float(mut["rebuild_core_s"])
        self.controller.rescale_events[:] = state["controller"][
            "rescale_events"]
        self.controller.straggler_events[:] = state["controller"][
            "straggler_events"]
        self.controller.occupancy_events[:] = state["controller"].get(
            "occupancy_events", [])
        if "engine" in state:
            self.engine = SimLaneEngine.from_state(state["engine"])
            self.ledger = LaneLedger.from_state(state["ledger"])
        if self.cache is not None and "cache" in state:
            self.cache._entries.clear()
            for key, cost, created, hits in state["cache"]["entries"]:
                self.cache._entries[tuple(key)] = CacheEntry(
                    value=None, cost=float(cost), created=float(created),
                    hits=int(hits))
            self.cache.stats = CacheStats(**state["cache"]["stats"])
            if "cadence" in state["cache"]:
                self.cache.load_cadence_state(state["cache"]["cadence"])

    # -- recovery -----------------------------------------------------------
    @classmethod
    def recover(cls, wal_dir: str | Path,
                executor_factory: ExecutorFactory, *,
                heartbeat: HeartbeatMonitor | None = None,
                fsync: bool = True
                ) -> tuple["ServingRuntime", RecoveryInfo]:
        """Reconstruct a crashed runtime from its WAL directory.

        Three phases: (1) rebuild the runtime from the logged inputs
        (init/submit/inject/slowdown records, WAL muted so nothing is
        double-logged); (2) overlay the newest restorable snapshot — an
        unrestorable one (GC'd, or a killed writer's leftovers) falls back
        to the next older, ultimately to replay-from-zero; (3) queue the
        logged event suffix for verified replay. The caller then just calls
        :meth:`run` — replayed events re-execute deterministically (virtual
        clock, seeds and admission decisions are functions of the logged
        inputs), and execution continues live past the crash point. An
        accepted job is never lost: its submit record is in the log, so it
        completes, degrades, or extends via §III-A — never drops."""
        from ..checkpoint import store as ckpt_store
        records = WriteAheadLog.read(wal_dir)
        init = next((r for r in records if r["type"] == "init"), None)
        if init is None:
            raise ValueError(f"no init record in WAL at {wal_dir}")
        cfg = ServingConfig(**init["config"])
        p = init["pool"]
        pool = CorePool.of(int(p["num_devices"]),
                           int(p["lanes_per_device"]),
                           float(p["spares_fraction"]))
        cache = None
        if init.get("cache") is not None:
            cache = ResultCache(
                int(init["cache"]["capacity"]), init["cache"]["ttl"],
                ttl_update_factor=init["cache"].get("ttl_update_factor"))
        m = init["model"]
        model = CacheAwareCostModel(decay=m["decay"],
                                    max_trust=m["max_trust"],
                                    walk_share=m["walk_share"],
                                    index_coverage=m["index_coverage"])
        controller = ElasticController(allocator=pool.allocator,
                                       heartbeat=heartbeat)
        rt = cls(pool, executor_factory, cfg, controller=controller,
                 cache=cache, cost_model=model)
        wal = WriteAheadLog(wal_dir, fsync=fsync)
        rt.attach_wal(wal, snapshot_every=int(init.get("snapshot_every", 0)),
                      compact_keep=int(init.get("compact_keep", 0)),
                      _log_init=False)
        rt._mute_wal = True
        try:
            # inputs re-dispatch in FILE order — interleaved submit/inject/
            # slowdown calls reproduce the exact heap seq numbering
            for rec in records:
                if rec["type"] == "submit":
                    rt.submit(int(rec["queries"]), float(rec["deadline"]),
                              at=float(rec["at"]), seed=int(rec["seed"]),
                              sources=rec.get("sources"))
                elif rec["type"] == "inject":
                    rt.inject_failures(
                        {float(t): [int(d) for d in devs]
                         for t, devs in rec["schedule"]})
                elif rec["type"] == "slowdown":
                    rt.schedule_slowdowns(
                        {float(t): float(f) for t, f in rec["schedule"]})
                elif rec["type"] == "mutations":
                    # sim-accounting only: the daemon re-attaches its own
                    # on_mutate hook after recover() returns
                    rt.schedule_mutations(
                        int(rec["num"]), float(rec["rate"]),
                        seed=int(rec["seed"]),
                        graph_n=int(rec["graph_n"]),
                        affected_frac=float(rec["affected_frac"]),
                        refresh_budget=int(rec["refresh_budget"]),
                        node_cost=float(rec["node_cost"]))
        finally:
            rt._mute_wal = False
        events = [r for r in records if r["type"] == "event"]
        snap_step = None
        for step in sorted((r["step"] for r in records
                            if r["type"] == "snapshot"), reverse=True):
            try:
                _, leaves = ckpt_store.restore_list(wal.snapshot_dir,
                                                    int(step))
            except (FileNotFoundError, OSError, ValueError):
                continue
            rt._load_state(unpack_state(leaves))
            snap_step = int(step)
            break
        if snap_step is None:
            covered = max((int(r.get("covered", 0)) for r in records
                           if r["type"] == "compact"), default=0)
            if covered > 0:
                raise ValueError(
                    f"WAL at {wal_dir} was compacted past event {covered} "
                    f"and no retained snapshot is restorable — the dropped "
                    f"prefix cannot be replayed from zero")
        replay = deque(r for r in events
                       if int(r["n"]) > (snap_step or 0))
        rt._replay_expect = replay
        info = RecoveryInfo(snapshot_step=snap_step,
                            replayed_events=len(replay),
                            logged_events=len(events))
        wal.append({"type": "recover", "from_step": snap_step,
                    "replayed": len(replay), "logged_events": len(events)})
        return rt, info

    # -- straggler mitigation (DESIGN.md §12) -------------------------------
    def _mitigate(self, job: Job, times: np.ndarray) -> np.ndarray:
        """Slot-boundary speculative re-issue: lanes whose slot time crossed
        the paper's fluctuation threshold ``t_hat * (2 - d)`` are re-run on
        pool spares, first result wins. Answers are invariant — a re-issued
        chunk re-executes under the same query-derived seeds (ForaExecutor
        seeds each query's walks from (workload seed, query id), independent
        of call history) — so only the
        completion TIME changes: min(original, threshold + re-issue draw).
        Re-issue draws come from the job's own snapshotted RNG stream, so
        recovery replays the same mitigation decisions bit-for-bit."""
        if job.stats is None or job.reissue_rng is None:
            return times
        t_hat = job.stats.t_max * job.est_scale
        if t_hat <= 0:
            return times
        monitor = StragglerMonitor(t_hat=t_hat,
                                   scaling_factor=self.cfg.scaling_factor)
        spares = self.pool.allocator.spares
        lanes = monitor.decide(times, [False] * int(times.size), spares)
        if not lanes:
            return times
        draws = job.reissue_rng.permutation(times)
        sel = np.asarray(lanes)
        eff = times.copy()
        eff[sel] = monitor.simulate_reissue(times[sel], draws[sel])
        before, after = float(times.max()), float(eff.max())
        self.controller.note_stragglers(
            job.stepper.steps if job.stepper is not None else 0,
            job.job_id, lanes, before, after)
        job.log.append(f"t={self.clock:.3f} straggler re-issue "
                       f"lanes={lanes} makespan {before:.4f}->{after:.4f}")
        self._wal_note("straggler", job=job.job_id, lanes=list(lanes),
                       makespan_before=before, makespan_after=after)
        return eff

    # -- arrival / admission ------------------------------------------------
    def _pop_waiter(self, now: float) -> None:
        """Re-enqueue ALL queued jobs (FIFO — the heap's seq tiebreaker
        preserves order at equal times). Called whenever a job reaches a
        terminal state: a release may free enough cores for several
        waiters, and any waiter still not fitting simply re-queues itself
        when its arrival event is processed. Every terminal transition must
        chain here, or waiters behind a rejected/preprocessing-only job
        would strand with the heap drained."""
        waiters, self._waiting = self._waiting, []
        for job in waiters:
            self._push(now, "arrive", job)

    def _sample_size(self, num_queries: int) -> int:
        if self.cfg.sample_size is not None:
            return min(self.cfg.sample_size, num_queries)
        return fraction_sample_size(num_queries, self.cfg.sample_frac)

    # -- cache plumbing (DESIGN.md §11) -------------------------------------
    def _cache_key(self, job: Job, qid: int):
        """(source, epsilon, graph_version) for one of a job's queries, or
        None when the job has no source notion (uncacheable). Sources come
        from the job's explicit trace row when present, else from the
        executor's workload; epsilon from the executor's FORA params (a
        degraded executor caches under its raised epsilon — a full-accuracy
        request never silently receives a coarser answer)."""
        if job.sources is not None:
            src = job.sources[qid]
        else:
            workload = getattr(job.executor, "workload", None)
            if workload is None or not hasattr(workload, "source_of"):
                return None
            src = int(workload.source_of(qid))
        eps = getattr(getattr(job.executor, "params", None), "epsilon", None)
        return ResultCache.make_key(src, eps, self.graph_version)

    def _cache_probe(self, job: Job, now: float, *,
                     count: bool) -> tuple[list[int], list[int]]:
        """Partition the job's queries into (hits, misses). ``count=False``
        peeks (no hit accounting) — used for the pre-gate full-hit check so
        a job that later queues does not inflate the per-key accounting."""
        hits: list[int] = []
        misses: list[int] = []
        for qid in range(job.num_queries):
            key = self._cache_key(job, qid)
            entry = None
            if key is not None:
                entry = (self.cache.get(key, now=now) if count
                         else self.cache.peek(key, now=now))
            (hits if entry is not None else misses).append(qid)
        return hits, misses

    @property
    def _cache_on(self) -> bool:
        return self.cache is not None and self.cache.capacity > 0

    def _reshape(self, job: Job, now: float) -> None:
        """Route the job's current grant through ``CorePool.mesh_plan`` so
        a grant arrives (and re-arrives after every grow/shrink) as a
        devices x lanes mesh shape, not a bare integer (ROADMAP PR-4
        follow-up). Executors exposing ``on_mesh`` are notified."""
        grant = self.pool.grant_of(job.job_id)
        if grant < 1:
            return
        try:
            plan = self.pool.mesh_plan(grant)
        except InfeasibleDeadline:
            return      # transiently overcommitted mid-failure; shed first
        if job.mesh is None or (plan.devices, plan.lanes) != (
                job.mesh.devices, job.mesh.lanes):
            job.mesh = plan
            job.log.append(f"t={now:.3f} mesh {plan.devices}x{plan.lanes} "
                           f"(grant {grant})")
            if hasattr(job.executor, "on_mesh"):
                job.executor.on_mesh(plan)

    def _handle_arrival(self, job: Job, now: float) -> None:
        cfg = self.cfg
        if self._cache_on:
            # consulted BEFORE admission: known answers never touch the
            # Lemma-1 arithmetic or the pool — a fully-cached job completes
            # even against an exhausted pool
            _, misses = self._cache_probe(job, now, count=False)
            if not misses:
                hits, _ = self._cache_probe(job, now, count=True)
                self.model.observe(len(hits), job.num_queries)
                job.cache_hits = len(hits)
                job.effective_queries = 0
                job.state = JobState.DONE
                job.completion = now
                job.log.append(f"t={now:.3f} answered from cache "
                               f"({len(hits)} hits, zero cores)")
                self._wal_note("cache_done", job=job.job_id, hits=len(hits))
                self._pop_waiter(now)
                return
        c = cfg.preprocess_cores
        if self.pool.free < c:
            if self.pool.used > 0 or self.pool.reserved > 0:
                # pool momentarily exhausted: queue behind the running jobs
                # (a future completion re-enqueues us) instead of rejecting —
                # the SLA clock keeps running, replan/degrade absorb the wait
                self._waiting.append(job)
                job.log.append(f"t={now:.3f} queued (pool exhausted)")
                self._wal_note("queued", job=job.job_id)
                return
            job.state = JobState.REJECTED        # pool has zero capacity
            job.log.append(f"t={now:.3f} rejected: zero-capacity pool")
            return
        misses = list(range(job.num_queries))
        if self._cache_on:
            hits, misses = self._cache_probe(job, now, count=True)
            self.model.observe(len(hits), job.num_queries)
            job.cache_hits = len(hits)
            if hits:
                job.log.append(f"t={now:.3f} {len(hits)} of "
                               f"{job.num_queries} queries cached")
        job.effective_queries = len(misses)
        s = self._sample_size(len(misses))
        rng = np.random.default_rng(job.seed)
        sample_idx, rest_idx = _draw_sample(rng, len(misses), s)
        sample_ids = [misses[i] for i in sample_idx]
        rest_ids = [misses[i] for i in rest_idx]
        stats = job.executor(sample_ids)
        job.stats = stats
        job.t_pre = stats.t_pre_on(c)
        # cold-start compile surcharge (DESIGN.md §15): the daemon's first
        # admitted job eats the fused-executable compile inside its c-core
        # preprocess reservation — unless a warm persistent compilation
        # cache waives it. Billed once per runtime lifetime either way.
        if self.cfg.cold_compile_s > 0.0 and not self._compile_billed:
            self._compile_billed = True
            if not self.cfg.warm_start:
                job.t_pre += self.cfg.cold_compile_s
        # preprocessing cost is real core time even though c is tiny; the
        # c cores are additionally RESERVED in the pool over the preprocess
        # window below (ROADMAP follow-up — they used to be assumed free),
        # and the slot grant acquired below is charged from NOW too
        job.core_seconds += c * job.t_pre
        self.pre_core_s += c * job.t_pre
        if self._in_replay:
            # recovery re-executes this preprocessing — real cores burned
            # twice for the same sample, surfaced by the daemon's recovery
            # report (the Alg.-2 c-core cost a crash re-bills)
            self.replay_pre_core_s += c * job.t_pre
        job._accounted_to = now
        try:
            self._lemma2_cs[job.job_id] = (
                BoundReport.from_stats(job.num_queries, job.deadline, stats,
                                       cfg.p_f).lemma2_cores * job.deadline)
        except InfeasibleDeadline:
            # t_max > T: static Lemma-2 provisioning has no answer at all for
            # this job (reporting only — admission handles the job itself)
            self._lemma2_cs[job.job_id] = 0.0

        admitted = (self._admit_engine(job, now) if self.engine is not None
                    else self._admit(job, now))
        if not admitted:
            job.state = JobState.REJECTED
            job.log.append(f"t={now:.3f} rejected at admission")
            self._wal_note("rejected", job=job.job_id)
            self._reserve_pre(job, now, c)       # the sample still ran
            self._pop_waiter(now)         # keep the waiter chain alive
            return
        if len(rest_ids) == 0:
            # §III-A: s >= X, preprocessing answered everything
            job.state = JobState.DONE
            job.completion = now + job.t_pre
            job.log.append(f"t={now:.3f} done in preprocessing")
            self._wal_note("preprocessed", job=job.job_id)
            if self._cache_on:
                self._push(now + job.t_pre, "publish",
                           (job, sample_ids, stats))
            self._reserve_pre(job, now, c)
            self._pop_waiter(now + job.t_pre)
            return

        if self.engine is not None:
            # continuous-batching path (DESIGN.md §14): no slot grant is
            # held — per-query durations are drawn NOW (after the admission
            # ladder, so any degradation applied there is priced in), their
            # sum reserved as lane-seconds, and the queries join the EDF
            # ready queue once preprocessing finishes (engine_ready)
            rest_stats = job.executor(rest_ids)
            job.draw_scale = float(getattr(job.executor, "scale", 1.0))
            durations = np.asarray(rest_stats.times, dtype=float)
            work = float(durations.sum())
            self.ledger.reserve(job.job_id, work)
            job.engine_total = len(rest_ids)
            job.engine_pending = [[int(q), float(t)]
                                  for q, t in zip(rest_ids, durations)]
            job.state = JobState.RUNNING
            job.slots_t0 = now + job.t_pre
            self._reserve_pre(job, now, c)
            job.log.append(f"t={now:.3f} admitted (engine) s={s} "
                           f"queries={len(rest_ids)} work={work:.3f} "
                           f"lane-s t_pre={job.t_pre:.4f}")
            self._wal_note("engine_admitted", job=job.job_id, s=s,
                           queries=len(rest_ids), work=work)
            if self._cache_on:
                self._push(job.slots_t0, "publish",
                           (job, sample_ids, stats))
            self._push(job.slots_t0, "engine_ready", job)
            return

        ell, k = self._initial_grant(job, now, len(rest_ids))
        if not self.pool.acquire(job.job_id, k):
            # admission sized k against the pool it can see; a refusal here
            # means the accounting diverged — proceeding would oversubscribe
            raise RuntimeError(
                f"pool refused k={k} for job {job.job_id} "
                f"(free={self.pool.free}) — admission/pool accounting "
                f"diverged")
        self._grant_peak[job.job_id] = k
        job.state = JobState.RUNNING
        job.slots_t0 = now + job.t_pre
        # Alg. 2's c preprocessing cores occupy the pool until slots start;
        # the k-grant (held from now, reserve-ahead) subsumes c of them
        self._reserve_pre(job, now, max(0, c - k))
        # slots prefer the chunked API (one fused device step per slot,
        # control back to the event loop in between); sampling used __call__
        # above because admission needs per-query time resolution
        slot_exec = getattr(job.executor, "run_chunk", job.executor)
        job.stepper = SlotStepper.from_queries(rest_ids, ell, k, slot_exec)
        if cfg.stragglers:
            # per-job re-issue RNG stream, derived from the job's own seed
            # (not the shared numpy state) and snapshotted with the job —
            # recovery replays identical mitigation draws
            job.reissue_rng = np.random.default_rng(
                np.random.SeedSequence([job.seed, 0x57A6]))
            job.stepper.straggler = (
                lambda times, j=job: self._mitigate(j, times))
        job.log.append(f"t={now:.3f} admitted s={s} ell={ell} k={k} "
                       f"t_pre={job.t_pre:.4f}")
        self._wal_note("admitted", job=job.job_id, s=s, ell=ell, k=k)
        self._reshape(job, now)
        if self._cache_on:
            self._push(job.slots_t0, "publish", (job, sample_ids, stats))
        self._step_job(job)

    def _reserve_pre(self, job: Job, now: float, cores: int) -> None:
        """Bill ``cores`` preprocessing cores against the pool over
        [now, now + t_pre) — released by the ``pre_release`` event."""
        if cores > 0 and job.t_pre > 0 and self.pool.reserve(job.job_id,
                                                             cores):
            self._push(now + job.t_pre, "pre_release", job)

    def _record_answers(self, job: Job, qids: Sequence[int],
                        stats: RuntimeStats, now: float) -> None:
        """Insert answered queries into the result cache with their measured
        per-query cost (per-key accounting feeds the saved-core-seconds
        report and the cost model's hit-rate signal)."""
        if not self._cache_on:
            return
        for qid, t in zip(qids, np.asarray(stats.times)):
            key = self._cache_key(job, qid)
            if key is not None:
                self.cache.put(key, cost=float(t), now=now)

    def _admit(self, job: Job, now: float) -> bool:
        """Lemma-1 admission against the pool's free cores, with the
        degrade-then-extend rescue ladder. True iff the job may run.

        The estimate is the cache-aware discounted one (DESIGN.md §11):
        arrival-time hits were already removed from ``effective_queries``;
        the cost model further shaves the learned expected-miss fraction
        (future slot-boundary hits) off the count and the index-served walk
        share off t_max. A cold model leaves both multipliers at exactly
        1.0, reproducing the PR-4 arithmetic bit-for-bit."""
        cfg = self.cfg
        capacity = self.pool.free
        x_eff = self.model.discounted_queries(job.effective_queries)
        t_disc = self.model.time_discount()
        while True:
            T_rel = job.abs_deadline - now
            t_max = job.stats.t_max * job.est_scale * t_disc
            try:
                need = required_cores(
                    lemma1_lower_bound(x_eff, t_max, T_rel))
            except ValueError:
                need = None                       # t_max > T or T <= 0
            if need is not None and need <= capacity and capacity >= 1:
                return True
            if self._try_degrade(job, now, "admission"):
                continue
            if cfg.extend and capacity >= 1:
                new_T = minimal_feasible_deadline(
                    x_eff, job.stats.t_max * job.est_scale * t_disc,
                    capacity)
                job.abs_deadline = now + new_T
                job.extended = True
                job.log.append(f"t={now:.3f} admission extended T to "
                               f"{new_T:.3f}s (cap {capacity})")
                return True
            return False

    # -- engine mode: continuous lane batching (DESIGN.md §14) --------------
    def _engine_cap(self) -> int:
        """Usable lanes right now: the configured pool, shrunk by device
        failures (the allocator's live capacity) and by preprocessing
        reservations — the Alg. 2 ``c`` cores still come out of the same
        machine. In-flight lanes above a shrunk cap drain normally; only
        new insertions see the reduced capacity."""
        return min(self.engine.lanes,
                   max(0, self.pool.total - self.pool.reserved))

    def _admit_engine(self, job: Job, now: float) -> bool:
        """Lemma-1 admission for the engine path, with the same
        degrade-then-extend rescue ladder as :meth:`_admit`. Two checks
        must pass: the paper's core bound fits the lane pool, and the
        job's estimated lane-seconds fit the pool's uncommitted
        lane-second budget over its window (the :class:`LaneLedger` —
        occupancy accounting replaces slot grants)."""
        cfg = self.cfg
        capacity = self._engine_cap()
        if capacity < 1:
            return False
        x_eff = self.model.discounted_queries(job.effective_queries)
        t_disc = self.model.time_discount()
        while True:
            T_rel = job.abs_deadline - now
            t_max = job.stats.t_max * job.est_scale * t_disc
            t_avg = job.stats.t_avg * job.est_scale * t_disc
            try:
                need = required_cores(
                    lemma1_lower_bound(x_eff, t_max, T_rel))
            except ValueError:
                need = None                       # t_max > T or T <= 0
            est_work = x_eff * t_avg              # expected lane-seconds
            if (need is not None and need <= capacity
                    and self.ledger.outstanding + est_work
                    <= capacity * max(T_rel, 0.0)):
                return True
            if self._try_degrade(job, now, "engine admission"):
                continue
            if cfg.extend:
                new_T = minimal_feasible_deadline(
                    x_eff, job.stats.t_max * job.est_scale * t_disc,
                    capacity)
                new_T = max(new_T, (self.ledger.outstanding + est_work)
                            / capacity)
                job.abs_deadline = now + new_T
                job.extended = True
                job.log.append(f"t={now:.3f} engine admission extended T "
                               f"to {new_T:.3f}s (lanes {capacity})")
                return True
            return False

    def _handle_engine_ready(self, job: Job, now: float) -> None:
        """Preprocessing done: move the job's (qid, duration) pairs from
        its pending list into the engine's EDF ready queue and fill
        whatever lanes are free."""
        if job.state is not JobState.RUNNING or not job.engine_pending:
            return
        for qid, dur in job.engine_pending:
            self.engine.enqueue(job.abs_deadline, job.job_id, int(qid),
                                float(dur))
        job.engine_pending = None
        self._engine_fill(now)

    def _engine_fill(self, now: float) -> None:
        """THE continuous-batching step: while a lane is free and any
        admitted query is ready, insert the EDF-earliest one. This runs at
        every insertion opportunity (ready/completion/pre_release), which
        is exactly what replaces between-slot Alg.-2 replanning — lanes
        rebalance across jobs the moment one frees up. Still-pending
        queries re-probe the cache first (DESIGN.md §11 late hits: answers
        produced by concurrent jobs shed work before it ever takes a
        lane)."""
        if self.engine is None:
            return
        cap = self._engine_cap()
        hits = lookups = 0
        filled = False
        while True:
            lane = self.engine.free_lane(cap)
            if lane is None:
                break
            entry = self.engine.pop_ready()
            if entry is None:
                break
            _, job_id, qid, dur = entry
            job = self.jobs[job_id]
            if job.state is not JobState.RUNNING:
                continue                       # job terminated mid-queue
            if self._cache_on and self.cfg.cache_recheck:
                key = self._cache_key(job, qid)
                if key is not None:
                    lookups += 1
                    if self.cache.get(key, now=now) is not None:
                        hits += 1
                        job.late_hits += 1
                        job.engine_done += 1
                        self.ledger.consume(job.job_id, float(dur))
                        job.log.append(f"t={now:.3f} q{qid} answered from "
                                       "cache (late hit, lane bypassed)")
                        self._engine_job_done(job, now)
                        continue
            scale = getattr(job.executor, "scale", None)
            eff = (float(dur) if scale is None
                   else float(dur) * float(scale) / job.draw_scale)
            rebalanced = self.engine.occupy(lane, qid, job_id, now,
                                            now + eff, eff)
            job.inflight += 1
            self._grant_peak[job_id] = max(self._grant_peak.get(job_id, 0),
                                           job.inflight)
            self._wal_note("engine_insert", job=job_id, qid=qid, lane=lane,
                           t_end=now + eff)
            if rebalanced:
                self._wal_note("engine_rebalance", lane=lane, job=job_id)
            self._push(now + eff, "engine", (lane, qid, job_id))
            filled = True
        if lookups:
            self.model.observe(hits, lookups)
        if filled or hits:
            self._log_occupancy(now)

    def _handle_engine_done(self, payload: tuple[int, int, int],
                            now: float) -> None:
        """One lane's query converged: evict it, bill its lane-seconds,
        publish its answer, and refill the lane."""
        lane, qid, job_id = payload
        job = self.jobs[job_id]
        task = self.engine.release(lane)
        if task.qid != qid or task.job_id != job_id:
            raise RuntimeError(
                f"engine accounting diverged: lane {lane} held "
                f"q{task.qid}/job{task.job_id}, event said q{qid}/"
                f"job{job_id}")
        job.inflight -= 1
        job.engine_done += 1
        job.core_seconds += task.work
        self.ledger.consume(job_id, task.work)
        if self._cache_on:
            key = self._cache_key(job, qid)
            if key is not None:
                self.cache.put(key, cost=task.work, now=now)
        self._wal_note("engine_evict", job=job_id, qid=qid, lane=lane)
        self._engine_job_done(job, now)
        self._engine_fill(now)
        self._log_occupancy(now)

    def _engine_job_done(self, job: Job, now: float) -> None:
        """Terminal check after any engine-side progress: every routed
        query accounted for and none in flight -> the job is DONE."""
        if (job.state is JobState.RUNNING and job.engine_total
                and job.engine_done >= job.engine_total
                and job.inflight == 0):
            job.state = JobState.DONE
            job.completion = now
            self.ledger.release(job.job_id)
            job.log.append(f"t={now:.3f} done (engine) "
                           f"lateness={job.lateness:.4f}")
            self._wal_note("completed", job=job.job_id,
                           lateness=job.lateness)
            self._pop_waiter(now)

    def _log_occupancy(self, now: float) -> None:
        """Sample the lane-occupancy time-series into the controller log
        (deduped against the previous sample so steady state costs
        nothing)."""
        ev = self.controller.occupancy_events
        busy, lanes = self.engine.busy, self.engine.lanes
        pending = self.engine.pending()
        if ev and ev[-1]["busy"] == busy and ev[-1]["pending"] == pending \
                and ev[-1]["lanes"] == lanes:
            return
        self.controller.note_occupancy(now, busy, lanes, pending)

    def _initial_grant(self, job: Job, now: float,
                       remaining: int) -> tuple[int, int]:
        """Algorithm 2 Lines 7-8 against the current pool: ell from the
        d-scaled remaining budget, k = ceil(remaining/ell), capped at the
        pool's free cores (re-slotting when capped). ``k`` is sized from
        the cost model's expected-miss count (cold: = remaining), while the
        slot plan always covers ALL remaining work — if the predicted hits
        never materialise, the work still has cells and replanning grows
        the grant instead of queries being dropped."""
        cfg = self.cfg
        T_rel = job.abs_deadline - now
        t_avg = job.t_avg_estimate() * self.model.time_discount()
        r_eff = self.model.discounted_queries(remaining)
        budget = cfg.scaling_factor * T_rel - job.t_pre
        ell = num_slots(budget, t_avg) if budget > 0 else 0
        if ell < 1:
            # preprocessing ate the scaled budget — run serially and let the
            # replan/degrade ladder recover (never reject post-admission)
            ell = remaining
            k = 1
        else:
            k = queries_per_slot(r_eff, ell)
            ell = max(ell, -(-remaining // k))    # plan must hold ALL work
        free = max(1, self.pool.free)
        if k > free:
            k = free
            ell = max(ell, -(-remaining // k))    # re-slot to cover all work
            predicted = now + job.t_pre + -(-remaining // k) * t_avg
            if predicted > job.abs_deadline:
                self._try_degrade(job, now, "pool-capped grant")
        return ell, k

    # -- slot stepping / replanning -----------------------------------------
    def _step_job(self, job: Job) -> None:
        """Execute the job's next slot and schedule its completion event."""
        stats = job.stepper.step()
        if stats is None:                          # drained between events
            return
        job.stats = job.stats.merged(stats)        # fold observed times
        self._push(job.slots_t0 + job.stepper.makespan, "slot", job)

    def _handle_slot(self, job: Job, t: float) -> None:
        if job.state is not JobState.RUNNING:
            return
        now = t
        grant = self.pool.grant_of(job.job_id)
        job.account(now, grant)
        if self._cache_on and job.stepper.executed_slots:
            # the slot that just completed publishes its answers
            slot = job.stepper.executed_slots[-1]
            times = job.stepper.per_query_times
            for qid in slot:
                key = self._cache_key(job, qid)
                if key is not None:
                    self.cache.put(key, cost=times[qid], now=now)
        if not job.stepper.done and self._cache_on and self.cfg.cache_recheck:
            self._recheck_pending(job, now)
        if job.stepper.done:
            job.state = JobState.DONE
            job.completion = now
            self.pool.release(job.job_id)
            job.log.append(f"t={now:.3f} done lateness={job.lateness:.4f}")
            self._wal_note("completed", job=job.job_id,
                           lateness=job.lateness)
            self._pop_waiter(now)                 # freed cores: admit a waiter
            return
        if self.cfg.replan:
            self._replan(job, now)
        self._step_job(job)

    def _recheck_pending(self, job: Job, now: float) -> None:
        """Slot-boundary cache recheck (DESIGN.md §11): queries another job
        answered since admission are dropped from the work queues — they
        cost zero further core time, and the following replan releases the
        cores they would have used. The observed late-hit rate feeds the
        cost model's expected-work discount."""
        pending = job.stepper.queues.pending()
        drop = set()
        lookups = 0
        for qid in pending:
            key = self._cache_key(job, qid)
            if key is None:
                continue
            lookups += 1
            if self.cache.get(key, now=now) is not None:
                drop.add(qid)
        if lookups:
            self.model.observe(len(drop), lookups)
        if drop:
            removed = job.stepper.discard(drop)
            job.late_hits += removed
            job.log.append(f"t={now:.3f} {removed} pending answered from "
                           "cache (late hits)")

    def _replan(self, job: Job, now: float) -> None:
        """Re-run the Alg. 2 arithmetic over the remaining work with the
        rolling merged statistics; resize the grant through the pool."""
        cfg = self.cfg
        R = job.stepper.remaining
        grant = self.pool.grant_of(job.job_id)
        T_left = job.abs_deadline - now
        t_avg = job.t_avg_estimate() * self.model.time_discount()
        r_eff = self.model.discounted_queries(R)
        budget = cfg.scaling_factor * T_left
        job.replans += 1
        ell = num_slots(budget, t_avg) if budget > 0 else 0
        k_new = queries_per_slot(r_eff, ell) if ell >= 1 else r_eff
        k_max = grant + self.pool.free
        k_new = min(max(1, k_new), max(1, k_max))
        if k_new < grant:
            released = self.pool.shrink(job.job_id, grant - k_new)
            if released:
                job.stepper.resize(grant - released)
                job.log.append(f"t={now:.3f} replan shrink {grant}->"
                               f"{grant - released} (ahead)")
                self._wal_note("grant", job=job.job_id,
                               cores=grant - released)
                self._reshape(job, now)
        elif k_new > grant:
            added = self.pool.grow(job.job_id, k_new - grant)
            if added:
                job.stepper.resize(grant + added)
                job.log.append(f"t={now:.3f} replan grow {grant}->"
                               f"{grant + added} (behind)")
                self._wal_note("grant", job=job.job_id, cores=grant + added)
                self._reshape(job, now)
        grant = self.pool.grant_of(job.job_id)
        self._grant_peak[job.job_id] = max(self._grant_peak[job.job_id], grant)
        # miss predicted at the best obtainable grant?
        predicted = now + -(-R // grant) * t_avg
        if predicted > job.abs_deadline and self.pool.free == 0:
            if not self._try_degrade(job, now, "miss predicted"):
                if cfg.extend and predicted > job.abs_deadline:
                    job.abs_deadline = predicted
                    job.extended = True
                    job.log.append(
                        f"t={now:.3f} deadline extended to t={predicted:.3f}")

    def _try_degrade(self, job: Job, now: float, why: str) -> bool:
        cfg = self.cfg
        if not cfg.degrade or job.degrade_count >= cfg.max_degrades:
            return False
        if hasattr(job.executor, "degrade"):
            job.executor.degrade(cfg.degrade_factor)
        job.est_scale *= cfg.degrade_factor
        job.degraded = True
        job.degrade_count += 1
        job.log.append(f"t={now:.3f} degraded x{cfg.degrade_factor} ({why})")
        return True

    # -- failures / chaos ---------------------------------------------------
    def _handle_failure(self, ordinal: int, now: float) -> None:
        """A device failure: the ElasticController marks it failed (the pool
        reads capacity from the same allocator), overcommitted grants are
        shed largest-first and every affected job is readmitted over its
        remaining work — extended rather than lost."""
        running = [j for j in self.jobs if j.state is JobState.RUNNING]
        agg = running[0].stats if running else None
        self.controller.tick(
            ordinal, stats=agg,
            queries_left=sum(j.remaining for j in running),
            deadline_left=min((j.abs_deadline - now for j in running),
                              default=0.0))
        self._shed_and_readmit(now)

    def _shed_and_readmit(self, now: float) -> None:
        """Shed overcommitted grants largest-first and readmit every cut
        job over its remaining work (§III-A extension rather than loss).
        Shared by injected failures and heartbeat-detected ones."""
        running = [j for j in self.jobs if j.state is JobState.RUNNING]
        cuts = self.pool.shed_plan()
        for job in running:
            cut = cuts.get(job.job_id, 0)
            if not cut:
                continue
            grant = self.pool.grant_of(job.job_id)
            job.account(now, grant)
            self.pool.shrink(job.job_id, cut)
            job.stepper.resize(self.pool.grant_of(job.job_id))
            adm = self.pool.allocator.readmit(
                job.remaining, job.abs_deadline - now, job.stats,
                cores_per_device=self.pool.lanes_per_device,
                cost_model=self.model)
            if not adm.feasible and adm.extended:
                job.abs_deadline = now + adm.deadline
                job.extended = True
            job.log.append(f"t={now:.3f} failure shed {cut} cores "
                           f"(readmit feasible={adm.feasible})")
            self._reshape(job, now)
        if cuts:
            self._wal_note("shed",
                           cuts=[[j, c] for j, c in sorted(cuts.items())])

    def _handle_slowdown(self, factor: float, now: float) -> None:
        """A scheduled lane slowdown fires: every RUNNING job's executor is
        scaled by ``factor`` (> 1 slows), so subsequent slots run long and
        the straggler hook sees lanes crossing the re-issue threshold."""
        slowed = 0
        for job in self.jobs:
            if job.state is not JobState.RUNNING:
                continue
            ex = job.executor
            if hasattr(ex, "slow"):
                ex.slow(factor)
            elif hasattr(ex, "scale"):
                ex.scale *= factor
            else:
                continue
            slowed += 1
            job.log.append(f"t={now:.3f} lanes slowed x{factor}")
        self._wal_note("slowdown_fired", factor=factor, jobs=slowed)

    # -- graph mutations (DESIGN.md §16) ------------------------------------
    def _handle_mutation(self, ordinal: int, t: float) -> None:
        """One scheduled mutation batch fires: bump the live
        ``graph_version`` (cache keys made from now on stop matching
        pre-update answers — the §11 staleness rule, no sweep), apply the
        real delta through the daemon's ``on_mutate`` hook when attached,
        note the cadence to the cache's TTL tuner, and book the
        incremental-refresh vs full-rebuild core-second ledgers."""
        batch = self._mutation_batches[ordinal]
        cfg = self._mutation_cfg
        now = self.clock
        self.graph_version += 1
        affected = int(batch["affected"])
        if self._on_mutate is not None:
            info = self._on_mutate(ordinal, now)
            if info is not None and hasattr(info, "affected"):
                affected = int(np.asarray(info.affected).size)
        if self.cache is not None:
            self.cache.note_update(now)
        budget = cfg["refresh_budget"]
        refreshed = affected if budget <= 0 else min(affected, budget)
        self.pending_refresh += affected - refreshed
        self.refresh_core_s += cfg["node_cost"] * refreshed
        self.rebuild_core_s += cfg["node_cost"] * cfg["graph_n"]
        self.mutations_applied += 1
        self._wal_note("mutation", ordinal=ordinal,
                       version=self.graph_version, affected=affected,
                       refreshed=refreshed, pending=self.pending_refresh)
        self.controller._emit(
            "mutation", t=now, ordinal=ordinal, version=self.graph_version,
            affected=affected, refreshed=refreshed,
            pending_refresh=self.pending_refresh,
            apply_lag=now - batch["at"])
        if self.cache is not None:
            self.controller._emit(
                "cache", t=now, hit_rate=self.cache.hit_rate,
                size=len(self.cache), ttl=self.cache.ttl)

    def _poll_heartbeat(self, now: float) -> None:
        """Per-event liveness sweep when a HeartbeatMonitor is attached
        (serve.py --daemon wires it to the wall clock): silent devices are
        marked failed and the same shed/readmit path as injected failures
        runs — a daemon losing a device mid-flight degrades, never hangs."""
        silent = self.controller.poll_heartbeat()
        if silent:
            self._wal_note("heartbeat_failure", failed=list(silent))
            self._shed_and_readmit(now)


def run_single_job(num_queries: int, deadline: float,
                   executor: Any, max_cores: int, *,
                   sample_size: int, preprocess_cores: int = 1,
                   scaling_factor: float = 1.0, seed: int = 0
                   ) -> tuple[Job, ServingReport]:
    """The one-shot batch pipeline expressed as a runtime drive: a single
    job, no arrivals, no replanning/degradation — reproduces ``dna_real``'s
    cores/completion numbers bit-for-bit (regression-tested)."""
    pool = CorePool.of(max_cores)
    cfg = ServingConfig(scaling_factor=scaling_factor,
                        sample_size=sample_size,
                        preprocess_cores=preprocess_cores,
                        replan=False, degrade=False, extend=False)
    rt = ServingRuntime(pool, lambda job_id, nq, sd: executor, cfg)
    job = rt.submit(num_queries, deadline, at=0.0, seed=seed)
    report = rt.run()
    if job.state is JobState.REJECTED:
        raise InfeasibleDeadline("admission failed: " + "; ".join(job.log))
    return job, report
