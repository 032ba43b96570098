"""Fault tolerance: failure detection, elastic rescale, restart policy.

At 1000+ node scale the invariants are: (1) any step's work is recoverable
from the last checkpoint; (2) losing devices re-triggers admission (the
paper's Lemma-1 check) rather than killing the job; (3) stragglers are
re-issued speculatively from the paper's own fluctuation statistics
(core/allocator.py). This module is the control loop tying those together.
A copy of ``repro.ft.elastic``; its ``metrics`` sink is anything with an
``emit(kind, **fields)``, such as ``repro_torch.serving.metrics``' sinks.

Hardware failure signals are injectable (``FailureInjector`` for tests/CPU;
a real deployment wires device health RPCs into the same interface).
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..core.allocator import DeviceAllocator, StragglerMonitor
from ..core.bounds import InfeasibleDeadline
from ..core.estimator import RuntimeStats


@dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: [device_indices]}."""

    schedule: dict[int, list[int]] = field(default_factory=dict)

    def failures_at(self, step: int) -> list[int]:
        return self.schedule.get(step, [])


@dataclass
class ElasticController:
    """Drives a train/serve loop through failures.

    Failure signals come from BOTH sources on every tick: the injected
    schedule (tests / chaos drills) and the live :class:`HeartbeatMonitor`
    (a device whose heartbeats stopped is as failed as an injected one).
    on_rescale(healthy_count) is the caller's hook to rebuild mesh +
    re-place state from the last checkpoint.
    """

    allocator: DeviceAllocator
    injector: FailureInjector | None = None
    heartbeat: HeartbeatMonitor | None = None
    on_rescale: Callable[[int], None] | None = None
    rescale_events: list[dict] = field(default_factory=list)
    straggler_events: list[dict] = field(default_factory=list)
    occupancy_events: list[dict] = field(default_factory=list)
    # structured metrics sink (anything with emit(kind, **fields)) — a PURE
    # OBSERVER: every note_* hook mirrors its event row to the sink, nothing
    # is read back, so attaching one cannot perturb a replay. None =
    # detached.
    # metrics_muted is flipped by the serving runtime around WAL-replayed
    # events so a recovered run does not re-emit rows it already emitted.
    metrics: Any = None
    metrics_muted: bool = False

    def _emit(self, kind: str, **fields: Any) -> None:
        if self.metrics is not None and not self.metrics_muted:
            self.metrics.emit(kind, **fields)

    def tick(self, step: int, stats: RuntimeStats | None = None,
             queries_left: int = 0, deadline_left: float = 0.0) -> bool:
        """Process failures for this step — injected and heartbeat-detected.
        Returns True if a rescale happened (caller must restart from
        checkpoint)."""
        failed = list(self.injector.failures_at(step)) if self.injector else []
        silent: list[int] = []
        if self.heartbeat is not None:
            silent = [i for i in self.heartbeat.dead()
                      if i not in self.allocator.failed and i not in failed]
            failed += silent
        if not failed:
            return False
        for idx in failed:
            self.allocator.mark_failed(idx)
        event = {"step": step, "failed": list(failed),
                 "missed_heartbeat": silent,
                 "healthy": len(self.allocator.healthy)}
        if stats is not None and queries_left > 0:
            adm = self.allocator.readmit(queries_left, deadline_left, stats)
            event["readmission"] = {"cores": adm.cores,
                                    "deadline": adm.deadline,
                                    "extended": adm.extended,
                                    "feasible": adm.feasible}
        self.rescale_events.append(event)
        self._emit("rescale", **event)
        if self.on_rescale is not None:
            self.on_rescale(len(self.allocator.healthy))
        return True

    def poll_heartbeat(self) -> list[int]:
        """Heartbeat-only sweep — the serving loop's per-event liveness
        check. Unlike :meth:`tick` this never consults the injected
        schedule (its keys are scheduler ordinals, not serving events), so
        a runtime polling every event cannot double-fire injections.
        Returns the devices newly declared dead."""
        if self.heartbeat is None:
            return []
        silent = [i for i in self.heartbeat.dead()
                  if i not in self.allocator.failed]
        if not silent:
            return []
        for idx in silent:
            self.allocator.mark_failed(idx)
        self.rescale_events.append(
            {"step": None, "failed": list(silent),
             "missed_heartbeat": list(silent),
             "healthy": len(self.allocator.healthy)})
        self._emit("rescale", **self.rescale_events[-1])
        if self.on_rescale is not None:
            self.on_rescale(len(self.allocator.healthy))
        return silent

    def note_occupancy(self, t: float, busy: int, lanes: int,
                       pending: int) -> None:
        """Record one engine lane-occupancy sample (the time-series
        ``serve.py`` prints and the engine benchmarks aggregate into lane
        utilisation; snapshotted with the runtime for replay parity)."""
        self.occupancy_events.append(
            {"t": float(t), "busy": int(busy), "lanes": int(lanes),
             "pending": int(pending)})
        self._emit("occupancy", t=float(t), busy=int(busy), lanes=int(lanes),
                   pending=int(pending),
                   utilisation=float(busy) / lanes if lanes else 0.0)

    def note_stragglers(self, step: int, job_id: int, lanes: list[int],
                        makespan_before: float,
                        makespan_after: float) -> None:
        """Record one slot-boundary speculative re-issue (observability —
        the chaos bench asserts these fire under injected slowdowns)."""
        self.straggler_events.append(
            {"step": step, "job": job_id, "lanes": list(lanes),
             "makespan_before": float(makespan_before),
             "makespan_after": float(makespan_after)})
        self._emit("straggler", step=step, job=job_id, lanes=list(lanes),
                   makespan_before=float(makespan_before),
                   makespan_after=float(makespan_after))


def run_with_straggler_mitigation(
        lane_times: np.ndarray, monitor: StragglerMonitor,
        spares: int, reissue_times: np.ndarray | None = None,
        rng: np.random.Generator | None = None) -> dict:
    """Simulate one slot with speculative re-execution (first-finisher wins).

    lane_times: nominal per-lane completion times for the slot.
    Returns {makespan_before, makespan_after, reissued}."""
    lane_times = np.asarray(lane_times, dtype=np.float64)
    if reissue_times is None:
        rng = rng or np.random.default_rng(0)
        reissue_times = rng.permutation(lane_times)
    done = [False] * lane_times.size
    to_reissue = monitor.decide(lane_times, done, spares)
    after = lane_times.copy()
    if to_reissue:
        sel = np.asarray(to_reissue)
        after[sel] = monitor.simulate_reissue(
            lane_times[sel], np.asarray(reissue_times)[sel])
    return {"makespan_before": float(lane_times.max(initial=0.0)),
            "makespan_after": float(after.max(initial=0.0)),
            "reissued": to_reissue}


class HeartbeatMonitor:
    """Wall-clock heartbeat: a device (or host) missing ``timeout`` seconds
    of heartbeats is declared failed. Pure-python, injectable clock."""

    def __init__(self, num_devices: int, timeout: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.last_seen = [now] * num_devices

    def beat(self, device_index: int) -> None:
        self.last_seen[device_index] = self.clock()

    def dead(self) -> list[int]:
        now = self.clock()
        return [i for i, t in enumerate(self.last_seen)
                if now - t > self.timeout]


def admission_or_extend(allocator: DeviceAllocator, num_queries: int,
                        deadline: float, stats: RuntimeStats) -> float:
    """The paper's §III-A policy as one call: return a feasible deadline
    (possibly extended) for the current healthy capacity, or raise.

    ``Admission.feasible`` now reports feasibility at the *asked* deadline;
    an infeasible answer with ``extended=True`` carries the minimal restoring
    extension, which is exactly what this policy adopts."""
    adm = allocator.readmit(num_queries, deadline, stats)
    if not adm.feasible and not adm.extended:
        raise InfeasibleDeadline("no capacity at any deadline")
    return adm.deadline
