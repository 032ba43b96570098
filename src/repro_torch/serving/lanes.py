"""Virtual-time lane pool for the serving runtime's engine mode.

:class:`SimLaneEngine` is the scheduling twin of the device engine
:class:`repro_torch.serving.engine.QueryEngine`: the same fixed lane pool
and insert/evict lifecycle, but over the runtime's virtual clock. Per-query
durations come from the job's executor at admission, and an EDF ready
queue decides which admitted query takes the next free lane. Host-only (no
torch): a runtime and its write-ahead-log recovery import it without the
device stack. All state round-trips through snapshots
(``state_dict``/``from_state``), so engine-mode recovery replays bit for
bit. A copy of ``repro.serving.lanes``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

__all__ = ["LaneTask", "SimLaneEngine"]


@dataclass
class LaneTask:
    """One in-flight query on a virtual lane."""

    qid: int
    job_id: int
    t_start: float
    t_end: float
    work: float                # lane-seconds this query consumes


class SimLaneEngine:
    """Deterministic virtual-time lane pool: the EDF ready queue plus
    per-lane occupancy the serving runtime's engine mode schedules with.
    Pure data structure — the runtime owns the event clock and the WAL; all
    state here round-trips through snapshots (``state_dict``/``from_state``)
    so engine-mode recovery replays bit-identically."""

    def __init__(self, lanes: int):
        if lanes < 1:
            raise ValueError("lane pool must be >= 1")
        self.lanes = int(lanes)
        self.occupant: dict[int, LaneTask] = {}
        # EDF: (abs_deadline, job_id, qid, duration) — deterministic
        # tiebreak by job then qid
        self.ready: list[tuple[float, int, int, float]] = []
        self.last_job: dict[int, int] = {}

    @property
    def busy(self) -> int:
        return len(self.occupant)

    def pending(self) -> int:
        return len(self.ready)

    def pending_of(self, job_id: int) -> int:
        return sum(1 for e in self.ready if e[1] == job_id)

    def enqueue(self, deadline: float, job_id: int, qid: int,
                duration: float) -> None:
        heapq.heappush(self.ready, (float(deadline), int(job_id), int(qid),
                                    float(duration)))

    def pop_ready(self) -> tuple[float, int, int, float] | None:
        if not self.ready:
            return None
        return heapq.heappop(self.ready)

    def free_lane(self, cap: int | None = None) -> int | None:
        """Lowest free lane index below ``cap`` (capacity after failures /
        preprocessing reservations), or None."""
        cap = self.lanes if cap is None else min(cap, self.lanes)
        for lane in range(cap):
            if lane not in self.occupant:
                return lane
        return None

    def occupy(self, lane: int, qid: int, job_id: int, now: float,
               t_end: float, work: float) -> bool:
        """Place a query on a lane; returns True when the lane changed
        hands between jobs (a rebalance — logged by the runtime)."""
        if lane in self.occupant:
            raise RuntimeError(f"lane {lane} is occupied")
        self.occupant[lane] = LaneTask(qid=qid, job_id=job_id, t_start=now,
                                       t_end=t_end, work=work)
        rebalanced = self.last_job.get(lane, job_id) != job_id
        self.last_job[lane] = job_id
        return rebalanced

    def release(self, lane: int) -> LaneTask:
        return self.occupant.pop(lane)

    def resize(self, lanes: int) -> None:
        """Shrink/grow the pool (device failures / spares promotion).
        In-flight lanes above the new capacity drain normally and then
        retire — lanes are logical, so no work is lost."""
        self.lanes = max(1, int(lanes))

    # -- snapshots ---------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "lanes": self.lanes,
            "ready": [list(e) for e in sorted(self.ready)],
            "occupant": [[lane, t.qid, t.job_id, t.t_start, t.t_end, t.work]
                         for lane, t in sorted(self.occupant.items())],
            "last_job": [[lane, job] for lane, job
                         in sorted(self.last_job.items())],
        }

    @classmethod
    def from_state(cls, state: dict) -> "SimLaneEngine":
        eng = cls(int(state["lanes"]))
        eng.ready = [(float(d), int(j), int(q), float(w))
                     for d, j, q, w in state["ready"]]
        heapq.heapify(eng.ready)
        eng.occupant = {int(lane): LaneTask(qid=int(q), job_id=int(j),
                                            t_start=float(t0),
                                            t_end=float(t1), work=float(w))
                        for lane, q, j, t0, t1, w in state["occupant"]}
        eng.last_job = {int(lane): int(j) for lane, j in state["last_job"]}
        return eng
