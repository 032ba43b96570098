"""Slot assignment and execution (paper Alg. 1 Lines 4-7 / Alg. 2 Lines 7-10).

The paper's execution model: after preprocessing, the remaining X-s queries
are divided into ``ell`` slots of (up to) ``k`` queries each; within a slot
all k queries run in parallel on k cores; core ``j`` runs the j-th query of
every slot back-to-back, so its busy time is ``T_j = sum over slots of t``
and completion is ``T_max = max_j T_j`` (no inter-slot barrier).

``SlotPlan`` is the static assignment. Execution is incremental
(DESIGN.md §10): :class:`WorkQueues` holds pull-based per-core queues with
work stealing of the trailing slots, and :class:`SlotStepper` runs them one
slot at a time so a serving runtime can fold observed statistics and
re-grant cores *between* slots (``resize``). ``execute_plan`` drives a
stepper to completion and is bit-for-bit what the one-shot batch pipeline
always did — for a freshly dealt plan the queues are balanced, stealing
never fires, and the popped slots are exactly the plan's slots in order.

The executor is any callable mapping a list of query ids to their per-query
times — the same interface serves the JAX FORA engine, LM serve steps, and
simulated distributions.
"""

from __future__ import annotations

import math
from collections import deque
from collections.abc import Callable, Sequence
from dataclasses import dataclass
from itertools import zip_longest

import numpy as np

from .estimator import RuntimeStats

# executor(query_ids) -> per-query times, aligned with query_ids
Executor = Callable[[Sequence[int]], RuntimeStats]


@dataclass(frozen=True)
class SlotPlan:
    """Assignment of query ids to (slot, core) cells.

    ``slots[i]`` is the list of query ids in slot i (len <= k); the j-th
    entry of each slot belongs to core j.  Invariants (property-tested):
    every remaining query appears exactly once; no slot exceeds k; the
    number of slots is <= ell.
    """

    slots: tuple[tuple[int, ...], ...]
    k: int
    ell: int

    @property
    def num_queries(self) -> int:
        return sum(len(s) for s in self.slots)

    @property
    def cores_used(self) -> int:
        return max((len(s) for s in self.slots), default=0)

    def core_queue(self, j: int) -> list[int]:
        """Query ids processed by core j, in slot order."""
        if not 0 <= j < self.k:
            raise IndexError(f"core {j} out of range [0,{self.k})")
        return [s[j] for s in self.slots if j < len(s)]


def build_slot_plan(query_ids: Sequence[int], ell: int, k: int) -> SlotPlan:
    """Round-robin fill: slot i holds queries [i*k, (i+1)*k) of the sequence.

    Matches the paper's "assign k queries to each of the ell slots" with the
    trailing slot(s) possibly short (the ceiling-function remark in §III-A).
    """
    ids = list(query_ids)
    if ell < 1 or k < 1:
        raise ValueError(f"ell and k must be >= 1 (got ell={ell}, k={k})")
    if len(ids) > ell * k:
        raise ValueError(
            f"{len(ids)} queries do not fit ell*k = {ell}*{k} = {ell * k} cells")
    slots = tuple(tuple(ids[i * k:(i + 1) * k]) for i in range(ell) if ids[i * k:(i + 1) * k])
    return SlotPlan(slots=slots, k=k, ell=ell)


@dataclass(frozen=True)
class SlotExecution:
    """Result of running a SlotPlan: per-core busy totals and timing."""

    plan: SlotPlan
    core_totals: np.ndarray        # T_j, shape (k,), zero for idle cores
    per_query_times: dict[int, float]

    @property
    def t_max_core(self) -> float:
        """T_max = max_j T_j (Alg. 1 Line 7)."""
        return float(self.core_totals.max()) if self.core_totals.size else 0.0

    @property
    def slot_barrier_makespan(self) -> float:
        """Completion under a per-slot barrier (sum of slot maxima) —
        pessimistic alternative used by the straggler monitor."""
        total = 0.0
        for slot in self.plan.slots:
            total += max((self.per_query_times[q] for q in slot), default=0.0)
        return total


class WorkQueues:
    """Pull-based per-core work queues over the not-yet-executed queries.

    Queue ``j`` is core ``j``'s pending work in slot order. ``next_slot``
    first *steals*: while some queue is empty and another holds >= 2 pending
    queries, the tail of the longest queue (its trailing-slot work — the
    queries a static j-th-query assignment would leave to the stragglers)
    migrates to the idle core. A freshly dealt plan is balanced (lengths
    differ by at most one), so stealing never fires and the popped slots are
    exactly the static plan's slots; it becomes load-bearing after
    ``shrink``/``grow`` re-grants or externally unbalanced queues.

    Invariants (property-tested): every pending query appears exactly once
    across the queues, and after rebalancing no queue exceeds its grant
    ``ceil(remaining / width)``.
    """

    def __init__(self, queues: Sequence[Sequence[int]]):
        if not queues:
            raise ValueError("need at least one queue")
        self.queues: list[deque[int]] = [deque(q) for q in queues]

    @classmethod
    def from_plan(cls, plan: SlotPlan) -> "WorkQueues":
        return cls([plan.core_queue(j) for j in range(plan.k)])

    @property
    def width(self) -> int:
        return len(self.queues)

    @property
    def remaining(self) -> int:
        return sum(len(q) for q in self.queues)

    @property
    def grant_bound(self) -> int:
        """Max pending per core under a balanced deal: ceil(remaining/width)."""
        return -(-self.remaining // self.width)

    def pending(self) -> list[int]:
        """All pending queries, slot-major (the order a full drain pops)."""
        return [q for row in zip_longest(*self.queues)
                for q in row if q is not None]

    def steal(self) -> int:
        """Rebalance: move trailing work from the longest queues to idle (or
        nearly idle) ones until lengths differ by at most one. Returns the
        number of stolen queries."""
        moved = 0
        lens = [len(q) for q in self.queues]
        while max(lens) - min(lens) >= 2:
            src = lens.index(max(lens))
            dst = lens.index(min(lens))
            self.queues[dst].append(self.queues[src].pop())
            lens[src] -= 1
            lens[dst] += 1
            moved += 1
        return moved

    def next_slot(self) -> list[tuple[int, int]]:
        """Pop the next slot: ``[(core_index, qid), ...]`` — one query from
        the front of every non-empty queue, after stealing."""
        self.steal()
        return [(j, q.popleft())
                for j, q in enumerate(self.queues) if q]

    def discard(self, drop: "set[int] | frozenset[int]") -> int:
        """Remove pending queries in ``drop`` from every queue (the serving
        runtime's slot-boundary cache recheck: a query another job answered
        since admission needs no core time). Survivor order is preserved;
        returns the number of queries removed."""
        removed = 0
        for j, q in enumerate(self.queues):
            kept = [x for x in q if x not in drop]
            removed += len(q) - len(kept)
            if len(kept) != len(q):
                self.queues[j] = deque(kept)
        return removed

    def resize(self, width: int) -> None:
        """Re-grant to ``width`` cores. Shrinking merges the dropped (highest
        index) queues' pending work onto the survivors; growing appends empty
        queues — either way the next ``next_slot`` steal rebalances."""
        if width < 1:
            raise ValueError("width must be >= 1")
        if width < self.width:
            dropped = [q for q in self.queues[width:] if q]
            self.queues = self.queues[:width]
            for q in dropped:
                # append onto the currently shortest survivor, preserving the
                # dropped queue's own slot order
                dst = min(range(width), key=lambda j: len(self.queues[j]))
                self.queues[dst].extend(q)
        else:
            self.queues.extend(deque() for _ in range(width - self.width))


class SlotStepper:
    """Resumable slot-at-a-time execution of a slot plan (DESIGN.md §10).

    One ``step()`` = one executor call = one slot (a JAX executor batches it
    into a single device step). Between steps a caller may ``resize`` the
    grant; per-lane cumulative finish times keep the paper's no-barrier
    accounting (``makespan`` after a full static drive equals
    ``SlotExecution.t_max_core`` exactly). A lane granted mid-flight joins
    at the current makespan — it cannot retroactively absorb earlier work.
    """

    def __init__(self, plan: SlotPlan, executor: Executor):
        self.plan = plan
        self.executor = executor
        self.queues = WorkQueues.from_plan(plan)
        # physical per-lane arrays never shrink: a lane dropped by resize
        # keeps its recorded busy time (core_totals must still partition the
        # executed work), it just stops being dealt new queries
        self._busy = np.zeros(plan.k, dtype=np.float64)      # sum of t per lane
        self._finish = np.zeros(plan.k, dtype=np.float64)    # no-barrier finish
        self.per_query_times: dict[int, float] = {}
        self.executed_slots: list[tuple[int, ...]] = []
        self._makespan = 0.0
        self.steps = 0
        # optional slot-boundary mitigation hook: times -> effective times.
        # Speculative re-issue of straggling lanes on pool spares replaces a
        # lane's time with min(original, re-issue) — first-result-wins, and
        # answers are invariant because a re-issued chunk re-runs under the
        # same query-derived seed. None (or an unchanged return) leaves the
        # step bit-identical to the unhooked path.
        self.straggler: Callable[[np.ndarray], np.ndarray] | None = None

    @classmethod
    def from_queries(cls, query_ids: Sequence[int], ell: int, k: int,
                     executor: Executor) -> "SlotStepper":
        return cls(build_slot_plan(query_ids, ell, k), executor)

    # -- state -------------------------------------------------------------
    @property
    def k(self) -> int:
        return self.queues.width

    @property
    def remaining(self) -> int:
        return self.queues.remaining

    @property
    def done(self) -> bool:
        return self.remaining == 0

    @property
    def makespan(self) -> float:
        """Completion time of all executed work relative to the first slot's
        start — max over lanes of cumulative no-barrier finish (monotone
        across resizes)."""
        return self._makespan

    # -- execution ---------------------------------------------------------
    def step(self) -> RuntimeStats | None:
        """Execute the next slot; returns its stats (None when drained)."""
        cells = self.queues.next_slot()
        if not cells:
            return None
        slot = tuple(q for _, q in cells)
        stats = self.executor(slot)
        if stats.n != len(slot):
            raise ValueError(
                f"executor returned {stats.n} times for {len(slot)} queries")
        if self.straggler is not None:
            eff = np.asarray(self.straggler(stats.times.copy()),
                             dtype=np.float64)
            if eff.shape != stats.times.shape:
                raise ValueError("straggler hook must preserve lane count")
            if not np.array_equal(eff, stats.times):
                stats = RuntimeStats(times=eff)
        for (lane, qid), t in zip(cells, stats.times):
            self._busy[lane] += t
            self._finish[lane] += t
            self.per_query_times[qid] = float(t)
        active = [lane for lane, _ in cells]
        self._makespan = max(self._makespan, float(self._finish[active].max()))
        self.executed_slots.append(slot)
        self.steps += 1
        return stats

    def discard(self, drop: "set[int] | frozenset[int]") -> int:
        """Drop pending queries answered elsewhere (cache hits) between
        slots; they never execute and never enter the timing accounts."""
        return self.queues.discard(drop)

    def resize(self, k: int) -> None:
        """Re-grant to ``k`` lanes between slots. Shrinking drops the highest
        lanes (their pending work is merged and re-stolen; their recorded
        busy time stays — totals must keep partitioning the executed work);
        growing adds or re-activates lanes joining at the current makespan
        (a lane cannot retroactively have been working)."""
        old = self.k
        self.queues.resize(k)
        if k > old:
            if k > self._busy.size:
                pad = k - self._busy.size
                self._busy = np.concatenate([self._busy, np.zeros(pad)])
                self._finish = np.concatenate([self._finish, np.zeros(pad)])
            # lanes entering service (fresh or re-granted) start at "now"
            self._finish[old:k] = self._makespan

    # -- durability ----------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything but the executor and the straggler hook (both are
        runtime wiring the recovery path re-attaches)."""
        return {
            "plan": {"slots": [list(s) for s in self.plan.slots],
                     "k": self.plan.k, "ell": self.plan.ell},
            "queues": [list(q) for q in self.queues.queues],
            "busy": self._busy,
            "finish": self._finish,
            "per_query_times": [[qid, t]
                                for qid, t in self.per_query_times.items()],
            "executed_slots": [list(s) for s in self.executed_slots],
            "makespan": self._makespan,
            "steps": self.steps,
        }

    @classmethod
    def from_state(cls, state: dict, executor: Executor) -> "SlotStepper":
        plan = SlotPlan(slots=tuple(tuple(int(q) for q in s)
                                    for s in state["plan"]["slots"]),
                        k=int(state["plan"]["k"]),
                        ell=int(state["plan"]["ell"]))
        self = cls.__new__(cls)
        self.plan = plan
        self.executor = executor
        self.queues = WorkQueues.__new__(WorkQueues)
        self.queues.queues = [deque(int(q) for q in qs)
                              for qs in state["queues"]]
        self._busy = np.asarray(state["busy"], dtype=np.float64).copy()
        self._finish = np.asarray(state["finish"], dtype=np.float64).copy()
        self.per_query_times = {int(qid): float(t)
                                for qid, t in state["per_query_times"]}
        self.executed_slots = [tuple(int(q) for q in s)
                               for s in state["executed_slots"]]
        self._makespan = float(state["makespan"])
        self.steps = int(state["steps"])
        self.straggler = None
        return self

    def result(self) -> SlotExecution:
        """The realized execution. For an un-resized static drive this is
        bit-for-bit ``execute_plan``'s result (same plan object, same totals
        accumulation order)."""
        realized = self.plan
        if self.executed_slots != list(self.plan.slots) or self.k != self.plan.k:
            realized = SlotPlan(slots=tuple(self.executed_slots),
                                k=max(self.plan.k, len(self._busy)),
                                ell=max(self.plan.ell, len(self.executed_slots)))
        totals = self._busy
        if totals.size < realized.k:
            totals = np.concatenate(
                [totals, np.zeros(realized.k - totals.size)])
        return SlotExecution(plan=realized, core_totals=totals,
                             per_query_times=dict(self.per_query_times))


def execute_plan(plan: SlotPlan, executor: Executor) -> SlotExecution:
    """Run every slot through the executor and accumulate per-core totals.

    Execution is slot-at-a-time (the paper's "process all k queries in each
    slot in parallel"): one executor call per slot, so a JAX executor can
    batch the whole slot into a single device step. This is a
    :class:`SlotStepper` driven to completion without re-granting — the
    one-shot batch pipeline (``dna``/``dna_real``) is the ``resize``-free
    special case of the incremental path.
    """
    stepper = SlotStepper(plan, executor)
    while stepper.step() is not None:
        pass
    return stepper.result()


def num_slots(deadline_remaining: float, per_slot_time: float) -> int:
    """ell = floor(remaining / per_slot_time)  (Alg. 1 Line 4 / Alg. 2 Line 7)."""
    if per_slot_time <= 0:
        raise ValueError("per-slot time must be > 0")
    return int(math.floor(deadline_remaining / per_slot_time))


def queries_per_slot(remaining_queries: int, ell: int) -> int:
    """k = ceil((X - s) / ell)  (Alg. 1 Line 5 / Alg. 2 Line 8)."""
    if remaining_queries < 0:
        raise ValueError("remaining queries must be >= 0")
    if ell < 1:
        raise ValueError("ell must be >= 1")
    return max(1, math.ceil(remaining_queries / ell))
