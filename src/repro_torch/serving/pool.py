"""Shared core pool for the online serving runtime (DESIGN.md §10).

The one-shot pipeline grants each job its own simulated core count; a
serving runtime must instead carve concurrent jobs' grants out of ONE
machine. ``CorePool`` is that machine: ``devices x lanes_per_device`` cores
(the :func:`repro_torch.core.plan_core_mesh` arithmetic), with the device side
tracked by a :class:`repro_torch.core.DeviceAllocator` so failures marked by the
elastic controller shrink the pool capacity live.

Grants are integer core counts keyed by job id. The pool never blocks —
``acquire``/``grow`` return what could actually be granted and the runtime
replans around the answer. A failure can leave the pool *overcommitted*
(``used > total``); ``shed_plan`` names the per-job grant cuts that restore
feasibility, largest grants first, and the runtime readmits those jobs.

A copy of ``repro.serving.pool`` (host only).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.allocator import DeviceAllocator, MeshPlan, plan_core_mesh


@dataclass
class CorePool:
    """Devices x lanes of grantable cores shared by all in-flight jobs.

    Besides slot ``grants``, the pool carries short-lived *reservations* —
    the ``c`` preprocessing cores a job occupies while its sample runs
    (ROADMAP follow-up: those cores used to be assumed free). Reservations
    reduce ``free`` like grants do but live outside the shed arithmetic:
    they span one preprocessing window and are released by the runtime's
    ``pre_release`` event, so a failure mid-window at worst overcommits by
    ``c`` for that window.
    """

    allocator: DeviceAllocator
    lanes_per_device: int = 1
    grants: dict[int, int] = field(default_factory=dict)
    reservations: dict[int, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.lanes_per_device < 1:
            raise ValueError("lanes_per_device must be >= 1")

    @classmethod
    def of(cls, num_devices: int, lanes_per_device: int = 1,
           spares_fraction: float = 0.0) -> "CorePool":
        return cls(DeviceAllocator(devices=list(range(num_devices)),
                                   spares_fraction=spares_fraction),
                   lanes_per_device=lanes_per_device)

    # -- capacity ----------------------------------------------------------
    @property
    def total(self) -> int:
        """Grantable cores on the current healthy device set."""
        return self.allocator.capacity * self.lanes_per_device

    @property
    def used(self) -> int:
        return sum(self.grants.values())

    @property
    def reserved(self) -> int:
        """Cores held by preprocessing reservations (transient)."""
        return sum(self.reservations.values())

    @property
    def free(self) -> int:
        return max(0, self.total - self.used - self.reserved)

    @property
    def overcommit(self) -> int:
        """Cores granted beyond capacity (non-zero only after failures)."""
        return max(0, self.used - self.total)

    def grant_of(self, job_id: int) -> int:
        return self.grants.get(job_id, 0)

    def reserved_of(self, job_id: int) -> int:
        return self.reservations.get(job_id, 0)

    # -- preprocessing reservations ----------------------------------------
    def reserve(self, job_id: int, cores: int) -> bool:
        """Hold ``cores`` for a job's preprocessing window (Alg. 2 Line 1's
        ``c`` cores, billed against the pool instead of assumed free).
        All-or-nothing like :meth:`acquire`; released via :meth:`unreserve`
        when the slot phase starts (or the job terminates)."""
        if cores < 1:
            raise ValueError("cores must be >= 1")
        if job_id in self.reservations:
            raise ValueError(f"job {job_id} already holds a reservation")
        if cores > self.free:
            return False
        self.reservations[job_id] = cores
        return True

    def unreserve(self, job_id: int) -> int:
        """Return a job's preprocessing reservation to the pool."""
        return self.reservations.pop(job_id, 0)

    # -- grant lifecycle ---------------------------------------------------
    def acquire(self, job_id: int, cores: int) -> bool:
        """All-or-nothing initial grant (Lemma-1 admission decides ``cores``;
        a partial grant is a different plan, so the runtime asks again)."""
        if cores < 1:
            raise ValueError("cores must be >= 1")
        if job_id in self.grants:
            raise ValueError(f"job {job_id} already holds a grant")
        if cores > self.free:
            return False
        self.grants[job_id] = cores
        return True

    def grow(self, job_id: int, cores: int) -> int:
        """Best-effort grant increase; returns the cores actually added."""
        if cores < 0:
            raise ValueError("cores must be >= 0")
        add = min(cores, self.free)
        if add:
            self.grants[job_id] = self.grants.get(job_id, 0) + add
        return add

    def shrink(self, job_id: int, cores: int) -> int:
        """Release ``cores`` of a job's grant back to the pool (clamped so at
        least one core remains); returns the cores actually released."""
        held = self.grants.get(job_id, 0)
        give = max(0, min(cores, held - 1))
        if give:
            self.grants[job_id] = held - give
        return give

    def release(self, job_id: int) -> int:
        """Return a job's whole grant (completion/rejection)."""
        return self.grants.pop(job_id, 0)

    # -- failure handling --------------------------------------------------
    def fail_device(self, device_index: int) -> None:
        self.allocator.mark_failed(device_index)

    def shed_plan(self) -> dict[int, int]:
        """Per-job grant cuts restoring ``used <= total`` after a failure.

        Cuts come off the largest grants first (they have the most slack in
        the D&A arithmetic: halving a large k inflates ell the least), one
        core at a time, never below one core. Returns {job_id: cores_to_cut};
        the runtime applies each cut via :meth:`shrink` + stepper resize and
        re-runs admission for the job.
        """
        over = self.overcommit
        cuts: dict[int, int] = {}
        if not over:
            return cuts
        held = dict(self.grants)
        while over > 0:
            victim = max(held, key=lambda j: (held[j], j), default=None)
            if victim is None or held[victim] <= 1:
                break                      # nothing left to cut
            held[victim] -= 1
            cuts[victim] = cuts.get(victim, 0) + 1
            over -= 1
        return cuts

    # -- hardware mapping --------------------------------------------------
    def mesh_plan(self, cores: int) -> MeshPlan:
        """Map a grant onto the healthy device set (cores = devices x lanes)."""
        return plan_core_mesh(cores, self.allocator.capacity,
                              max_lanes_per_device=self.lanes_per_device)


@dataclass
class LaneLedger:
    """Lane-second admission ledger for engine mode (DESIGN.md §14).

    The engine path never holds slot grants: lanes are a shared continuous
    resource and a job's claim on them is its *committed lane-seconds* —
    the per-query durations it reserved at admission, consumed as queries
    complete. Admission checks that outstanding commitments plus the new
    job's work fit inside ``lanes * T_rel``; the ledger is the running left
    side of that inequality. Pure accounting (the :class:`SimLaneEngine`
    owns actual occupancy); snapshotted with the runtime so engine-mode
    recovery replays the same admission decisions.
    """

    committed: dict[int, float] = field(default_factory=dict)

    @property
    def outstanding(self) -> float:
        """Total reserved-but-unconsumed lane-seconds across jobs."""
        return sum(self.committed.values())

    def reserve(self, job_id: int, lane_seconds: float) -> None:
        if lane_seconds < 0:
            raise ValueError("lane_seconds must be >= 0")
        self.committed[job_id] = (self.committed.get(job_id, 0.0)
                                  + float(lane_seconds))

    def consume(self, job_id: int, lane_seconds: float) -> None:
        """Burn down a job's commitment as one of its queries completes
        (clamped at zero — degraded queries may finish under estimate)."""
        held = self.committed.get(job_id)
        if held is None:
            return
        left = held - float(lane_seconds)
        if left <= 1e-12:
            self.committed.pop(job_id)
        else:
            self.committed[job_id] = left

    def release(self, job_id: int) -> float:
        """Drop a job's whole remaining commitment (completion/rejection)."""
        return self.committed.pop(job_id, 0.0)

    # -- snapshots ---------------------------------------------------------
    def state_dict(self) -> dict:
        return {"committed": [[j, v] for j, v
                              in sorted(self.committed.items())]}

    @classmethod
    def from_state(cls, state: dict) -> "LaneLedger":
        led = cls()
        led.committed = {int(j): float(v) for j, v in state["committed"]}
        return led
