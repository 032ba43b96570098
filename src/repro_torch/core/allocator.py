"""Device allocation, elastic rescaling and straggler mitigation.

This is the layer that turns the paper's abstract "cores" into devices (ids
or ``torch.device``s: the allocator only counts them). At 1000+ node scale
the interesting events are failures and stragglers; both are handled with
the paper's own statistics:

* **Admission / elastic rescale** — on any change in the healthy device set,
  re-run the Lemma-1 admission check (Alg. 2 Lines 3-5). If the surviving
  count is below the bound, extend the deadline (the paper's §III-A "prolong
  the duration" rule) by exactly the factor that restores feasibility.
* **Straggler detection** — a slot lane whose running query exceeds
  ``t_hat * (2 - d)`` is presumed straggling (d<1 already encodes observed
  fluctuation; the margin widens as d shrinks) and its query is re-issued to
  a spare device; first finisher wins. This is speculative re-execution in
  the MapReduce sense, driven by the paper's own fluctuation statistics.

A copy of ``repro.core.allocator``, numpy only.
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .bounds import (InfeasibleDeadline, lemma1_lower_bound,
                     minimal_feasible_deadline, required_cores)
from .estimator import RuntimeStats


@dataclass
class DeviceAllocator:
    """Tracks healthy devices and hands out slices for slot execution.

    ``devices`` may be ``torch.device`` objects or plain ids — the
    allocator is deliberately agnostic so it can be unit-tested without a
    card and reused wherever devices are counted.
    """

    devices: list[Any]
    failed: set[int] = field(default_factory=set)       # indices into devices
    spares_fraction: float = 0.02                        # held back for re-issue

    def __post_init__(self) -> None:
        if not self.devices:
            raise ValueError("need at least one device")

    # -- capacity ----------------------------------------------------------
    @property
    def healthy(self) -> list[Any]:
        return [d for i, d in enumerate(self.devices) if i not in self.failed]

    @property
    def capacity(self) -> int:
        """Allocatable device count (healthy minus reserved spares)."""
        n = len(self.healthy)
        spares = math.floor(n * self.spares_fraction)
        return max(1, n - spares)

    @property
    def spares(self) -> int:
        return len(self.healthy) - self.capacity

    # -- allocation --------------------------------------------------------
    def allocate(self, k: int) -> list[Any]:
        """A slice of k healthy devices (deterministic order for mesh reuse)."""
        if k < 1:
            raise ValueError("k must be >= 1")
        healthy = self.healthy
        if k > self.capacity:
            raise InfeasibleDeadline(
                f"requested {k} devices, capacity is {self.capacity} "
                f"({len(healthy)} healthy, {self.spares} spares)")
        return healthy[:k]

    def mesh_plan(self, cores: int, *,
                  max_lanes_per_device: int | None = None) -> MeshPlan:
        """Map a D&A core count onto this allocator's healthy capacity
        (cores = devices x lanes, :func:`plan_core_mesh`); pair with
        ``allocate(plan.devices)`` for the actual device slice."""
        return plan_core_mesh(cores, self.capacity,
                              max_lanes_per_device=max_lanes_per_device)

    # -- failure handling ---------------------------------------------------
    def mark_failed(self, device_index: int) -> None:
        if not 0 <= device_index < len(self.devices):
            raise IndexError(device_index)
        self.failed.add(device_index)

    def readmit(self, num_queries_left: int, deadline_left: float,
                stats: RuntimeStats, *,
                cores_per_device: int = 1,
                cost_model: Any = None) -> "Admission":
        """Re-run the Lemma-1 admission over the *remaining* work after a
        failure, through the shared :func:`lemma1_lower_bound` (which also
        rejects ``t_max > T`` and non-positive deadlines — the cases a raw
        ``X*t_max/T`` ratio silently mis-scores). ``feasible`` is honest: it
        reports whether the work fits *at the deadline that was asked*; when
        it does not, the minimal extension restoring feasibility (paper
        §III-A "prolong the duration") is returned with ``extended=True``
        instead of failing the job.

        ``cores_per_device`` converts the device-denominated capacity into
        D&A cores when each device multiplexes several query lanes (the
        serving runtime's ``CorePool`` passes its ``lanes_per_device``).

        ``cost_model`` (a :class:`~.estimator.CacheAwareCostModel`)
        discounts the estimate for cache-aware serving (DESIGN.md §11): the
        pending count shrinks by the learned expected-miss fraction and the
        time statistics by the index-served walk share — both exactly 1.0
        for a cold model, so admission without observations is unchanged."""
        if cores_per_device < 1:
            raise ValueError("cores_per_device must be >= 1")
        capacity = self.capacity * cores_per_device
        if cost_model is not None and num_queries_left > 0:
            num_queries_left = cost_model.discounted_queries(num_queries_left)
            stats = cost_model.discounted_stats(stats)
        if num_queries_left <= 0:
            return Admission(feasible=True, cores=0, deadline=deadline_left,
                             extended=False)
        try:
            bound = lemma1_lower_bound(num_queries_left, stats.t_max,
                                       deadline_left)
        except ValueError:   # t_max > T (InfeasibleDeadline) or T <= 0
            bound = None
        if bound is not None:
            need = required_cores(bound)
            if need <= capacity:
                return Admission(feasible=True, cores=need,
                                 deadline=deadline_left, extended=False)
        # The t_max clamp in the minimal extension can leave slack, so
        # re-derive the core need at T' rather than assuming full capacity.
        new_deadline = minimal_feasible_deadline(num_queries_left,
                                                 stats.t_max, capacity)
        cores = required_cores(
            num_queries_left * stats.t_max / new_deadline)
        return Admission(feasible=False, cores=cores,
                         deadline=new_deadline, extended=True)


@dataclass(frozen=True)
class MeshPlan:
    """A D&A core count mapped onto real hardware: cores = devices x lanes.

    The paper's abstract "k cores" become a mesh of ``devices`` chips, each
    running ``lanes`` parallel query lanes (extra lanes are per-device query
    batching). Devices are maximised first — real parallel
    silicon — then ``lanes = ceil(cores / devices)`` absorbs the rest, so
    ``cores_granted >= cores`` with at most ``devices - 1`` cores of
    rounding slack (a narrower rectangle may exist, but would idle chips).
    """

    cores: int            # k the allocator asked for
    devices: int          # mesh devices granted
    lanes: int            # parallel query lanes per device

    @property
    def cores_granted(self) -> int:
        return self.devices * self.lanes

    def __str__(self) -> str:
        return (f"{self.devices} device(s) x {self.lanes} lane(s) = "
                f"{self.cores_granted} cores (asked {self.cores})")


def plan_core_mesh(cores: int, num_devices: int, *,
                   max_lanes_per_device: int | None = None) -> MeshPlan:
    """Map a D&A core count onto a device mesh shape.

    ``devices = min(cores, num_devices)``; ``lanes = ceil(cores / devices)``.
    With ``max_lanes_per_device`` set, a demand that cannot fit
    ``num_devices * max_lanes_per_device`` raises :class:`InfeasibleDeadline`
    (the hardware analogue of Alg. 2's ``C_max`` admission check); ``None``
    leaves lanes uncapped — lanes time-multiplex a device, they are slower
    cores, not absent ones.
    """
    if cores < 1:
        raise ValueError("cores must be >= 1")
    if num_devices < 1:
        raise ValueError("num_devices must be >= 1")
    if max_lanes_per_device is not None:
        if max_lanes_per_device < 1:
            raise ValueError("max_lanes_per_device must be >= 1")
        if cores > num_devices * max_lanes_per_device:
            raise InfeasibleDeadline(
                f"cores={cores} exceed mesh capacity "
                f"{num_devices} devices x {max_lanes_per_device} lanes")
    devices = min(cores, num_devices)
    lanes = math.ceil(cores / devices)
    return MeshPlan(cores=cores, devices=devices, lanes=lanes)


@dataclass(frozen=True)
class Admission:
    """Outcome of a Lemma-1 readmission check. ``feasible`` refers to the
    deadline the caller asked about; an infeasible answer still carries the
    minimal extended deadline (``extended=True``) that would restore
    feasibility at the current capacity."""

    feasible: bool
    cores: int
    deadline: float
    extended: bool


@dataclass
class StragglerMonitor:
    """Deadline-derived speculative re-execution policy.

    A lane is straggling once its elapsed time passes
    ``threshold = t_hat * (2 - d)``; ``decide`` returns the lane indices to
    re-issue. Re-issue count is capped by available spares.
    """

    t_hat: float
    scaling_factor: float = 1.0
    max_reissue: int = 1 << 30

    def __post_init__(self) -> None:
        if self.t_hat <= 0:
            raise ValueError("t_hat must be > 0")
        if not 0.0 < self.scaling_factor <= 1.0:
            raise ValueError("scaling factor in (0,1]")

    @property
    def threshold(self) -> float:
        return self.t_hat * (2.0 - self.scaling_factor)

    def decide(self, elapsed: Sequence[float], done: Sequence[bool],
               spares: int) -> list[int]:
        """Lanes to re-issue, slowest first, at most ``spares``."""
        spares = min(spares, self.max_reissue)
        if spares <= 0:
            return []
        cand = [(e, i) for i, (e, d) in enumerate(zip(elapsed, done))
                if not d and e > self.threshold]
        cand.sort(reverse=True)
        return [i for _, i in cand[:spares]]

    def simulate_reissue(self, lane_times: np.ndarray,
                         reissue_times: np.ndarray) -> np.ndarray:
        """First-finisher-wins completion times for re-issued lanes: the
        original lane finishes at t_orig; the copy, launched at threshold,
        finishes at threshold + t_new. Used by the FT tests."""
        lane_times = np.asarray(lane_times, dtype=np.float64)
        reissue_times = np.asarray(reissue_times, dtype=np.float64)
        if lane_times.shape != reissue_times.shape:
            raise ValueError("shape mismatch")
        return np.minimum(lane_times, self.threshold + reissue_times)
