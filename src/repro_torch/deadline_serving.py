"""Deadline-driven serving fleet with failures and stragglers.

The paper's framework as the control plane of a serving fleet: D&A_REAL
sizes the allocation; a device failure triggers the Lemma-1 readmission
(extending the deadline per §III-A when capacity shrinks); a straggling
slot lane is speculatively re-issued using the paper's own fluctuation
statistics. The port of ``examples/deadline_serving.py``: the query times
are simulated, so it needs no card, and it prints what the JAX example
prints.

    PYTHONPATH=src python -m repro_torch.deadline_serving
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np

from .core import (DeviceAllocator, DnaResult, SimulatedTimeSource,
                   SlotExecution, StragglerMonitor, dna_real)
from .ft import run_with_straggler_mitigation

FLEET = 64                 # devices ("cores") in the fleet
SPARES_FRACTION = 0.05     # held back for re-issue
FAILED = 8                 # devices that die mid-run


def slot_lanes(execution: SlotExecution) -> tuple[list[int], np.ndarray]:
    """The query ids and measured per-query times of the executed slot
    whose slowest lane is the longest: one time per core, the unit the
    straggler threshold t_hat (2 - d) is in."""
    slots = [s for s in execution.plan.slots if s]
    if not slots:
        raise ValueError("no executed slot")
    slot = max(slots, key=lambda s: max(execution.per_query_times[q]
                                        for q in s))
    return list(slot), np.array([execution.per_query_times[q] for q in slot])


def survive(fleet: DeviceAllocator, res: DnaResult, num_queries: int,
            deadline: float, scaling_factor: float, lane_times: np.ndarray,
            reissue_times: np.ndarray | None = None,
            log: Callable[[str], None] = print) -> dict:
    """The loop after D&A_REAL's allocation: take ``res.cores`` devices of
    ``fleet``, lose the first ``FAILED`` of them and readmit half the
    queries in half the deadline, then re-issue the lanes of one slot
    (``lane_times``, one per allocated core) that pass the straggler
    threshold t_hat (2 - d) to the fleet's spares."""
    devices = fleet.allocate(res.cores)
    log(f"allocated devices: {devices[:5]}... ({len(devices)} total)")
    for idx in range(FAILED):
        fleet.mark_failed(idx)
    adm = fleet.readmit(num_queries_left=num_queries // 2,
                        deadline_left=deadline / 2, stats=res.sample_stats)
    log(f"after failure: {len(fleet.healthy)} healthy; readmission needs "
        f"{adm.cores} cores, deadline "
        f"{'EXTENDED to %.2fs' % adm.deadline if adm.extended else 'unchanged'}")
    mon = StragglerMonitor(t_hat=res.sample_stats.t_hat(),
                           scaling_factor=scaling_factor)
    out = run_with_straggler_mitigation(lane_times, mon, spares=fleet.spares,
                                        reissue_times=reissue_times)
    log(f"straggler mitigation: makespan {out['makespan_before']:.2f}s -> "
        f"{out['makespan_after']:.2f}s (re-issued lanes {out['reissued']})")
    return {"allocated": len(devices), "healthy": len(fleet.healthy),
            "readmit_cores": adm.cores, "readmit_deadline": adm.deadline,
            "extended": adm.extended, "feasible": adm.feasible,
            "straggler_threshold": mon.threshold, **out}


def run(log: Callable[[str], None] = print) -> dict:
    """The JAX example's scenario: 64 devices, serve steps of ~50 ms with a
    heavy tail, X = 2,000 queries by T = 6 s at d = 0.9; one pathological
    lane of 1 s among lanes of 50 ms."""
    fleet = DeviceAllocator(devices=list(range(FLEET)),
                            spares_fraction=SPARES_FRACTION)
    src = SimulatedTimeSource(mean=0.05, cv=0.4, seed=7)
    X, T, d = 2_000, 6.0, 0.9
    res = dna_real(X, T, lambda ids: src.measure(ids),
                   max_cores=fleet.capacity, sample_size=100,
                   preprocess_cores=8, scaling_factor=d)
    log(f"allocation: {res.cores} cores for X={X} T={T}s "
        f"(Lemma-2 says {res.bounds.lemma2_cores}; "
        f"-{res.reduction_vs_lemma2_pct:.0f}%)")
    lanes = np.full(res.cores, 0.05)
    lanes[3] = 1.0                               # pathological lane
    out = survive(fleet, res, X, T, d, lanes,
                  reissue_times=np.full(res.cores, 0.05), log=log)
    return {"cores": res.cores, "lemma2_cores": res.bounds.lemma2_cores,
            "reduction_vs_lemma2_pct": res.reduction_vs_lemma2_pct, **out}


if __name__ == "__main__":
    run()
