"""Helpers of the serving parity tests: the same seeded scenario driven
through ``repro.serving`` and ``repro_torch.serving``, and the outcomes in
a form that compares across the two packages' classes."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import repro.core as jcore
import repro.ft.chaos as jchaos
import repro.ft.elastic as jelastic
import repro.index as jindex
import repro.serving as jserving
import repro.serving.wal as jwal
import repro_torch.core as tcore
import repro_torch.ft.chaos as tchaos
import repro_torch.ft.elastic as telastic
import repro_torch.index as tindex
import repro_torch.serving as tserving
import repro_torch.serving.wal as twal

JAX = SimpleNamespace(name="jax", core=jcore, serving=jserving,
                      index=jindex, chaos=jchaos, wal=jwal,
                      ft_elastic=jelastic)
TORCH = SimpleNamespace(name="torch", core=tcore, serving=tserving,
                        index=tindex, chaos=tchaos, wal=twal,
                        ft_elastic=telastic)
PACKAGES = (JAX, TORCH)


def sim_factory(pkg, mean: float = 0.05, cv: float = 0.3):
    return lambda job_id, nq, sd: pkg.serving.SimJobExecutor(
        mean=mean, cv=cv, seed=sd)


def records(report) -> list[tuple]:
    """A report's ``JobRecord``s as plain tuples (field order is shared)."""
    return [dataclasses.astuple(r) for r in report.records]


def outcome(rt, report) -> dict:
    """Everything a parity test holds equal: records, summary, job logs,
    controller events and the pool's end state."""
    c = rt.controller
    return {"records": records(report), "summary": report.summary(),
            "end": report.end_time,
            "logs": [list(j.log) for j in rt.jobs],
            "rescale": list(c.rescale_events),
            "straggler": list(c.straggler_events),
            "occupancy": list(c.occupancy_events),
            "pool": (rt.pool.total, rt.pool.used, rt.pool.reserved,
                     sorted(rt.pool.grants.items()))}
