"""Chaos harness for the durable serving runtime (DESIGN.md §12).

Generalises :class:`repro_torch.ft.elastic.FailureInjector` to seeded schedules
of THREE fault kinds against a :class:`repro_torch.serving.ServingRuntime`:

* **device failures** — routed through ``inject_failures`` (shed + §III-A
  readmission);
* **lane slowdowns** — ``schedule_slowdowns`` multiplies executor times
  mid-flight, driving lanes over the straggler re-issue threshold;
* **process crashes** — the run is cut at arbitrary WAL positions
  (``run(max_events=...)`` returning None is the "kill -9"), abandoned,
  and recovered from the WAL directory by ``ServingRuntime.recover``.

Everything is derived from one integer seed, so a chaos scenario is as
replayable as the serving loop it torments — the property the crash-
anywhere test leans on: for EVERY event-prefix crash point, recovery must
finish the trace with ``JobRecord``s bit-identical to the uncrashed run.

This module deliberately imports nothing from ``repro_torch.serving`` at
module level (the serving runtime imports ``repro_torch.ft.elastic``;
keeping chaos dependency-free both ways lets either side grow without
cycles) — the runtime object arrives as an argument and recovery goes
through ``type(runtime).recover``.

A copy of ``repro.ft.chaos`` (host only).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np


@dataclass(frozen=True)
class ChaosSpec:
    """Declarative chaos scenario, parseable from a ``k=v,...`` CLI string.

    ``failures``/``slowdowns``/``crashes`` are event COUNTS; their times/
    positions are drawn from ``seed``. ``horizon`` bounds the virtual times
    faults fire at; ``crash_span`` bounds the event positions crashes cut
    at; ``slow_factor`` is the multiplicative lane slowdown (> 1 slows).
    """

    seed: int = 0
    failures: int = 0
    slowdowns: int = 0
    crashes: int = 0
    horizon: float = 20.0
    slow_factor: float = 2.0
    crash_span: int = 120

    def __post_init__(self) -> None:
        if min(self.failures, self.slowdowns, self.crashes) < 0:
            raise ValueError("fault counts must be >= 0")
        if self.horizon <= 0:
            raise ValueError("horizon must be > 0")
        if self.slow_factor <= 0:
            raise ValueError("slow_factor must be > 0")
        if self.crash_span < 2:
            raise ValueError("crash_span must be >= 2")

    @classmethod
    def parse(cls, spec: str) -> "ChaosSpec":
        """``"seed=7,failures=1,slowdowns=2,horizon=18"`` -> ChaosSpec."""
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"chaos spec entry {part!r} is not k=v")
            key, _, val = part.partition("=")
            key = key.strip()
            if key not in fields:
                raise ValueError(f"unknown chaos spec key {key!r} "
                                 f"(known: {sorted(fields)})")
            caster = float if key in ("horizon", "slow_factor") else int
            kwargs[key] = caster(val)
        return cls(**kwargs)


@dataclass(frozen=True)
class ChaosSchedule:
    """A spec realised against a concrete device count: absolute virtual
    times for failures/slowdowns, absolute event positions for crashes."""

    failures: tuple[tuple[float, tuple[int, ...]], ...]
    slowdowns: tuple[tuple[float, float], ...]
    crashes: tuple[int, ...]

    @classmethod
    def from_spec(cls, spec: ChaosSpec, num_devices: int) -> "ChaosSchedule":
        """Deterministic realisation: all draws come from ``spec.seed``.
        Times are rounded to 6 decimals so they survive any text round-trip
        unchanged (they also ride in WAL records)."""
        if num_devices < 1:
            raise ValueError("num_devices must be >= 1")
        rng = np.random.default_rng(spec.seed)
        fails = []
        for _ in range(spec.failures):
            t = round(float(rng.uniform(0.0, spec.horizon)), 6)
            dev = int(rng.integers(0, num_devices))
            fails.append((t, (dev,)))
        slows = [(round(float(rng.uniform(0.0, spec.horizon)), 6),
                  float(spec.slow_factor))
                 for _ in range(spec.slowdowns)]
        crashes = sorted({int(p) for p in
                          rng.integers(1, spec.crash_span,
                                       size=spec.crashes)})
        return cls(failures=tuple(sorted(fails)),
                   slowdowns=tuple(sorted(slows)),
                   crashes=tuple(crashes))

    def apply(self, runtime: Any) -> None:
        """Install the failure/slowdown schedules on a runtime (before
        ``run``). Crashes are NOT installed here — they are process deaths,
        driven externally by :func:`drive_with_crashes`."""
        if self.failures:
            sched: dict[float, list[int]] = {}
            for t, devs in self.failures:
                sched.setdefault(t, []).extend(devs)
            runtime.inject_failures(sched)
        if self.slowdowns:
            runtime.schedule_slowdowns(dict(self.slowdowns))


def drive_with_crashes(runtime: Any, wal_dir: str | Path,
                       executor_factory: Callable, crash_points: Any, *,
                       heartbeat: Any = None, fsync: bool = True,
                       on_recover: Callable[[Any, Any], None] | None = None
                       ) -> tuple[Any, list[Any], Any]:
    """Run a WAL-attached runtime to completion, "killing the process" at
    each absolute event position in ``crash_points`` and recovering from
    the WAL. Returns ``(report, recovery_infos, final_runtime)``.

    A crash is exactly what the runtime's durability contract defends
    against: the object is abandoned mid-run (its un-fsynced Python state
    lost) and a NEW runtime is rebuilt purely from the WAL directory via
    ``ServingRuntime.recover``. Crash points at or before a previous
    position (already passed) are skipped.
    """
    if getattr(runtime, "wal", None) is None:
        raise ValueError("runtime has no WAL attached — crashes would "
                         "lose accepted jobs, which is the bug this "
                         "harness exists to catch")
    infos: list[Any] = []
    for point in sorted({int(p) for p in crash_points}):
        step = point - runtime.events_processed
        if step <= 0:
            continue
        report = runtime.run(max_events=step)
        if report is not None:
            break                    # trace drained before this crash point
        runtime, info = type(runtime).recover(
            wal_dir, executor_factory, heartbeat=heartbeat, fsync=fsync)
        infos.append(info)
        if on_recover is not None:
            on_recover(runtime, info)
    return runtime.run(), infos, runtime
