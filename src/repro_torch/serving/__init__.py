"""Serving: the online D&A runtime and the continuous-batching engine.

    CorePool                         shared devices x lanes core pool
    LaneLedger                       lane-second admission ledger
    Job, JobRecord, JobState         deadline-tagged requests + outcomes
    ServingConfig, ServingReport     loop knobs / aggregate results
    ServingRuntime                   the continuous-arrivals event loop
    SimJobExecutor                   seeded simulated per-job executor
    SimLaneEngine, LaneTask          virtual-time lane pool (engine mode)
    run_single_job                   one-shot path (dna_real, bit-for-bit)
    WriteAheadLog, RecoveryInfo      durable serving state
    MetricsSink, open_sink, ...      structured metrics sinks
    QueryEngine, HarvestedQuery      the lane pool on the card (engine.py)

The event-loop modules are host code (numpy and the standard library); the
runtime's executors, ``ForaExecutor`` on the card, do the device work.
``python -m repro_torch.launch.serve --daemon`` assembles them.
"""

from .engine import HarvestedQuery, QueryEngine
from .job import Job, JobRecord, JobState
from .lanes import LaneTask, SimLaneEngine
from .metrics import (JsonlSink, MetricsSink, NullSink, StdoutSink,
                      open_sink)
from .pool import CorePool, LaneLedger
from .runtime import (ServingConfig, ServingReport, ServingRuntime,
                      SimJobExecutor, run_single_job)
from .wal import RecoveryInfo, WriteAheadLog

__all__ = [
    "CorePool", "HarvestedQuery", "Job", "JobRecord", "JobState",
    "JsonlSink", "LaneLedger", "LaneTask", "MetricsSink", "NullSink",
    "QueryEngine", "RecoveryInfo", "ServingConfig", "ServingReport",
    "ServingRuntime", "SimJobExecutor", "SimLaneEngine", "StdoutSink",
    "WriteAheadLog", "open_sink", "run_single_job",
]
