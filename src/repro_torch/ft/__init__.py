"""Fault tolerance: failure detection, elastic rescale, straggler re-issue.

A copy of ``repro.ft.elastic`` (host numpy, no device work).
"""

from .elastic import (ElasticController, FailureInjector, HeartbeatMonitor,
                      admission_or_extend, run_with_straggler_mitigation)

__all__ = ["ElasticController", "FailureInjector", "HeartbeatMonitor",
           "admission_or_extend", "run_with_straggler_mitigation"]
