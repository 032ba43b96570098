"""Fault tolerance: failure detection, elastic rescale, straggler re-issue
(``elastic``), and the serving runtime's chaos harness (``chaos``).

Copies of ``repro.ft.elastic`` and ``repro.ft.chaos`` (host numpy, no
device work).
"""

from .elastic import (ElasticController, FailureInjector, HeartbeatMonitor,
                      admission_or_extend, run_with_straggler_mitigation)

__all__ = ["ElasticController", "FailureInjector", "HeartbeatMonitor",
           "admission_or_extend", "run_with_straggler_mitigation"]
