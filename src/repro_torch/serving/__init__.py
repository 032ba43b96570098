"""Serving: the continuous-batching query engine and its lane pool.

    QueryEngine, HarvestedQuery      the lane pool on the card (engine.py)
    SimLaneEngine, LaneTask          its virtual-time twin (lanes.py)

The rest of ``repro.serving`` (runtime, core pool and lane ledger, jobs,
write-ahead log, metrics) is not ported yet.
"""

from .engine import HarvestedQuery, QueryEngine
from .lanes import LaneTask, SimLaneEngine

__all__ = ["HarvestedQuery", "LaneTask", "QueryEngine", "SimLaneEngine"]
