"""PPR workload: graphs, FORA, the power-iteration oracle, executors."""

from .datasets import TABLE1, DatasetSpec, load, small_test_graph, synthesize
from .executor import ForaExecutor, PprWorkload
from .fora import (ForaParams, ForaResult, FusedForaResult, ResolvedFora,
                   default_walk_budget, fora, fora_fused)
from .forward_push import PushResult, forward_push, forward_push_np
from .graph import DeviceGraph, Graph, SlicedEll
from .power_iteration import ppr_power_iteration, ppr_single_pair
from .random_walk import (LaneDraws, LaneStreams, QueryDraws, TableDraws,
                          TableLaneStreams, WalkDraws, residual_walks,
                          sample_walk_starts, walk_endpoints,
                          walk_length_for_tail)

__all__ = [
    "TABLE1", "DatasetSpec", "DeviceGraph", "ForaExecutor", "ForaParams",
    "ForaResult", "FusedForaResult", "Graph", "LaneDraws", "LaneStreams",
    "PprWorkload", "PushResult", "QueryDraws", "ResolvedFora", "SlicedEll",
    "TableDraws", "TableLaneStreams", "WalkDraws",
    "default_walk_budget", "fora", "fora_fused", "forward_push",
    "forward_push_np", "load", "ppr_power_iteration", "ppr_single_pair",
    "residual_walks",
    "sample_walk_starts", "small_test_graph", "synthesize", "walk_endpoints",
    "walk_length_for_tail",
]
