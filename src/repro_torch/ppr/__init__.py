"""PPR workload: graphs, FORA, the power-iteration oracle, executors."""

from .datasets import TABLE1, DatasetSpec, load, small_test_graph, synthesize
from .executor import ForaExecutor, PprWorkload
from .fora import (ForaParams, ForaResult, FusedForaResult, ResolvedFora,
                   default_walk_budget, fora, fora_fused)
from .forward_push import (PushResult, forward_push, forward_push_np,
                           forward_push_sharded)
from .graph import (DeviceGraph, DeviceMesh, Graph, ShardedDeviceGraph,
                    SlicedEll)
from .montecarlo import monte_carlo_ppr
from .power_iteration import ppr_power_iteration, ppr_single_pair
from .random_walk import (LaneDraws, LaneStreams, QueryDraws, SourceDraws,
                          SourceGenerators, TableDraws, TableLaneStreams,
                          TableSourceDraws, WalkDraws, WalkResult,
                          residual_walks, residual_walks_batched,
                          sample_walk_starts, source_walks, walk_endpoints,
                          walk_length_for_tail, window_walks)

__all__ = [
    "TABLE1", "DatasetSpec", "DeviceGraph", "DeviceMesh", "ForaExecutor",
    "ForaParams", "ForaResult", "FusedForaResult", "Graph", "LaneDraws",
    "LaneStreams", "PprWorkload", "PushResult", "QueryDraws",
    "ResolvedFora", "ShardedDeviceGraph", "SlicedEll", "SourceDraws",
    "SourceGenerators", "TableDraws", "TableLaneStreams",
    "TableSourceDraws", "WalkDraws", "WalkResult", "default_walk_budget",
    "fora", "fora_fused", "forward_push", "forward_push_np",
    "forward_push_sharded", "load", "monte_carlo_ppr",
    "ppr_power_iteration", "ppr_single_pair", "residual_walks",
    "residual_walks_batched", "sample_walk_starts", "small_test_graph",
    "source_walks", "synthesize", "walk_endpoints", "walk_length_for_tail",
    "window_walks",
]
