"""Shared GNN machinery, the port of ``repro/models/gnn/common.py``:
edge-index message passing over segment reductions.

Every aggregation is ``ops.segment_reduce`` over a :class:`SegmentPlan`
(the stable sort of an index and its segment offsets), the port's
counterpart of ``jax.ops.segment_sum/max/min``: on the card the
hand-written ``csrc/segment_reduce.cu``, one summation order a cell, no
float atomics. A plan is built once per index and batch and reused by
every layer and aggregator over it. Counts of edges a segment (degrees,
``scatter_mean``'s divisor) come from the plan's offsets, exactly the
``segment_sum`` of ones the JAX package takes.

All models consume a :class:`GraphBatch` of padded tensors, with node and
edge masks marking validity. The JAX package's ``constrain`` calls are
sharding hints; on one device they have no counterpart and are left out.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..._device import resolve_device
from ...kernels import ops
from ...kernels.ops import SegmentPlan, segment_plan
from ..common import MLP, ParamTree, tensor_from_numpy


@dataclass(frozen=True)
class GraphBatch:
    """Padded graph batch.

    node_feat (N, F) | edge_index (2, M) int src, dst | node_mask (N,) |
    edge_mask (M,) | positions (N, 3) optional | graph_ids (N,) optional
    (segment id per node for batched small graphs) | labels optional.
    """

    node_feat: Any
    edge_index: Any
    node_mask: Any
    edge_mask: Any
    positions: Any = None
    graph_ids: Any = None
    labels: Any = None
    edge_feat: Any = None
    num_graphs: int = 1


def scatter_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    return ops.segment_reduce(values, plan, "sum")


def scatter_mean(values: torch.Tensor, plan: SegmentPlan,
                 eps: float = 1e-9) -> torch.Tensor:
    s = ops.segment_reduce(values, plan, "sum")
    cnt = plan.counts.to(values.dtype)
    return s / torch.clamp_min(cnt, eps)[:, None]


def scatter_max(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    return ops.segment_reduce(values, plan, "max")


def scatter_min(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    return ops.segment_reduce(values, plan, "min")


def gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``x[index]`` as one ``index_select`` (int32 or int64 index),
    which on the H100 is faster than advanced indexing at d 47-75 and
    level at d 16 (PERF.md, the GNN section)."""
    return torch.index_select(x, 0, index)


def masked_edges(edge_index: torch.Tensor, edge_mask: torch.Tensor,
                 n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Redirect masked-out edges to a trash node (n) so reductions over
    n + 1 segments keep padding out of real aggregates."""
    src = torch.where(edge_mask, edge_index[0], n)
    dst = torch.where(edge_mask, edge_index[1], n)
    return src, dst


def in_degree(dst_plan: SegmentPlan, n: int) -> torch.Tensor:
    """(n,) float32 in-degree over the real edges, from the plan of the
    masked destinations over n + 1 segments."""
    return dst_plan.counts[:n].to(torch.float32)


def sym_norm_coeff(edge_index: torch.Tensor, edge_mask: torch.Tensor, n: int,
                   dst_plan: SegmentPlan,
                   src_plan: SegmentPlan) -> torch.Tensor:
    """GCN symmetric normalisation 1/sqrt(d_i d_j) per edge (self-loops are
    the caller's responsibility; masked edges get weight 0). The plans are
    of the masked destinations and sources over n + 1 segments."""
    deg = (dst_plan.counts + src_plan.counts).to(torch.float32)
    deg = torch.clamp_min(deg[:n] * 0.5, 1.0)   # avg of in/out ~ undirected
    inv_sqrt = torch.rsqrt(deg)
    w = gather(inv_sqrt, edge_index[0]) * gather(inv_sqrt,
                                                 edge_index[1])
    return torch.where(edge_mask, w, 0.0)


def random_graph_batch(generator: torch.Generator, n: int, m: int,
                       d_feat: int, *, n_graphs: int = 1,
                       with_positions: bool = False, d_edge: int = 0,
                       n_classes: int = 7, dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cuda") -> GraphBatch:
    """Random valid GraphBatch for smoke runs, laid out as the JAX
    package's: every node and edge valid, uniform endpoints, ``graph_ids``
    = node id mod ``n_graphs``. Drawn on ``generator``'s device."""
    dev = resolve_device(device)
    g = generator

    def normal(*shape):
        return torch.randn(shape, generator=g, device=g.device,
                           dtype=dtype).to(dev)

    def ints(high, size):
        return torch.randint(0, high, (size,), generator=g, device=g.device,
                             dtype=torch.int32).to(dev)

    feat = normal(n, d_feat)
    src, dst = ints(n, m), ints(n, m)
    positions = normal(n, 3) if with_positions else None
    labels = ints(n_classes, n)
    edge_feat = normal(m, d_edge) if d_edge else None
    return GraphBatch(
        node_feat=feat, edge_index=torch.stack([src, dst]),
        node_mask=torch.ones(n, dtype=torch.bool, device=dev),
        edge_mask=torch.ones(m, dtype=torch.bool, device=dev),
        positions=positions,
        graph_ids=(torch.arange(n, device=dev) % n_graphs).to(torch.int32),
        labels=labels, edge_feat=edge_feat, num_graphs=n_graphs)


# ---------------------------------------------------------------------------
# the JAX package's parameters carried across


def _is_mlp(value: Any) -> bool:
    return (isinstance(value, Sequence) and len(value) > 0
            and all(isinstance(v, Mapping) and "w" in v
                    and set(v) <= {"w", "b"} for v in value))


def tree_from_numpy(tree: Mapping, device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.float32) -> ParamTree:
    """A JAX ``init`` pytree as numpy arrays -> a :class:`ParamTree` on
    ``device``: a list of {"w", "b"} layers (``mlp_init``'s) becomes an
    :class:`MLP`, another list an ``nn.ModuleList``, a dict a subtree."""
    dev = resolve_device(device)

    def convert(value):
        if _is_mlp(value):
            has_bias = all("b" in layer for layer in value)
            return MLP([tensor_from_numpy(layer["w"], dev, dtype)
                        for layer in value],
                       [tensor_from_numpy(layer["b"], dev, dtype)
                        for layer in value] if has_bias else None)
        if isinstance(value, Mapping):
            return {k: convert(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [convert(v) for v in value]
        return tensor_from_numpy(np.asarray(value), dev, dtype)

    return ParamTree(convert(tree))


def mlp_param_count(dims: Sequence[int], bias: bool = True) -> int:
    """Parameters of ``mlp_init(dims)``."""
    return sum(a * b + (b if bias else 0) for a, b in zip(dims[:-1], dims[1:]))
