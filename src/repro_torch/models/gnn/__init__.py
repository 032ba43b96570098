"""The GNN family, the port of ``repro/models/gnn``: GCN, PNA, GraphCast
and DimeNet, forward (``apply``) and loss value (``loss_fn``), with their
aggregations on ``ops.segment_reduce``."""

from . import dimenet, gcn, graphcast, pna
from .common import GraphBatch, random_graph_batch

__all__ = ["GraphBatch", "dimenet", "gcn", "graphcast", "pna",
           "random_graph_batch"]
