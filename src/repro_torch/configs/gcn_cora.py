"""gcn-cora [gnn]: 2 layers d_hidden=16, mean aggregation, symmetric
normalisation [arXiv:1609.02907]."""

from ..models.gnn import gcn
from .base import GNNArch

ARCH = GNNArch(
    "gcn-cora", gcn,
    make_cfg=lambda s: gcn.GCNConfig(
        n_layers=2, d_hidden=16, d_in=s["d"], n_classes=max(s["classes"], 2)),
    make_smoke_cfg=lambda: gcn.GCNConfig(n_layers=2, d_hidden=8, d_in=16,
                                         n_classes=4),
)
