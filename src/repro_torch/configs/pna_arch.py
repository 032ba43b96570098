"""pna [gnn]: 4 layers d_hidden=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation [arXiv:2004.05718]."""

from ..models.gnn import pna
from .base import GNNArch

ARCH = GNNArch(
    "pna", pna,
    make_cfg=lambda s: pna.PNAConfig(
        n_layers=4, d_hidden=75, d_in=s["d"], n_classes=max(s["classes"], 2)),
    make_smoke_cfg=lambda: pna.PNAConfig(n_layers=2, d_hidden=12, d_in=16,
                                         n_classes=4),
)
