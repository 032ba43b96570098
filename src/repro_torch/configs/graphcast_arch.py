"""graphcast [gnn]: 16 processor layers d_hidden=512, sum aggregation,
mesh_refinement=6, n_vars=227 encode-process-decode [arXiv:2212.12794].

The assigned GNN shape set supplies the graph; node features play the role
of the 227 atmospheric variables on the finest mesh (DESIGN.md §6)."""

from ..models.gnn import graphcast
from .base import GNNArch

N_VARS = 227

ARCH = GNNArch(
    "graphcast", graphcast,
    make_cfg=lambda s: graphcast.GraphCastConfig(
        n_layers=16, d_hidden=512, d_in=s["d"], n_out=N_VARS,
        mesh_refinement=6),
    make_smoke_cfg=lambda: graphcast.GraphCastConfig(
        n_layers=2, d_hidden=32, d_in=16, n_out=8),
)
