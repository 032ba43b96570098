"""dimenet [gnn]: 6 blocks d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6 [arXiv:2003.03123]. Triplet lists are precomputed inputs with a
static budget (DESIGN.md §6 — O(sum deg^2) subsampled at web-graph scale)."""

from ..models.gnn import dimenet
from .base import GNNArch

ARCH = GNNArch(
    "dimenet", dimenet,
    make_cfg=lambda s: dimenet.DimeNetConfig(
        n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6,
        n_out=1),
    make_smoke_cfg=lambda: dimenet.DimeNetConfig(
        n_blocks=2, d_hidden=16, n_bilinear=4, n_spherical=3, n_radial=4),
)
