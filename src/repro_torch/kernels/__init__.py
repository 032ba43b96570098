"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the dispatch between them."""

from .ops import ell_spmm, ell_spmm_sliced, walk_endpoint_gather

__all__ = ["ell_spmm", "ell_spmm_sliced", "walk_endpoint_gather"]
