"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the dispatch between them (:mod:`.ops`). The attention, embedding-bag and
one-vector SpMV dispatches are ``ops.flash_attention``, ``ops.embedding_bag``
and ``ops.ell_spmv``: the package's ``flash_attention``, ``embedding_bag``
and ``ell_spmv`` are the modules of their CUDA wrappers."""

from .ops import ell_spmm, ell_spmm_sliced, walk_endpoint_gather

__all__ = ["ell_spmm", "ell_spmm_sliced", "walk_endpoint_gather"]
