"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the dispatch between them (:mod:`.ops`). The attention and embedding-bag
dispatches are ``ops.flash_attention`` and ``ops.embedding_bag``: the
package's ``flash_attention`` and ``embedding_bag`` are the modules of
their CUDA wrappers."""

from .ops import ell_spmm, ell_spmm_sliced, walk_endpoint_gather

__all__ = ["ell_spmm", "ell_spmm_sliced", "walk_endpoint_gather"]
