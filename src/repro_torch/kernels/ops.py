"""Dispatch between each kernel and its plain version.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. There is no other route:
a CUDA call whose kernel does not build or launch raises.
"""

from __future__ import annotations

import torch

from . import ref
from .ell_spmv import (DensePlan, SlicedFold, ell_spmm_cuda,
                       ell_spmm_sliced_cuda, ell_spmv_cuda)
from .embedding_bag import embedding_bag_cuda
from .flash_attention import flash_attention_cuda
from .walk_gather import walk_endpoint_gather_cuda


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def ell_spmv(neighbors: torch.Tensor, mask: torch.Tensor,
             weights: torch.Tensor, x: torch.Tensor, *,
             plan: DensePlan | None = None) -> torch.Tensor:
    """One-vector (n,) pull-form SpMV over the dense (n, K) table: with the
    in-neighbour table and w = 1/deg_out(src), ``P^T x``. ``plan`` is the
    table's row plan for the kernel; the plain version needs none."""
    if _on_cuda(x):
        return ell_spmv_cuda(neighbors, mask, weights, x, plan)
    return ref.ell_spmv_ref(neighbors, mask, x.to(torch.float32),
                            weights.to(torch.float32))


def ell_spmm(neighbors: torch.Tensor, mask: torch.Tensor,
             weights: torch.Tensor, x: torch.Tensor, *,
             threshold: torch.Tensor | None = None,
             plan: DensePlan | None = None) -> torch.Tensor:
    """Batched (B, n) pull-form SpMM over the dense (n, K) table;
    ``threshold`` fuses FORA's push condition into the gather. ``plan`` is
    the table's row plan for the kernel; the plain version needs none."""
    if _on_cuda(x):
        return ell_spmm_cuda(neighbors, mask, weights, x, threshold, plan)
    return ref.ell_spmm_ref(neighbors, mask, x, weights, threshold)


def ell_spmm_sliced(neighbors: torch.Tensor, mask: torch.Tensor,
                    weights: torch.Tensor, row_map: torch.Tensor,
                    x: torch.Tensor, *,
                    threshold: torch.Tensor | None = None,
                    fold: SlicedFold | None = None) -> torch.Tensor:
    """Sliced-ELL batched SpMM: virtual rows (n_virtual, W) folded onto the
    real rows through the ascending ``row_map``. ``fold`` is the table's
    fold structure for the kernel; the plain version needs none."""
    if _on_cuda(x):
        return ell_spmm_sliced_cuda(neighbors, mask, weights, row_map, x,
                                    threshold, fold)
    return ref.ell_spmm_sliced_ref(neighbors, mask, x, weights, threshold,
                                   row_map)


def walk_endpoint_gather(endpoints: torch.Tensor, budget: torch.Tensor,
                         starts: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """The index-backed walk phase: each lane's stored endpoint
    ``endpoints[starts[b,i], i]`` gets its weight, where the start node's
    ``budget`` covers the lane (the live walk owns the others). (B, n)."""
    if _on_cuda(starts):
        return walk_endpoint_gather_cuda(endpoints, budget, starts, weights)
    return ref.walk_endpoint_gather_ref(endpoints, budget, starts, weights)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, Dh) over k, v (B, Skv, Hkv, Dh) with GQA
    folding and, if ``causal``, the mask at global query positions
    ``q_offset + i``. Output in q's dtype."""
    if _on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Weighted bag sum ``out[b] = sum_l weights[b,l] * table[ids[b,l]]``:
    (B, d) from table (V, d), ids and weights (B, L)."""
    if _on_cuda(table):
        return embedding_bag_cuda(table, ids, weights)
    return ref.embedding_bag_ref(table, ids, weights)
