"""Plain PyTorch versions of the port's kernels.

They define what each kernel computes, with the argument order of
``repro.kernels.ref``. The CPU path of :mod:`repro_torch.kernels.ops` runs
them, and the tests and ``chip_smoke.py`` hold the CUDA kernels against
them on the same inputs.
"""

from __future__ import annotations

import torch


def ell_spmm_ref(neighbors: torch.Tensor, mask: torch.Tensor, x: torch.Tensor,
                 weights: torch.Tensor | None = None,
                 threshold: torch.Tensor | None = None) -> torch.Tensor:
    """Batched pull-form ELL SpMM:

        y[b, i] = sum_j mask[i,j] * w[i,j] * f(x[b, neighbors[i,j]])

    with f the identity, or, given ``threshold`` (n,), FORA's fused push
    selection f(v) = v * [v > threshold[src]]. neighbors/mask/weights are
    (rows, K); x is (B, n). Returns (B, rows).
    """
    idx = neighbors.long()
    gathered = x[:, idx]                          # (B, rows, K)
    if threshold is not None:
        thr = threshold[idx]                      # (rows, K) per-source bound
        gathered = torch.where(gathered > thr[None], gathered, 0.0)
    w = mask.to(x.dtype)
    if weights is not None:
        w = w * weights.to(x.dtype)
    return torch.einsum("nk,bnk->bn", w, gathered)


def ell_spmm_sliced_ref(neighbors: torch.Tensor, mask: torch.Tensor,
                        x: torch.Tensor, weights: torch.Tensor | None = None,
                        threshold: torch.Tensor | None = None,
                        row_map: torch.Tensor | None = None) -> torch.Tensor:
    """Sliced-ELL SpMM: the per-virtual-row partials of
    :func:`ell_spmm_ref`, folded onto the real rows through ``row_map``
    (n_virtual,), ascending. Virtual rows whose ``row_map`` is outside
    [0, n) are padding and dropped, as ``segment_sum`` drops them.
    Returns (B, n).
    """
    if row_map is None:
        raise ValueError("row_map is required for the sliced version")
    partials = ell_spmm_ref(neighbors, mask, x, weights, threshold)
    n = x.shape[1]
    keep = (row_map >= 0) & (row_map < n)
    out = torch.zeros((x.shape[0], n), dtype=partials.dtype,
                      device=partials.device)
    return out.index_add_(1, row_map[keep].long(), partials[:, keep])


def walk_endpoint_gather_ref(endpoints: torch.Tensor, budget: torch.Tensor,
                             starts: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Index-backed walk aggregation: lane i of row b reads the stored
    endpoint ``endpoints[starts[b,i], i]`` and adds its weight there,
    provided the start node's stored budget covers the lane:

        out[b, t] = sum_i w[b,i] * [i < budget[starts[b,i]]]
                                 * [endpoints[starts[b,i], i] == t]

    endpoints (n, W) int32, budget (n,) int32, starts (B, L <= W) int32,
    weights (B, L). Returns (B, n) in the weights' dtype (float32 on the
    path; the card check runs it in float64).
    """
    n = endpoints.shape[0]
    B, L = starts.shape
    lane = torch.arange(L, device=starts.device)
    s = starts.long()
    e = endpoints[s, lane[None, :]].long()                  # (B, L)
    valid = lane[None, :] < budget[s]
    w = torch.where(valid, weights, 0.0)
    flat = e + torch.arange(B, device=e.device)[:, None] * n
    out = torch.zeros(B * n, dtype=weights.dtype, device=weights.device)
    return out.index_add_(0, flat.reshape(-1), w.reshape(-1)).view(B, n)
