"""Exact PPR oracle via power iteration (tests and ground truth).

A walk starts at source s; at every step it stops with probability
``alpha`` at the current node, otherwise it moves to a uniform
out-neighbour. pi(s, t) = P[walk from s stops at t]. Fixed point:

    pi = alpha * e_s + (1 - alpha) * P^T pi,   P = D_out^{-1} A

computed over the COO edge list with ``index_add_``, batched over sources.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .graph import Graph


def ppr_power_iteration(graph: Graph, sources: np.ndarray, alpha: float = 0.2,
                        iters: int | None = None, tol: float = 1e-9, *,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Dense PPR rows for each source, shape (len(sources), n), float32,
    with iters chosen so that (1-alpha)^iters < tol."""
    if not 0.0 < alpha < 1.0:
        raise ValueError("alpha in (0,1)")
    dev = resolve_device(device)
    if iters is None:
        iters = int(np.ceil(np.log(tol) / np.log(1.0 - alpha))) + 1
    n = graph.n
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    inv_deg = torch.as_tensor(
        (1.0 / np.maximum(graph.out_degree, 1)).astype(np.float32), device=dev)
    edge_src = torch.as_tensor(graph.edge_src.astype(np.int64), device=dev)
    edge_dst = torch.as_tensor(graph.edge_dst.astype(np.int64), device=dev)
    seeds = torch.zeros((sources.size, n), dtype=torch.float32, device=dev)
    seeds[torch.arange(sources.size, device=dev),
          torch.as_tensor(sources, device=dev)] = 1.0
    pi = seeds
    for _ in range(iters):
        contrib = (pi * inv_deg)[:, edge_src]                 # (B, m)
        moved = torch.zeros_like(pi).index_add_(1, edge_dst, contrib)
        pi = alpha * seeds + (1.0 - alpha) * moved
    return pi.cpu().numpy()
