"""Exact PPR oracle via power iteration (tests and ground truth).

A walk starts at source s; at every step it stops with probability
``alpha`` at the current node, otherwise it moves to a uniform
out-neighbour. pi(s, t) = P[walk from s stops at t]. Fixed point:

    pi = alpha * e_s + (1 - alpha) * P^T pi,   P = D_out^{-1} A

Each step's ``P^T pi`` takes the route of the graph's resident push table
(``graph.device(dev)``). With the dense (n, K) in-neighbour table, whose
weights are 1/deg_out(src), it is one ``ops.ell_spmv`` (K4 on the card,
over the table's row plan ``in_plan``) a source and step, the sources run
one after another as the JAX package vmaps over them. A graph whose
in-degrees put it on the sliced table (every dataset stand-in: their Zipf
targets make hubs) has no dense table to run K4 over, so its steps run
over the COO edge list, batched over sources: the (m, B) rows of the
sources' mass gathered by ``edge_src``, then one ``ops.segment_reduce`` sum
over the plan of ``edge_dst``, built once (on the card the segment
reduction kernel, one summation order, so the rows repeat bit for bit).
That is the layout's route, not a fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import ops
from .graph import Graph


def default_iters(alpha: float = 0.2, tol: float = 1e-9) -> int:
    """The step count of :func:`ppr_power_iteration` when none is given:
    the least with (1 - alpha)^iters < tol, plus one."""
    if not 0.0 < alpha < 1.0:
        raise ValueError("alpha in (0,1)")
    return int(np.ceil(np.log(tol) / np.log(1.0 - alpha))) + 1


def _seeds(sources: np.ndarray, n: int, dev: torch.device) -> torch.Tensor:
    seeds = torch.zeros((sources.size, n), dtype=torch.float32, device=dev)
    seeds[torch.arange(sources.size, device=dev),
          torch.as_tensor(sources, device=dev)] = 1.0
    return seeds


def power_iteration_coo(graph: Graph, sources: np.ndarray, alpha: float,
                        iters: int, device: torch.device) -> torch.Tensor:
    """(B, n) PPR rows on ``device`` by ``iters`` steps over the COO edge
    list, all sources at once: a step gathers the (m, B) rows of
    ``pi / deg_out`` by ``edge_src`` and sums them by ``edge_dst`` with
    ``ops.segment_reduce`` over the plan of ``edge_dst`` (each node's
    in-edges in edge order)."""
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    inv_deg = torch.as_tensor(
        (1.0 / np.maximum(graph.out_degree, 1)).astype(np.float32),
        device=device)
    edge_src = torch.as_tensor(graph.edge_src.astype(np.int64), device=device)
    edge_dst = torch.as_tensor(graph.edge_dst.astype(np.int64), device=device)
    plan = ops.segment_plan(edge_dst, graph.n)
    seeds = _seeds(sources, graph.n, device)
    pi = seeds
    for _ in range(iters):
        mass = (pi * inv_deg).t().contiguous()                # (n, B)
        contrib = torch.index_select(mass, 0, edge_src)       # (m, B)
        moved = ops.segment_reduce(contrib, plan, "sum").t()  # (B, n)
        pi = alpha * seeds + (1.0 - alpha) * moved
    return pi


def ppr_power_iteration(graph: Graph, sources: np.ndarray, alpha: float = 0.2,
                        iters: int | None = None, tol: float = 1e-9, *,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Dense PPR rows for each source, shape (len(sources), n), float32,
    with iters chosen so that (1-alpha)^iters < tol. On a dense push table
    every step is one ``ops.ell_spmv`` per source; the loop never waits for
    the device, and the rows are read back once at the end."""
    if not 0.0 < alpha < 1.0:
        raise ValueError("alpha in (0,1)")
    if iters is None:
        iters = default_iters(alpha, tol)
    dev = resolve_device(device)
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    dg = graph.device(dev)
    if dg.layout != "dense":
        return power_iteration_coo(graph, sources, alpha, iters,
                                   dev).cpu().numpy()
    rows = []
    for seed in _seeds(sources, graph.n, dev):
        pi = seed
        for _ in range(iters):
            moved = ops.ell_spmv(dg.in_neighbors, dg.in_mask, dg.in_weights,
                                 pi, plan=dg.in_plan)
            pi = alpha * seed + (1.0 - alpha) * moved
        rows.append(pi)
    out = torch.stack(rows) if rows else _seeds(sources, graph.n, dev)
    return out.cpu().numpy()


def ppr_single_pair(graph: Graph, s: int, t: int, alpha: float = 0.2, *,
                    device: str | torch.device = "cuda") -> float:
    """pi(s, t), the paper's Problem-1 query unit."""
    return float(ppr_power_iteration(graph, np.array([s]), alpha,
                                     device=device)[0, t])
