"""Frontier-synchronous forward push (FORA phase 1).

Every above-threshold node is relaxed in each sweep:

    front(v)   = r(v) > rmax * deg_out(v)          (FORA's push condition)
    pi        += alpha * r * front
    r         <- r * (1 - front) + (1 - alpha) * P^T (r * front)

The relaxation is one pull-form ELL SpMM per sweep (``kernels.ops.ell_spmm``
over the dense table with its row plan, ``ell_spmm_sliced`` when the
residency carries a ``row_map`` and its fold structure), with the push
condition fused into the kernel's gather through its ``threshold``
argument. The termination
condition (all r(v) <= rmax * deg(v)) is sequential FORA's, so its
guarantee holds, and the invariant pi_true(s,t) = pi(t) + sum_v r(v)
pi_true(v,t) holds after every sweep.

:func:`forward_push_sharded` runs the same loop over a
:class:`~repro_torch.ppr.graph.ShardedDeviceGraph`: each sweep is one
SpMM a shard (``ops.ell_spmm_shard``/``ell_spmm_sliced_shard``) and one
combine of their outputs in shard order, with the state on the mesh's
first device, so it makes no host sync a shard.

Residual and reserve are kept as (n, B) tensors between sweeps, the
kernels' layout, and returned as (B, n) views. The host tests convergence
once every ``CHECK_EVERY`` sweeps, not after each one: a sweep after
convergence has an empty frontier and moves nothing, so the result and the
sweep count (summed on the device from each sweep's "any row above
threshold" flag) equal a loop that stops at once.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import ops
from ..kernels.ell_spmv import (DensePlan, SlicedFold, dense_plan,
                               sliced_fold)
from .graph import Graph, ShardedDeviceGraph

CHECK_EVERY = 8      # sweeps between the host's convergence tests


class PushResult(NamedTuple):
    pi: torch.Tensor       # (B, n) reserve (lower-bound PPR mass)
    r: torch.Tensor        # (B, n) residual
    iters: torch.Tensor    # () int32, frontier sweeps executed


def forward_push(in_neighbors: torch.Tensor, in_mask: torch.Tensor,
                 in_weights: torch.Tensor, out_degree: torch.Tensor,
                 seeds: torch.Tensor, *, alpha: float, rmax: float,
                 max_iters: int = 10_000,
                 row_map: torch.Tensor | None = None,
                 fold: SlicedFold | None = None,
                 plan: DensePlan | None = None,
                 pi0: torch.Tensor | None = None) -> PushResult:
    """Batched frontier push over the pull-form ELL table.

    ``in_neighbors``/``in_mask``/``in_weights`` are the (n, K) table of
    :meth:`Graph.ell_in`, or with ``row_map`` the sliced (n_virtual, W)
    table of :meth:`Graph.ell_in_sliced` and ``fold`` its
    :func:`~repro_torch.kernels.ell_spmv.sliced_fold` (``DeviceGraph``
    carries it as ``in_fold``; derived once here when not given); a dense
    table's :func:`~repro_torch.kernels.ell_spmv.dense_plan` is ``plan``
    (``DeviceGraph.in_plan``; derived once here on the card when not
    given, the plain version needs none); ``seeds`` is (B, n) one-hot (or
    any residual); ``pi0`` (default zeros) seeds the reserve. Runs until
    no residual is above threshold or ``max_iters`` sweeps have run, and
    syncs with the host once every ``CHECK_EVERY`` sweeps.
    """
    if row_map is not None and fold is None:
        fold = sliced_fold(row_map, seeds.shape[1], in_neighbors.shape[1])
    if row_map is None and plan is None and seeds.device.type == "cuda":
        plan = dense_plan(in_mask)

    def sweep(x: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
        if row_map is None:
            return ops.ell_spmm(in_neighbors, in_mask, in_weights, x,
                                threshold=threshold, plan=plan)
        return ops.ell_spmm_sliced(in_neighbors, in_mask, in_weights,
                                   row_map, x, threshold=threshold,
                                   fold=fold)

    return _push(sweep, out_degree, seeds, alpha=alpha, rmax=rmax,
                 max_iters=max_iters, pi0=pi0)


def forward_push_sharded(sg: ShardedDeviceGraph, seeds: torch.Tensor, *,
                         alpha: float, rmax: float, max_iters: int = 10_000,
                         pi0: torch.Tensor | None = None) -> PushResult:
    """:func:`forward_push` over a node-sharded residency: ``seeds`` (B, n)
    on the mesh's first device, where the result lies too. A sweep is one
    SpMM a shard and one combine in shard order; the host tests
    convergence once every ``CHECK_EVERY`` sweeps, as on one device."""

    def sweep(x: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
        if sg.in_row_map is None:
            return ops.ell_spmm_shard(sg.in_neighbors, sg.in_mask,
                                      sg.in_weights, x, threshold=threshold,
                                      plans=sg.in_plan)
        return ops.ell_spmm_sliced_shard(sg.in_neighbors, sg.in_mask,
                                         sg.in_weights, sg.in_row_map, x,
                                         threshold=threshold,
                                         folds=sg.in_fold)

    return _push(sweep, sg.out_degree, seeds, alpha=alpha, rmax=rmax,
                 max_iters=max_iters, pi0=pi0)


def _push(sweep: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
          out_degree: torch.Tensor, seeds: torch.Tensor, *, alpha: float,
          rmax: float, max_iters: int,
          pi0: torch.Tensor | None) -> PushResult:
    """The push loop around ``sweep(x, threshold)``, the (B, n) product
    P^T f(x) with the push condition fused."""
    deg_safe = torch.clamp(out_degree.to(torch.float32), min=1.0)
    threshold = rmax * deg_safe                              # (n,)
    thr_col = threshold[:, None]
    rT = seeds.t().contiguous()                              # (n, B)
    piT = torch.zeros_like(rT) if pi0 is None else pi0.t().contiguous()
    iters = torch.zeros((), dtype=torch.int32, device=seeds.device)
    done = 0
    while done < max_iters and bool((rT > thr_col).any()):
        sweeps = min(CHECK_EVERY, max_iters - done)
        for _ in range(sweeps):
            front = rT > thr_col
            iters += front.any()
            piT = piT + alpha * rT * front
            moved = sweep(rT.t(), threshold)
            rT = rT * ~front + (1.0 - alpha) * moved.t()
        done += sweeps
    return PushResult(pi=piT.t(), r=rT.t(), iters=iters)


def one_hot_seeds(sources, n: int, device: torch.device) -> torch.Tensor:
    """(B, n) float32 residuals with all mass on each row's source."""
    src = torch.as_tensor(np.asarray(sources, dtype=np.int64).reshape(-1),
                          device=device)
    seeds = torch.zeros((src.numel(), n), dtype=torch.float32, device=device)
    seeds[torch.arange(src.numel(), device=device), src] = 1.0
    return seeds


def forward_push_np(graph: Graph, sources: np.ndarray, *, alpha: float,
                    rmax: float, max_iters: int = 10_000,
                    device: str | torch.device = "cuda") -> PushResult:
    """One-hot seeds for ``sources`` pushed over the graph's upload-once
    :class:`DeviceGraph` on ``device``."""
    dg = graph.device(resolve_device(device))
    return forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                        dg.out_degree, one_hot_seeds(sources, graph.n,
                                                     dg.device),
                        alpha=alpha, rmax=rmax, max_iters=max_iters,
                        row_map=dg.in_row_map, fold=dg.in_fold,
                        plan=dg.in_plan)
