"""FORA: forward push + Monte-Carlo random walks (Wang et al., KDD'17).

Parameters follow FORA's single-source setting: |pi_hat - pi| <= eps * pi
for all pi >= delta with probability 1 - p_f, with delta = p_f = 1/n:

    omega = (2*eps/3 + 2) * ln(2/p_f) / (eps^2 * delta)     (total walk budget)
    rmax  = eps * sqrt(delta / (3 * m * ln(2/p_f)))          (push threshold)

Phase 1 pushes until every residual satisfies r(v) <= rmax*deg(v); phase 2
runs ceil(r_sum * omega) walks, rounded up to a power of two, sampled from
the residual distribution, and adds their endpoint mass to the reserve.

:func:`fora_fused` keeps the whole query block on the device: push, the
power-of-two walk budget, the walks and the readout ``pi = push.pi +
endpoint``; the host waits on it only at the push's convergence tests and
at readout. With a :class:`~repro_torch.index.WalkIndex` it serves the
walk lanes the index covers from its table (kernel K3) and walks the rest
live on the index's lane streams. :func:`fora` is the legacy path that
reads the residual mass back to choose the walk count on the host.
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from dataclasses import dataclass
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import ops
from .forward_push import forward_push, forward_push_np, one_hot_seeds
from .graph import DeviceGraph, Graph
from .random_walk import (QueryDraws, WalkDraws, fold_endpoints,
                          lane_weights, residual_walks, sample_walk_starts,
                          walk_endpoints, walk_length_for_tail)

if TYPE_CHECKING:
    from ..index import WalkIndex

MAX_PUSH_ITERS = 10_000


@dataclass(frozen=True)
class ForaParams:
    alpha: float = 0.2
    epsilon: float = 0.5
    delta: float | None = None     # default 1/n
    p_f: float | None = None       # default 1/n
    rmax_scale: float = 1.0        # push/walk balance
    walk_tail: float = 1e-4
    max_walks: int = 1 << 22       # cap on the walk lane count

    def resolve(self, graph: "Graph | DeviceGraph") -> "ResolvedFora":
        n, m = graph.n, graph.m
        delta = self.delta if self.delta is not None else 1.0 / n
        p_f = self.p_f if self.p_f is not None else 1.0 / n
        log_term = math.log(2.0 / p_f)
        omega = (2.0 * self.epsilon / 3.0 + 2.0) * log_term / (self.epsilon ** 2 * delta)
        rmax = self.rmax_scale * self.epsilon * math.sqrt(delta / (3.0 * m * log_term))
        return ResolvedFora(alpha=self.alpha, epsilon=self.epsilon,
                            delta=delta, p_f=p_f, omega=omega, rmax=rmax,
                            walk_tail=self.walk_tail, max_walks=self.max_walks)


@dataclass(frozen=True)
class ResolvedFora:
    alpha: float
    epsilon: float
    delta: float
    p_f: float
    omega: float
    rmax: float
    walk_tail: float
    max_walks: int


class ForaResult(NamedTuple):
    pi: np.ndarray        # (B, n) PPR estimates
    push_iters: int
    walks_used: int
    residual_mass: np.ndarray  # (B,) r_sum after push (drives walk count)
    walks_short: np.ndarray    # (B,) bool: max_walks cut ceil(r_sum * omega)


class FusedForaResult(NamedTuple):
    """Device-resident FORA result; reading ``pi`` is the caller's sync."""

    pi: torch.Tensor              # (B, n) PPR estimates
    residual_mass: torch.Tensor   # (B,) r_sum after push
    push_iters: torch.Tensor      # () int32
    walks_effective: torch.Tensor  # (B,) int32 power-of-two budgets
    walks_budget: int             # lane count W of the walk phase
    # (B,) bool: rows whose lane count W fell below the ceil(r_sum * omega)
    # walks FORA's guarantee asks for. Such a row stays unbiased but is
    # noisier, and its eps guarantee does not hold.
    walks_short: torch.Tensor


def _pow2_ceil_host(v: int) -> int:
    return 1 << (max(1, int(v)) - 1).bit_length()


def default_walk_budget(rp: ResolvedFora) -> int:
    """Walk lane count when no calibrated budget is given: the worst case
    r_sum = 1 (pushes cannot increase the total residual mass)."""
    return _pow2_ceil_host(min(rp.max_walks, math.ceil(rp.omega)))


def _check_index(index: "WalkIndex", dg: DeviceGraph, rp: ResolvedFora,
                 steps: int) -> None:
    if index.n != dg.n:
        raise ValueError(f"index built for n={index.n}, graph has {dg.n}")
    if abs(index.alpha - rp.alpha) > 1e-12 or index.num_steps != steps:
        raise ValueError(
            f"index walked alpha={index.alpha}/L={index.num_steps}, query "
            f"needs alpha={rp.alpha}/L={steps} — rebuild the index")
    if index.device != dg.device:
        raise ValueError(f"index lives on {index.device}, graph on "
                         f"{dg.device}")


def _index_walks(dg: DeviceGraph, index: "WalkIndex", residual: torch.Tensor,
                 draws: WalkDraws, w_eff: torch.Tensor, *, alpha: float,
                 num_walks: int, num_steps: int) -> torch.Tensor:
    """The walk phase served from ``index``: (B, n) endpoint mass.

    Starts are sampled from the query's start uniforms as on the live path,
    with weights r_sum / w_eff on the active lanes. The table lanes
    [0, min(width, W)) are folded by K3; the others walk live on the
    index's lane streams, shared by every row. A partial index walks every
    lane live and zero-weights the lanes its table served."""
    B = residual.shape[0]
    starts, r_sum = sample_walk_starts(residual, draws.start_uniforms())
    if starts.shape != (B, num_walks):
        raise ValueError(f"draws give {tuple(starts.shape)} starts, "
                         f"need ({B}, {num_walks})")
    weights = lane_weights(r_sum, num_walks, w_eff)
    k = min(index.width, num_walks)
    endpoint = ops.walk_endpoint_gather(index.endpoints, index.budget,
                                        starts[:, :k].contiguous(),
                                        weights[:, :k].contiguous())
    live_lo = 0 if index.partial else k
    if live_lo == num_walks:
        return endpoint
    lanes = torch.arange(live_lo, num_walks, device=residual.device)
    pos = walk_endpoints(dg.edge_dst, dg.out_offsets, dg.out_degree,
                         starts[:, live_lo:],
                         index.streams.steps(lanes, num_steps), alpha=alpha)
    w_live = weights[:, live_lo:]
    if index.partial:
        covered = torch.zeros_like(w_live, dtype=torch.bool)
        covered[:, :k] = (lanes[None, :k]
                          < index.budget[starts[:, :k].long()])
        w_live = torch.where(covered, 0.0, w_live)
    return endpoint + fold_endpoints(pos, w_live, dg.n)


def fora_fused(dg: DeviceGraph, sources, params: ForaParams = ForaParams(),
               seed: int = 0, *, num_walks: int | None = None,
               query_ids: Sequence[int] | None = None,
               draws: WalkDraws | None = None,
               index: "WalkIndex | None" = None,
               device: str | torch.device = "cuda") -> FusedForaResult:
    """FORA for a block of B sources on a :class:`DeviceGraph` that lives
    on ``device``.

    ``num_walks`` is the walk lane count (a workload-calibrated budget from
    :class:`~repro_torch.ppr.executor.ForaExecutor`; by default the worst
    case r_sum = 1, itself capped at ``max_walks``), rounded up to a power
    of two. Each row's effective budget is pow2(ceil(r_sum * omega))
    clipped to it, computed on the device; ``walks_short`` marks the rows
    that the clip left with fewer walks than ceil(r_sum * omega). The walks draw from ``draws`` when given (the tests replay the
    JAX package's draws), else from one generator per query seeded from
    (``seed``, query id); ``query_ids`` default to the row positions.

    ``index`` attaches a :class:`~repro_torch.index.WalkIndex` on the same
    device, built at this call's alpha and walk tail (checked here): the
    lanes its budget covers are served from its table by K3, and the rest
    walk live on its lane streams; only the start uniforms then come from
    ``draws``.
    """
    dev = resolve_device(device)
    if dg.device != dev:
        raise ValueError(f"graph lives on {dg.device}, call asked for {dev}")
    rp = params.resolve(dg)
    num_walks = _pow2_ceil_host(default_walk_budget(rp) if num_walks is None
                                else num_walks)
    steps = walk_length_for_tail(rp.alpha, rp.walk_tail)
    if index is not None:
        _check_index(index, dg, rp, steps)
    seeds = one_hot_seeds(sources, dg.n, dev)
    B = seeds.shape[0]
    push = forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                        dg.out_degree, seeds, alpha=rp.alpha, rmax=rp.rmax,
                        max_iters=MAX_PUSH_ITERS, row_map=dg.in_row_map,
                        fold=dg.in_fold, plan=dg.in_plan)
    # the residual rows contiguous: a row's sum then adds in one order at
    # any batch width (the push leaves them strided by B)
    residual = push.r.contiguous()
    r_sum = residual.sum(dim=1)                              # (B,)
    need = torch.clamp(torch.ceil(r_sum * rp.omega), min=1.0)
    w_eff = torch.exp2(torch.ceil(torch.log2(need)))
    w_eff = torch.clamp(w_eff, 1.0, float(num_walks)).to(torch.int32)
    if draws is None:
        qids = range(B) if query_ids is None else query_ids
        if len(qids) != B:
            raise ValueError(f"{len(qids)} query ids for {B} sources")
        draws = QueryDraws(seed, qids, num_walks, dev)
    if index is not None:
        endpoint = _index_walks(dg, index, residual, draws, w_eff,
                                alpha=rp.alpha, num_walks=num_walks,
                                num_steps=steps)
    else:
        endpoint = residual_walks(dg.edge_dst, dg.out_offsets, dg.out_degree,
                                  residual, draws, alpha=rp.alpha,
                                  num_walks=num_walks, num_steps=steps,
                                  active_walks=w_eff)
    return FusedForaResult(pi=push.pi + endpoint, residual_mass=r_sum,
                           push_iters=push.iters, walks_effective=w_eff,
                           walks_budget=num_walks,
                           walks_short=need > w_eff)


def fora(graph: Graph, sources, params: ForaParams = ForaParams(),
         seed: int = 0, *, device: str | torch.device = "cuda") -> ForaResult:
    """Legacy FORA for a batch of sources: the push's residual mass is read
    back, and the walk count is the batch's largest ceil(r_sum * omega),
    rounded up to a power of two. Returns dense rows on the host."""
    dev = resolve_device(device)
    rp = params.resolve(graph)
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    push = forward_push_np(graph, sources, alpha=rp.alpha, rmax=rp.rmax,
                           device=dev)
    r_sum = push.r.sum(dim=1).cpu().numpy()
    walks = int(min(rp.max_walks,
                    max(1, math.ceil(float(r_sum.max()) * rp.omega))))
    walks = _pow2_ceil_host(walks)
    dg = graph.device(dev)
    draws = QueryDraws(seed, range(sources.size), walks, dev)
    endpoint = residual_walks(dg.edge_dst, dg.out_offsets, dg.out_degree,
                              push.r, draws, alpha=rp.alpha, num_walks=walks,
                              num_steps=walk_length_for_tail(rp.alpha,
                                                             rp.walk_tail))
    pi = (push.pi + endpoint).cpu().numpy()
    return ForaResult(pi=pi, push_iters=int(push.iters), walks_used=walks,
                      residual_mass=r_sum,
                      walks_short=np.ceil(r_sum * rp.omega) > walks)
