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
at readout. :func:`fora` is the legacy path that reads the residual mass
back to choose the walk count on the host.
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .forward_push import forward_push, forward_push_np, one_hot_seeds
from .graph import DeviceGraph, Graph
from .random_walk import (QueryDraws, WalkDraws, residual_walks,
                          walk_length_for_tail)

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


class FusedForaResult(NamedTuple):
    """Device-resident FORA result; reading ``pi`` is the caller's sync."""

    pi: torch.Tensor              # (B, n) PPR estimates
    residual_mass: torch.Tensor   # (B,) r_sum after push
    push_iters: torch.Tensor      # () int32
    walks_effective: torch.Tensor  # (B,) int32 power-of-two budgets
    walks_budget: int             # lane count W of the walk phase


def _pow2_ceil_host(v: int) -> int:
    return 1 << (max(1, int(v)) - 1).bit_length()


def default_walk_budget(rp: ResolvedFora) -> int:
    """Walk lane count when no calibrated budget is given: the worst case
    r_sum = 1 (pushes cannot increase the total residual mass)."""
    return _pow2_ceil_host(min(rp.max_walks, math.ceil(rp.omega)))


def fora_fused(dg: DeviceGraph, sources, params: ForaParams = ForaParams(),
               seed: int = 0, *, num_walks: int | None = None,
               query_ids: Sequence[int] | None = None,
               draws: WalkDraws | None = None,
               device: str | torch.device = "cuda") -> FusedForaResult:
    """FORA for a block of B sources on a :class:`DeviceGraph` that lives
    on ``device``.

    ``num_walks`` is the walk lane count (a workload-calibrated budget from
    :class:`~repro_torch.ppr.executor.ForaExecutor`; by default the worst
    case r_sum = 1), rounded up to a power of two. Each row's effective
    budget is pow2(ceil(r_sum * omega)) clipped to it, computed on the
    device. The walks draw from ``draws`` when given (the tests replay the
    JAX package's draws), else from one generator per query seeded from
    (``seed``, query id); ``query_ids`` default to the row positions.
    """
    dev = resolve_device(device)
    if dg.device != dev:
        raise ValueError(f"graph lives on {dg.device}, call asked for {dev}")
    rp = params.resolve(dg)
    num_walks = _pow2_ceil_host(default_walk_budget(rp) if num_walks is None
                                else num_walks)
    steps = walk_length_for_tail(rp.alpha, rp.walk_tail)
    seeds = one_hot_seeds(sources, dg.n, dev)
    B = seeds.shape[0]
    push = forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                        dg.out_degree, seeds, alpha=rp.alpha, rmax=rp.rmax,
                        max_iters=MAX_PUSH_ITERS, row_map=dg.in_row_map)
    r_sum = push.r.sum(dim=1)                                # (B,)
    need = torch.clamp(torch.ceil(r_sum * rp.omega), min=1.0)
    w_eff = torch.exp2(torch.ceil(torch.log2(need)))
    w_eff = torch.clamp(w_eff, 1.0, float(num_walks)).to(torch.int32)
    if draws is None:
        qids = range(B) if query_ids is None else query_ids
        if len(qids) != B:
            raise ValueError(f"{len(qids)} query ids for {B} sources")
        draws = QueryDraws(seed, qids, num_walks, dev)
    endpoint = residual_walks(dg.edge_dst, dg.out_offsets, dg.out_degree,
                              push.r, draws, alpha=rp.alpha,
                              num_walks=num_walks, num_steps=steps,
                              active_walks=w_eff)
    return FusedForaResult(pi=push.pi + endpoint, residual_mass=r_sum,
                           push_iters=push.iters, walks_effective=w_eff,
                           walks_budget=num_walks)


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
                      residual_mass=r_sum)
