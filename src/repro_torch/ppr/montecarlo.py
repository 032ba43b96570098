"""Pure Monte Carlo PPR, the baseline FORA improves upon.

Runs W alpha-terminated walks from each source; pi_hat(t) is the share of
them that end at t. The walk count for the same (eps, delta, p_f)
guarantee is FORA's omega with r_sum = 1,

    W >= (2*eps/3 + 2) * ln(2/p_f) / (eps^2 * delta),

capped at ``max_walks``: the push phase cuts it by the factor r_sum << 1,
the saving the paper's workload inherits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from .fora import ForaParams
from .graph import Graph
from .random_walk import (SourceDraws, SourceGenerators, source_walks,
                          walk_length_for_tail)


def monte_carlo_ppr(graph: Graph, sources, params: ForaParams = ForaParams(),
                    seed: int = 0, num_walks: int | None = None, *,
                    draws: SourceDraws | None = None,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Monte Carlo PPR rows (len(sources), n) float32 on the host, walked on
    ``graph``'s residency on ``device``, one source at a time. The walk
    count is ``num_walks``, by default ``min(max_walks, ceil(omega))``.
    Source i draws from its own generator seeded from (``seed``, i), or
    from ``draws`` (B sources, replayed: the tests feed the JAX package's
    draws through it)."""
    dev = resolve_device(device)
    rp = params.resolve(graph)
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    walks = num_walks if num_walks is not None else \
        int(min(rp.max_walks, math.ceil(rp.omega)))
    steps = walk_length_for_tail(rp.alpha, rp.walk_tail)
    dg = graph.device(dev)
    out = np.empty((sources.size, graph.n), dtype=np.float32)
    for i, s in enumerate(sources):
        src = torch.tensor([int(s)], device=dev)
        if draws is None:
            row_draws = SourceGenerators(seed, 1, walks, dev, first=i)
        else:
            row_draws = _Row(draws, i)
        row = source_walks(dg.edge_dst, dg.out_offsets, dg.out_degree, src,
                           row_draws, alpha=rp.alpha, n=graph.n,
                           num_walks=walks, num_steps=steps)
        out[i] = row[0].cpu().numpy()
    return out


class _Row:
    """Row ``i`` of B sources' draws, as the draws of one source."""

    def __init__(self, draws: SourceDraws, i: int) -> None:
        self.draws = draws
        self.i = i

    def step(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        stops, nexts = self.draws.step(t)
        return stops[self.i:self.i + 1], nexts[self.i:self.i + 1]
