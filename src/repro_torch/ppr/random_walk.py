"""Vectorised alpha-terminated random walks (FORA phase 2).

* **Starts**: W walker start nodes per query, sampled proportional to the
  residual by inverse CDF (cumsum + searchsorted) from W uniforms.
* **Steps**: walks advance in lockstep for L steps; L =
  ceil(ln(tail)/ln(1-alpha)) bounds the truncated mass by ``tail``.
* **Transition**: uniform out-neighbour via the CSR gather
  ``edge_dst[offsets[v] + u % deg(v)]``.
* **Randomness**: one int32 draw u in [0, 2^30) per (step, walker) decides
  both the Bernoulli(alpha) stop (``u < floor(alpha * 2^30)``) and the
  neighbour (``u % deg``), as in ``repro.ppr.random_walk``.

Every random stage takes its draws as tensors from a :class:`WalkDraws`:
:class:`TableDraws` replays given tables (the tests feed the JAX package's
draws through it), :class:`QueryDraws` draws from one ``torch.Generator``
per query, seeded from (workload seed, query id), so that a query's walks
do not depend on the batch it runs in. Step draws are made one step at a
time: an (L, B, W) table would not fit at the budgets FORA asks for.

Estimate: endpoints accumulate weight r_sum / W, which gives FORA's
unbiased estimator pi_hat = pi_push + sum_v r(v) * (MC endpoint dist).
The endpoint fold is ``index_add_``, which sums with atomics on a card:
the order of those float sums, and so the last bits, vary between runs.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence
from typing import Protocol

import numpy as np
import torch

STEP_DRAW_BOUND = 1 << 30


def walk_length_for_tail(alpha: float, tail: float = 1e-4) -> int:
    """Smallest L with (1-alpha)^L <= tail (truncation mass bound)."""
    if not 0.0 < alpha < 1.0:
        raise ValueError("alpha in (0,1)")
    return int(np.ceil(np.log(tail) / np.log(1.0 - alpha)))


def _stop_bound(alpha: float) -> int:
    """Bernoulli(alpha) stop threshold on the shared int32 draw."""
    return int(np.floor(alpha * STEP_DRAW_BOUND))


class WalkDraws(Protocol):
    """Random numbers of one block of walks: B queries by W lanes."""

    def start_uniforms(self) -> torch.Tensor:
        """(B, W) float32 uniforms in [0, 1) for the start sampling."""

    def step(self, t: int) -> torch.Tensor:
        """(B, W) int32 draws in [0, 2^30) for step ``t``."""


class TableDraws:
    """Draws replayed from given tables: ``starts`` (B, W) uniforms and
    ``steps`` (L, B, W) int32."""

    def __init__(self, starts: torch.Tensor, steps: torch.Tensor) -> None:
        if starts.dim() != 2 or steps.dim() != 3 \
                or steps.shape[1:] != starts.shape:
            raise ValueError("need starts (B, W) and steps (L, B, W)")
        self.starts = starts
        self.steps = steps

    def start_uniforms(self) -> torch.Tensor:
        return self.starts

    def step(self, t: int) -> torch.Tensor:
        return self.steps[t]


def query_generator_seed(seed: int, qid: int) -> int:
    """64-bit generator seed of query ``qid``'s stream in a workload."""
    return int(np.random.SeedSequence([seed, qid]).generate_state(
        1, dtype=np.uint64)[0])


class QueryDraws:
    """One ``torch.Generator`` per query on ``device``, seeded from
    (``seed``, query id): the start uniforms come first, then one (W,)
    draw per step, so a query's stream is the same in any batch."""

    def __init__(self, seed: int, query_ids: Sequence[int], num_walks: int,
                 device: torch.device) -> None:
        self.num_walks = num_walks
        self.device = device
        self.generators = [
            torch.Generator(device=device).manual_seed(
                query_generator_seed(seed, int(q))) for q in query_ids]

    @staticmethod
    def _rows(rows: list[torch.Tensor]) -> torch.Tensor:
        return rows[0][None] if len(rows) == 1 else torch.stack(rows)

    def start_uniforms(self) -> torch.Tensor:
        return self._rows([
            torch.rand((self.num_walks,), generator=g, device=self.device)
            for g in self.generators])

    def step(self, t: int) -> torch.Tensor:
        return self._rows([
            torch.randint(0, STEP_DRAW_BOUND, (self.num_walks,), generator=g,
                          device=self.device, dtype=torch.int32)
            for g in self.generators])


def _advance(edge_dst, out_offsets, deg, stop_bound, pos, alive, u_step):
    """One lockstep walk transition; ``pos`` may be any shape ``u_step``
    broadcasts against."""
    stop = u_step < stop_bound
    nxt = edge_dst[out_offsets[pos] + (u_step % deg[pos])]
    new_alive = alive & ~stop
    return torch.where(new_alive, nxt, pos), new_alive


def walk_endpoints(edge_dst: torch.Tensor, out_offsets: torch.Tensor,
                   out_degree: torch.Tensor, starts: torch.Tensor,
                   us: Iterable[torch.Tensor], *, alpha: float
                   ) -> torch.Tensor:
    """Endpoints of alpha-terminated walks under explicit step draws.

    ``starts`` (..., W) int32; ``us`` yields one int32 draw tensor per step
    (a (num_steps, ..., W) tensor, or draws made step by step), each
    broadcast against ``starts``."""
    deg = torch.clamp(out_degree, min=1).to(torch.int32)
    bound = _stop_bound(alpha)
    pos, alive = starts, torch.ones(starts.shape, dtype=torch.bool,
                                    device=starts.device)
    for u_step in us:
        pos, alive = _advance(edge_dst, out_offsets, deg, bound, pos, alive,
                              u_step)
    return pos


def starts_from_cdf(csum: torch.Tensor, u: torch.Tensor, r_sum: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Inverse-CDF walk starts: for uniforms ``u`` (..., W) the first node
    whose cumulative residual ``csum`` (..., n) reaches u * r_sum."""
    target = u * r_sum[..., None]
    starts = torch.searchsorted(csum, target, side="left", out_int32=True)
    return torch.clamp(starts, 0, n - 1)


def sample_walk_starts(residual: torch.Tensor, u: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Starts (..., W) int32 sampled proportional to each row of
    ``residual`` (..., n) from the uniforms ``u``; and the rows' r_sum."""
    r_sum = residual.sum(dim=-1)
    csum = torch.cumsum(residual, dim=-1)
    return starts_from_cdf(csum, u, r_sum, residual.shape[-1]), r_sum


def residual_walks(edge_dst: torch.Tensor, out_offsets: torch.Tensor,
                   out_degree: torch.Tensor, residual: torch.Tensor,
                   draws: WalkDraws, *, alpha: float, num_walks: int,
                   num_steps: int,
                   active_walks: torch.Tensor | None = None) -> torch.Tensor:
    """Monte-Carlo estimate of sum_v r(v) * pi(v, t) for each row of the
    (B, n) ``residual``; returns (B, n) endpoint mass.

    ``num_walks`` W is the lane count; ``active_walks`` (B,) int, in
    [1, W] after clipping, is each row's effective budget: lane i carries
    weight r_sum / active_walks iff i < active_walks, else 0.
    """
    B, n = residual.shape
    starts, r_sum = sample_walk_starts(residual, draws.start_uniforms())
    if starts.shape != (B, num_walks):
        raise ValueError(f"draws give {tuple(starts.shape)} starts, "
                         f"need ({B}, {num_walks})")
    pos = walk_endpoints(edge_dst, out_offsets, out_degree, starts,
                         (draws.step(t) for t in range(num_steps)),
                         alpha=alpha)
    if active_walks is None:
        weights = (r_sum / num_walks)[:, None].expand(B, num_walks)
    else:
        act = torch.clamp(active_walks, 1, num_walks).to(residual.dtype)
        lane = torch.arange(num_walks, device=residual.device)
        weights = torch.where(lane[None, :] < act[:, None],
                              (r_sum / act)[:, None], 0.0)
    flat = pos.long() + torch.arange(B, device=pos.device)[:, None] * n
    out = torch.zeros(B * n, dtype=residual.dtype, device=residual.device)
    out.index_add_(0, flat.reshape(-1), weights.reshape(-1))
    return out.view(B, n)
