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

The walk index walks on *lane streams* instead (:class:`LaneDraws`): lane
i's draw at step t depends on (stream key, i, t) alone, shared by every
query of a block, so that a stored endpoint equals the endpoint a live
walker reaches on the same lane. :class:`LaneStreams` computes the draws
with a counter-based hash in tensor ops (the same values on the CPU and
the card, for any subset of lanes); :class:`TableLaneStreams` replays a
given (L, W) table (the tests feed the JAX package's ``lane_streams``).

Estimate: endpoints accumulate weight r_sum / W, which gives FORA's
unbiased estimator pi_hat = pi_push + sum_v r(v) * (MC endpoint dist).
The endpoint fold is ``index_add_``, which sums with atomics on a card:
the order of those float sums, and so the last bits, vary between runs.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator, Sequence
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


_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15       # splitmix64's increment
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
LANE_STEP_BITS = 16                # a lane's counters: steps < 2^16


def _signed64(v: int) -> int:
    """The int64 with the bits of ``v`` mod 2^64 (torch has no uint64
    arithmetic; int64 products and sums wrap the same way)."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


def _fmix64(z: int) -> int:
    """splitmix64's output mix on a Python int."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
    return z ^ (z >> 31)


def _fmix64_(z: torch.Tensor) -> torch.Tensor:
    """:func:`_fmix64` in place on an int64 tensor: right shifts of int64
    are arithmetic, so each is masked to its logical bits."""
    z.bitwise_xor_((z >> 30) & ((1 << 34) - 1))
    z.mul_(_signed64(_MIX1))
    z.bitwise_xor_((z >> 27) & ((1 << 37) - 1))
    z.mul_(_signed64(_MIX2))
    z.bitwise_xor_((z >> 31) & ((1 << 33) - 1))
    return z


class LaneDraws(Protocol):
    """Per-lane step draws shared by every query of a block."""

    def steps(self, lanes: torch.Tensor, num_steps: int
              ) -> Iterator[torch.Tensor]:
        """One (len(lanes),) int32 draw in [0, 2^30) per step, for the
        lane ids ``lanes`` on their device."""

    def fold_in(self, data: int) -> "LaneDraws":
        """Fresh streams salted by ``data``."""

    def to(self, device: torch.device) -> "LaneDraws":
        """The same streams, drawn on ``device``."""


class LaneStreams:
    """Counter-based lane streams: the draw of lane i at step t is the top
    30 bits of splitmix64's output number ``i * 2^16 + t + 1`` from the
    stream's 64-bit key, ``fmix64(key + (i * 2^16 + t + 1) * golden)``.
    A draw is a function of (key, i, t) alone, so any subset of lanes, in
    any order or block size, gets the same values, on the CPU and on the
    card alike. ``fold_in`` salts the key, as ``jax.random.fold_in`` does a
    JAX key."""

    def __init__(self, seed: int = 0, *, key: int | None = None) -> None:
        self.key = _fmix64(seed + _GOLDEN) if key is None else key & _MASK64

    def fold_in(self, data: int) -> "LaneStreams":
        return LaneStreams(key=_fmix64((self.key ^ _fmix64(data)) + _GOLDEN))

    def to(self, device: torch.device) -> "LaneStreams":
        return self

    def steps(self, lanes: torch.Tensor, num_steps: int
              ) -> Iterator[torch.Tensor]:
        if num_steps >= 1 << LANE_STEP_BITS:
            raise ValueError(f"num_steps must be < 2^{LANE_STEP_BITS}")
        base = (lanes.long() * _signed64(_GOLDEN << LANE_STEP_BITS)
                + _signed64(self.key + _GOLDEN))
        for t in range(num_steps):
            z = _fmix64_(base + _signed64(t * _GOLDEN))
            yield ((z >> 34) & (STEP_DRAW_BOUND - 1)).to(torch.int32)


class TableLaneStreams:
    """Lane streams replayed from a given (L, W) int32 table: lane i's draw
    at step t is ``table[t, i]``."""

    def __init__(self, table: torch.Tensor) -> None:
        if table.dim() != 2 or table.dtype != torch.int32:
            raise ValueError("need an (L, W) int32 table")
        self.table = table

    def fold_in(self, data: int) -> "TableLaneStreams":
        raise ValueError("a replayed lane table has no fresh streams")

    def to(self, device: torch.device) -> "TableLaneStreams":
        return TableLaneStreams(self.table.to(device))

    def steps(self, lanes: torch.Tensor, num_steps: int
              ) -> Iterator[torch.Tensor]:
        if num_steps > self.table.shape[0]:
            raise ValueError(f"table has {self.table.shape[0]} steps, "
                             f"{num_steps} asked")
        idx = lanes.long()
        for t in range(num_steps):
            yield self.table[t].index_select(0, idx)


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
    return fold_endpoints(pos, lane_weights(r_sum, num_walks, active_walks),
                          n)


def lane_weights(r_sum: torch.Tensor, num_walks: int,
                 active_walks: torch.Tensor | None = None) -> torch.Tensor:
    """(B, W) walk weights: r_sum / W on every lane, or with
    ``active_walks`` (B,) (clipped to [1, W]) r_sum / active_walks on the
    lanes below it and 0 beyond."""
    if active_walks is None:
        return (r_sum / num_walks)[:, None].expand(r_sum.shape[0], num_walks)
    act = torch.clamp(active_walks, 1, num_walks).to(r_sum.dtype)
    lane = torch.arange(num_walks, device=r_sum.device)
    return torch.where(lane[None, :] < act[:, None], (r_sum / act)[:, None],
                       0.0)


def fold_endpoints(pos: torch.Tensor, weights: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(B, n) endpoint mass: each lane's weight added at its endpoint
    ``pos`` (B, W'), by ``index_add_``."""
    B = pos.shape[0]
    flat = pos.long() + torch.arange(B, device=pos.device)[:, None] * n
    out = torch.zeros(B * n, dtype=weights.dtype, device=weights.device)
    out.index_add_(0, flat.reshape(-1), weights.reshape(-1))
    return out.view(B, n)
