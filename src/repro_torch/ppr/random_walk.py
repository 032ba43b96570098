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
The endpoint fold is ``ops.endpoint_fold``: on the card a kernel with one
summation order a cell, fixed by the lanes, so a query's row has the same
bits on every run; on the CPU ``index_add_``, lane by lane.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator, Sequence
from typing import TYPE_CHECKING, NamedTuple, Protocol

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import ops

if TYPE_CHECKING:
    from .graph import Graph

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


def scan_prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last dim of ``x`` by a Hillis-Steele
    scan: log2(n) rounds of elementwise adds, ``out[i] += out[i - d]`` for
    d = 1, 2, 4, ..., so every sum has one order, fixed by the positions."""
    out = x.contiguous()
    d = 1
    while d < out.shape[-1]:
        nxt = out.clone()
        nxt[..., d:] += out[..., :-d]
        out = nxt
        d *= 2
    return out


def cumulative_residual(residual: torch.Tensor) -> torch.Tensor:
    """The cumulative residual of each row (..., n), the walks' start CDF.
    On the CPU ``torch.cumsum``, which adds in order. On the card
    :func:`scan_prefix_sums`: ``torch.cumsum`` there may combine a row's
    blocks in an order that changes from run to run, and a start at a CDF
    boundary would then move between runs of one query."""
    if residual.device.type == "cuda":
        return scan_prefix_sums(residual)
    return torch.cumsum(residual, dim=-1)


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
    ``residual`` (..., n) from the uniforms ``u``; and the rows' r_sum,
    summed over contiguous rows so that a row's bits do not depend on the
    layout or the batch it comes in."""
    residual = residual.contiguous()
    r_sum = residual.sum(dim=-1)
    csum = cumulative_residual(residual)
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
    ``pos`` (B, W'), through ``ops.endpoint_fold``: on the card in one
    summation order, fixed by the lanes; on the CPU by ``index_add_``."""
    return ops.endpoint_fold(pos, weights, n)


class WalkResult(NamedTuple):
    endpoint_mass: torch.Tensor   # (B, n) estimated sum_v r(v) * pi(v, .)
    walks: int                    # lane count W


def residual_walks_batched(graph: "Graph", residual: torch.Tensor,
                           draws: WalkDraws | None = None, *, alpha: float,
                           num_walks: int, tail: float = 1e-4, seed: int = 0,
                           device: str | torch.device = "cuda"
                           ) -> WalkResult:
    """:func:`residual_walks` over each row of ``residual`` (B, n) or (n,)
    on ``graph``'s upload-once residency on ``device``, every lane active.
    The walks draw from ``draws`` when given (the tests replay the JAX
    package's draws), else from one generator per row seeded from
    (``seed``, row)."""
    dev = resolve_device(device)
    dg = graph.device(dev)
    residual = torch.as_tensor(residual, dtype=torch.float32, device=dev)
    if residual.dim() == 1:
        residual = residual[None, :]
    if draws is None:
        draws = QueryDraws(seed, range(residual.shape[0]), num_walks, dev)
    mass = residual_walks(dg.edge_dst, dg.out_offsets, dg.out_degree,
                          residual, draws, alpha=alpha, num_walks=num_walks,
                          num_steps=walk_length_for_tail(alpha, tail))
    return WalkResult(endpoint_mass=mass, walks=num_walks)


class SourceDraws(Protocol):
    """Random numbers of pure Monte Carlo walks: B sources by W walks. A
    step draws a float stop uniform and an int next draw per walk, as the
    JAX package's ``source_walks`` does (one key split a step)."""

    def step(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, W) float32 stop uniforms in [0, 1) and (B, W) int32 next
        draws in [0, 2^30) for step ``t``."""


class TableSourceDraws:
    """Source draws replayed from given tables: ``stops`` (L, B, W) float32
    and ``nexts`` (L, B, W) int32."""

    def __init__(self, stops: torch.Tensor, nexts: torch.Tensor) -> None:
        if stops.dim() != 3 or nexts.shape != stops.shape:
            raise ValueError("need stops and nexts of one (L, B, W) shape")
        self.stops = stops
        self.nexts = nexts

    def step(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self.stops[t], self.nexts[t]


def source_generator_seed(seed: int, index: int) -> int:
    """64-bit generator seed of the ``index``-th source's Monte Carlo
    walks (a stream apart from every query's :func:`query_generator_seed`
    stream)."""
    return int(np.random.SeedSequence([seed, index, 1]).generate_state(
        1, dtype=np.uint64)[0])


class SourceGenerators:
    """One ``torch.Generator`` per source on ``device``, seeded from
    (``seed``, source index): each step draws the (W,) stop uniforms, then
    the (W,) next draws, so a source's walks are the same in any batch."""

    def __init__(self, seed: int, count: int, num_walks: int,
                 device: torch.device, first: int = 0) -> None:
        self.num_walks = num_walks
        self.device = device
        self.generators = [
            torch.Generator(device=device).manual_seed(
                source_generator_seed(seed, first + i)) for i in range(count)]

    def step(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        stops, nexts = [], []
        for g in self.generators:
            stops.append(torch.rand((self.num_walks,), generator=g,
                                    device=self.device))
            nexts.append(torch.randint(0, STEP_DRAW_BOUND, (self.num_walks,),
                                       generator=g, device=self.device,
                                       dtype=torch.int32))
        return torch.stack(stops), torch.stack(nexts)


def source_walk_endpoints(edge_dst: torch.Tensor, out_offsets: torch.Tensor,
                          out_degree: torch.Tensor, sources: torch.Tensor,
                          draws: SourceDraws, *, alpha: float, num_walks: int,
                          num_steps: int) -> torch.Tensor:
    """Endpoints (B, W) int32 of W alpha-terminated walks from each of the
    B ``sources``: a walk stops at a step where its stop uniform is below
    alpha, else moves to out-neighbour ``next % deg``."""
    deg = torch.clamp(out_degree, min=1).to(torch.int32)
    pos = sources.to(torch.int32)[:, None].expand(-1, num_walks).contiguous()
    alive = torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
    for t in range(num_steps):
        stop_u, u_next = draws.step(t)
        nxt = edge_dst[out_offsets[pos] + (u_next % deg[pos])]
        alive = alive & ~(stop_u < alpha)
        pos = torch.where(alive, nxt, pos)
    return pos


def source_walks(edge_dst: torch.Tensor, out_offsets: torch.Tensor,
                 out_degree: torch.Tensor, sources: torch.Tensor,
                 draws: SourceDraws, *, alpha: float, n: int, num_walks: int,
                 num_steps: int) -> torch.Tensor:
    """Pure Monte Carlo PPR from each of the B ``sources``: (B, n), the
    share of its W walks that end at each node."""
    pos = source_walk_endpoints(edge_dst, out_offsets, out_degree, sources,
                                draws, alpha=alpha, num_walks=num_walks,
                                num_steps=num_steps)
    weights = torch.full(pos.shape, 1.0 / num_walks, dtype=torch.float32,
                         device=pos.device)
    return fold_endpoints(pos, weights, n)
