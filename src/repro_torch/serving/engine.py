"""Continuous-batching query engine on the card: a persistent pool of
query lanes, with a query inserted into any free lane between steps and
evicted as soon as it has converged and walked.

D&A's slot model (Alg. 2) grants a job its lanes for a whole slot, so
lanes go idle whenever a job's remaining queries fall below its grant. The
engine keeps one fixed pool of L lanes over the executor's residency
instead, and any admitted query takes the next free lane.

``QueryEngine`` holds the lane state on the executor's device: (L, n)
reserve ``pi`` and residual ``r`` (laid out (n, L), the push's layout, so
a resumed push copies nothing), and the ``active`` and ``walked`` masks
(L,). Each ``step()``

1. resumes :func:`~repro_torch.ppr.forward_push.forward_push` over all L
   lanes for ``sweeps`` sweeps, from the reserve so far (``pi0``), with the
   residency's fold structure or row plan. An idle, converged or walked
   lane has an empty frontier, so a sweep leaves it as it is, and a chain
   of resumed pushes ends on the bits one uninterrupted push ends on;
2. finds the active lanes that have converged and not walked yet;
3. walks only those lanes, each from its own
   :class:`~repro_torch.ppr.random_walk.QueryDraws` ``(seed, [qid], W)``,
   the stream ``ForaExecutor.answer_chunk`` draws for that query, with the
   walk budget the lane adopted at its insertion, and adds the endpoint
   mass to the lane's reserve. (The JAX engine walks all L lanes every
   step and masks the result; here a lane walks once.)

Host syncs of a step that pushes: ``forward_push``'s convergence test,
once every ``CHECK_EVERY`` sweeps (once a step for ``sweeps <= 8``), and
one readback of the (L,) mask of the lanes that walk now, which the host
needs to pick their rows and draws. A step with no lane to push makes
none. ``harvest()`` reads the walked lanes' rows and statistics back and
frees their lanes; ``insert()`` writes a one-hot residual.

A query's row does not depend on its lane, its neighbours in the pool or
the step it converged in: on the CPU it has the bits of its
``answer_chunk`` row; on the card each kernel has one summation order, so
a run repeats bit for bit (the push's kernels lay lanes out by the batch
width, so a card row agrees with a chunk of another width to rounding).

Executors with a walk index are refused: index and cache hits bypass
engine insertion. ``SimLaneEngine`` (:mod:`repro_torch.serving.lanes`) is
the virtual-time twin a serving runtime schedules against.
"""

from __future__ import annotations

import heapq
from collections.abc import Callable, Sequence
from typing import NamedTuple

import numpy as np
import torch

from ..ppr.fora import _pow2_ceil_host
from ..ppr.forward_push import forward_push
from ..ppr.random_walk import (QueryDraws, WalkDraws, residual_walks,
                               walk_length_for_tail)
from .lanes import LaneTask, SimLaneEngine

__all__ = ["HarvestedQuery", "LaneTask", "QueryEngine", "SimLaneEngine"]


class HarvestedQuery(NamedTuple):
    """One walked lane read back at the harvest boundary."""

    qid: int
    lane: int
    pi: np.ndarray             # (n,) PPR row
    walks_effective: int
    residual_mass: float
    # the lane count cut the ceil(r_sum * omega) walks FORA's guarantee
    # asks for: the row is unbiased but noisier, its eps bound does not hold
    walks_short: bool


class _StackedDraws:
    """The draws of several queries, stacked row by row."""

    def __init__(self, parts: Sequence[WalkDraws]) -> None:
        self.parts = list(parts)

    def start_uniforms(self) -> torch.Tensor:
        return torch.cat([p.start_uniforms() for p in self.parts])

    def step(self, t: int) -> torch.Tensor:
        return torch.cat([p.step(t) for p in self.parts])


class QueryEngine:
    """Persistent continuous-batching engine over a fixed lane pool on the
    executor's device.

    ``insert(qid, lane=None)`` places a query in a free lane, ``step()``
    advances every lane, ``harvest()`` returns the walked queries and frees
    their lanes. The walk budget is the executor's at each insertion, and
    with ``adaptive_budget`` a harvest feeds the residual mass it read back
    to the executor. ``draws_of(qid)``, when given, replaces a query's walk
    draws (the tests replay the JAX package's draws through it)."""

    def __init__(self, executor, lanes: int, *, sweeps: int = 4,
                 draws_of: Callable[[int], WalkDraws] | None = None):
        if lanes < 1:
            raise ValueError("engine needs a lane pool of >= 1")
        if sweeps < 1:
            raise ValueError("sweeps must be >= 1")
        if executor.devices > 1:
            raise ValueError("QueryEngine requires a single-device fused "
                             "ForaExecutor")
        if executor.index_budget or executor.walk_index is not None:
            raise ValueError("walk-index lanes are a chunked-path "
                             "acceleration; index and cache hits bypass "
                             "engine insertion instead")
        executor.warmup()
        self.executor = executor
        self.lanes = int(lanes)
        self.sweeps = int(sweeps)
        self._draws_of = draws_of
        dg = executor.device_graph
        self._dg = dg
        self._rp = executor.params.resolve(dg)
        self._steps = walk_length_for_tail(self._rp.alpha,
                                           self._rp.walk_tail)
        dev = dg.device
        self._dev = dev
        self._pi = torch.zeros((dg.n, self.lanes), device=dev).t()
        self._r = torch.zeros((dg.n, self.lanes), device=dev).t()
        # forward_push's push condition, r > rmax * max(deg, 1)
        self._threshold = self._rp.rmax * torch.clamp(
            dg.out_degree.to(torch.float32), min=1.0)
        self._active = torch.zeros(self.lanes, dtype=torch.bool, device=dev)
        self._walked = torch.zeros_like(self._active)
        self._w_eff = torch.zeros(self.lanes, dtype=torch.int32, device=dev)
        self._r_sum = torch.zeros(self.lanes, device=dev)
        self._short = torch.zeros_like(self._active)
        self._occupant: dict[int, int] = {}      # lane -> qid
        self._budget: dict[int, int] = {}        # lane -> walk lane count
        self._walked_lanes: set[int] = set()
        self._free = list(range(self.lanes))
        heapq.heapify(self._free)
        self.steps = 0
        self.inserted = 0
        self.harvested = 0

    # -- occupancy ---------------------------------------------------------
    @property
    def busy(self) -> int:
        return len(self._occupant)

    @property
    def free(self) -> int:
        return self.lanes - len(self._occupant)

    def occupants(self) -> dict[int, int]:
        return dict(self._occupant)

    # -- lifecycle ---------------------------------------------------------
    def insert(self, qid: int, lane: int | None = None) -> int:
        """Place query ``qid`` in a free lane (the lowest when ``lane`` is
        None) with a one-hot residual at its source and the executor's
        current walk budget. Returns the lane."""
        source = self.executor.workload.source_of(qid)
        if lane is None:
            if not self._free:
                raise RuntimeError("no free lane")
            lane = heapq.heappop(self._free)
        else:
            if lane in self._occupant:
                raise RuntimeError(f"lane {lane} is occupied")
            if not 0 <= lane < self.lanes:
                raise ValueError(f"lane {lane} outside [0, {self.lanes})")
            self._free.remove(lane)
            heapq.heapify(self._free)
        self._budget[lane] = _pow2_ceil_host(
            self.executor.current_walk_budget())
        self._pi[lane] = 0.0
        self._r[lane] = 0.0
        self._r[lane, source] = 1.0
        self._active[lane] = True
        self._walked[lane] = False
        self._occupant[lane] = qid
        self.inserted += 1
        return lane

    def step(self) -> None:
        """Advance the pool one step: ``sweeps`` push sweeps over every
        lane, then the walks of the lanes that converged in it. Syncs with
        the host at the push's convergence test and at one readback of the
        (L,) mask of the lanes that walk now."""
        self.steps += 1
        if all(lane in self._walked_lanes for lane in self._occupant):
            return
        dg, rp = self._dg, self._rp
        push = forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                            dg.out_degree, self._r, alpha=rp.alpha,
                            rmax=rp.rmax, max_iters=self.sweeps,
                            row_map=dg.in_row_map, fold=dg.in_fold,
                            plan=dg.in_plan, pi0=self._pi)
        self._pi, self._r = push.pi, push.r
        converged = ~(self._r > self._threshold).any(dim=1)
        now = self._active & ~self._walked & converged
        lanes = [lane for lane, walk in enumerate(now.tolist()) if walk]
        if lanes:
            self._walk(lanes)

    def _walk(self, lanes: list[int]) -> None:
        """The walk phase of ``lanes``, grouped by walk budget, as
        ``fora_fused`` runs it for a chunk of their queries."""
        dg, rp = self._dg, self._rp
        groups: dict[int, list[int]] = {}
        for lane in lanes:
            groups.setdefault(self._budget[lane], []).append(lane)
        for W, group in sorted(groups.items()):
            qids = [self._occupant[lane] for lane in group]
            idx = torch.tensor(group, device=self._dev)
            # contiguous rows, as fora_fused sums them
            r = self._r.index_select(0, idx).contiguous()
            r_sum = r.sum(dim=1)
            need = torch.clamp(torch.ceil(r_sum * rp.omega), min=1.0)
            w_eff = torch.exp2(torch.ceil(torch.log2(need)))
            w_eff = torch.clamp(w_eff, 1.0, float(W)).to(torch.int32)
            if self._draws_of is None:
                draws = QueryDraws(self.executor.workload.seed, qids, W,
                                   self._dev)
            else:
                draws = _StackedDraws([self._draws_of(q) for q in qids])
            endpoint = residual_walks(dg.edge_dst, dg.out_offsets,
                                      dg.out_degree, r, draws,
                                      alpha=rp.alpha, num_walks=W,
                                      num_steps=self._steps,
                                      active_walks=w_eff)
            self._pi.index_copy_(0, idx,
                                 self._pi.index_select(0, idx) + endpoint)
            self._w_eff.index_copy_(0, idx, w_eff)
            self._r_sum.index_copy_(0, idx, r_sum)
            self._short.index_copy_(0, idx, need > w_eff)
            self._walked.index_fill_(0, idx, True)
            self._walked_lanes.update(group)

    def harvest(self) -> list[HarvestedQuery]:
        """Read back the walked lanes' rows and statistics and free their
        lanes (their rows are zeroed: an empty lane is an identity under
        every sweep). Empty list when no lane has walked."""
        lanes = sorted(self._walked_lanes)
        if not lanes:
            return []
        idx = torch.tensor(lanes, device=self._dev)
        rows = self._pi.index_select(0, idx).cpu().numpy()
        weff = self._w_eff.index_select(0, idx).tolist()
        rmass = self._r_sum.index_select(0, idx).tolist()
        short = self._short.index_select(0, idx).tolist()
        self._pi.index_fill_(0, idx, 0.0)
        self._r.index_fill_(0, idx, 0.0)
        self._active.index_fill_(0, idx, False)
        self._walked.index_fill_(0, idx, False)
        out = []
        for i, lane in enumerate(lanes):
            qid = self._occupant.pop(lane)
            del self._budget[lane]
            heapq.heappush(self._free, lane)
            out.append(HarvestedQuery(qid=qid, lane=lane, pi=rows[i],
                                      walks_effective=int(weff[i]),
                                      residual_mass=float(rmass[i]),
                                      walks_short=bool(short[i])))
        self._walked_lanes.clear()
        self.harvested += len(out)
        if self.executor.adaptive_budget:
            # the engine's counterpart of run_chunk's observation: the
            # worst residual mass read back feeds the budget EWMA
            self.executor.observe_residual_mass(
                max(h.residual_mass for h in out))
        return out

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> list[HarvestedQuery]:
        """Step and harvest until the pool is empty."""
        out = []
        for _ in range(max_steps):
            if not self._occupant:
                return out
            self.step()
            out.extend(self.harvest())
        raise RuntimeError("engine failed to drain the lane pool")
