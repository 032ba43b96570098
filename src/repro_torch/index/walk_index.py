"""Device-resident table of pre-drawn walk endpoints (FORA+).

FORA answers every query with fresh alpha-terminated walks from the push
residual. The walks can instead be drawn once per graph and reused: a
walk's endpoint is a function of its start node and its lane's stream, so
a table of endpoints per node turns the walk phase into a gather
(kernel K3, :func:`repro_torch.kernels.ops.walk_endpoint_gather`).

``WalkIndex`` holds, on one device:

* ``endpoints (n, width) int32``: entry (v, i) is the endpoint of a walk
  from v on lane i's stream (:class:`~repro_torch.ppr.random_walk.LaneDraws`).
  A lane's draws do not depend on the start node or on how many lanes are
  drawn, so the stored endpoint is the one a live walker on lane i reaches
  from v, bit for bit: both go through
  :func:`~repro_torch.ppr.random_walk.walk_endpoints`.
* ``budget (n,) int32``: per node, the lanes that are valid. A query lane
  i starting at v is served from the table iff ``i < budget[v]``, else it
  walks live on the same stream. ``retire`` lowers budgets; ``refresh``
  redraws rows on fresh streams (salted by the ``refreshed`` counter).

Trajectories are shared by every query of a block (the FORA+ trade);
per-query randomness stays in the residual-proportional start sampling.
``graph_version`` tags the structure the endpoints were walked on.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, ClassVar

import numpy as np
import torch

from .._device import resolve_device
from ..ppr.random_walk import (LaneDraws, LaneStreams, walk_endpoints,
                               walk_length_for_tail)

# walker cells (rows x lanes) stepped together while building, unless a
# lane block is given: bounds the walker state to ~2^24 cells
BUILD_CELLS = 1 << 24


def walk_rows(graph_arrays: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              nodes: torch.Tensor, streams: LaneDraws, width: int, *,
              alpha: float, num_steps: int,
              lane_block: int | None = None) -> torch.Tensor:
    """Endpoints (len(nodes), width) int32: every node of ``nodes`` walks
    every lane of [0, width) down its stream, ``lane_block`` lanes at a
    time (by default as many as keep ``BUILD_CELLS`` walkers), on the
    device of ``graph_arrays`` (edge_dst, out_offsets, out_degree)."""
    edge_dst = graph_arrays[0]
    nodes = nodes.to(device=edge_dst.device, dtype=torch.int32)
    if lane_block is None:
        lane_block = max(1, BUILD_CELLS // max(1, nodes.shape[0]))
    if lane_block < 1:
        raise ValueError("lane_block must be >= 1")
    out = torch.empty((nodes.shape[0], width), dtype=torch.int32,
                      device=edge_dst.device)
    for lo in range(0, width, lane_block):
        lanes = torch.arange(lo, min(lo + lane_block, width),
                             device=edge_dst.device)
        grid = nodes[:, None].expand(nodes.shape[0], lanes.shape[0])
        out[:, lo:lo + lanes.shape[0]] = walk_endpoints(
            *graph_arrays, grid, streams.steps(lanes, num_steps),
            alpha=alpha)
    return out


@dataclass(eq=False)
class WalkIndex:
    """Budgeted per-node table of pre-drawn walk endpoints (tensors)."""

    n: int
    width: int                 # stored lanes per node
    alpha: float
    num_steps: int             # truncation length the endpoints used
    streams: LaneDraws         # lane streams of the table and live lanes
    endpoints: torch.Tensor    # (n, width) int32
    budget: torch.Tensor       # (n,) int32
    # CSR walk arrays (edge_dst, out_offsets, out_degree) bound at build
    # time, so that refresh() can redraw rows
    graph_arrays: tuple = field(repr=False, default=())
    graph_version: int = 0
    refreshed: int = 0         # rows redrawn off the base streams
    _partial: bool = field(default=False, repr=False)

    builds: ClassVar[int] = 0  # constructions (the build-once contract)

    @classmethod
    def build(cls, dg: Any, *, width: int, alpha: float,
              walk_tail: float = 1e-4, seed: int = 0,
              streams: LaneDraws | None = None, graph_version: int = 0,
              lane_block: int | None = None) -> "WalkIndex":
        """Walk every node down every lane stream once, on the device of
        ``dg`` (a :class:`~repro_torch.ppr.graph.DeviceGraph`).
        ``streams`` defaults to ``LaneStreams(seed)``; ``alpha`` and
        ``walk_tail`` must match the queries' FORA params, which
        :func:`~repro_torch.ppr.fora.fora_fused` checks."""
        if width < 1:
            raise ValueError("width must be >= 1")
        num_steps = walk_length_for_tail(alpha, walk_tail)
        streams = (LaneStreams(seed) if streams is None
                   else streams).to(dg.device)
        arrays = (dg.edge_dst, dg.out_offsets, dg.out_degree)
        endpoints = walk_rows(arrays, torch.arange(dg.n), streams, width,
                              alpha=alpha, num_steps=num_steps,
                              lane_block=lane_block)
        WalkIndex.builds += 1
        return cls(n=dg.n, width=width, alpha=alpha, num_steps=num_steps,
                   streams=streams, endpoints=endpoints,
                   budget=torch.full((dg.n,), width, dtype=torch.int32,
                                     device=dg.device),
                   graph_arrays=arrays, graph_version=graph_version)

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, Any], *, streams: LaneDraws,
                    device: str | torch.device = "cuda") -> "WalkIndex":
        """An index from host arrays: ``endpoints`` (n, width) and
        ``budget`` (n,), e.g. ``np.asarray`` of a ``repro.index.WalkIndex``'s
        fields, with its scalars ``alpha`` and ``num_steps`` and optionally
        ``graph_version``, ``refreshed`` and ``partial``. ``streams`` are
        the lane streams its live lanes walk. Endpoints outside [0, n) or
        budgets outside [0, width] raise. No graph is bound:
        :meth:`rebind` one before :meth:`refresh`."""
        dev = resolve_device(device)
        endpoints = torch.tensor(np.asarray(arrays["endpoints"]),
                                 dtype=torch.int32).to(dev)
        budget = torch.tensor(np.asarray(arrays["budget"]),
                              dtype=torch.int32).to(dev)
        if endpoints.dim() != 2 or budget.shape != endpoints.shape[:1]:
            raise ValueError("need endpoints (n, width) and budget (n,)")
        n, width = endpoints.shape
        # K3 drops a lane whose endpoint lies outside [0, n), where its plain
        # version raises: a table that holds one is refused here
        if endpoints.numel() and not bool(
                ((endpoints >= 0) & (endpoints < n)).all()):
            raise ValueError(f"endpoints must lie in [0, {n})")
        if not bool(((budget >= 0) & (budget <= width)).all()):
            raise ValueError(f"budget must lie in [0, {width}]")
        return cls(n=n, width=width, alpha=float(arrays["alpha"]),
                   num_steps=int(arrays["num_steps"]),
                   streams=streams.to(dev), endpoints=endpoints,
                   budget=budget,
                   graph_version=int(arrays.get("graph_version", 0)),
                   refreshed=int(arrays.get("refreshed", 0)),
                   _partial=bool(arrays.get("partial", False)))

    @property
    def device(self) -> torch.device:
        return self.endpoints.device

    # -- coverage ----------------------------------------------------------
    @property
    def partial(self) -> bool:
        """True once any node's budget dropped below ``width``: the fused
        path then walks every lane live as well, and zero-weights the
        table-covered ones."""
        return self._partial

    @property
    def nbytes(self) -> int:
        return int(self.endpoints.numel() * self.endpoints.element_size()
                   + self.budget.numel() * self.budget.element_size())

    def coverage(self, num_walks: int) -> float:
        """Fraction of a ``num_walks`` walk budget the index saves. A
        partial index reports 0.0: the fused path then walks every lane
        live regardless of how many the table serves, so there is no time
        saved."""
        if num_walks < 1:
            raise ValueError("num_walks must be >= 1")
        if self._partial:
            return 0.0
        return min(1.0, self.width / num_walks)

    # -- maintenance -------------------------------------------------------
    def _nodes(self, nodes) -> torch.Tensor:
        return torch.as_tensor(np.asarray(nodes, dtype=np.int64),
                               device=self.device)

    def rebind(self, dg: Any, graph_version: int | None = None) -> None:
        """Bind the CSR walk arrays of a changed residency: later
        :meth:`refresh` draws walk the new structure, while un-retired rows
        keep serving their draws on the old one."""
        if dg.n != self.n:
            raise ValueError(f"residency has n={dg.n}, index has n={self.n} "
                             "— node additions need a rebuilt index")
        self.graph_arrays = (dg.edge_dst, dg.out_offsets, dg.out_degree)
        if graph_version is not None:
            self.graph_version = int(graph_version)

    def retire(self, nodes, budget: int = 0) -> None:
        """Lower the stored budget of ``nodes``: their lanes at or beyond
        ``budget`` walk live on the same streams, so the answers of an
        unrefreshed index do not change, only the work saved."""
        if not 0 <= budget <= self.width:
            raise ValueError(f"budget must be in [0, {self.width}]")
        idx = self._nodes(nodes)
        if idx.numel() == 0:
            return
        self.budget[idx] = budget
        if budget < self.width:
            self._partial = True

    def refresh(self, nodes) -> None:
        """Redraw the rows of ``nodes`` on fresh streams (salted by the
        running ``refreshed`` count) and restore their full budget. Those
        rows stop matching the live lanes' streams; they stay fair draws."""
        idx = self._nodes(nodes)
        if idx.numel() == 0:
            return
        if not self.graph_arrays:
            raise ValueError("no graph bound: rebind() one first")
        self.refreshed += int(idx.numel())
        fresh = self.streams.fold_in(self.refreshed)
        self.endpoints[idx] = walk_rows(self.graph_arrays, idx, fresh,
                                        self.width, alpha=self.alpha,
                                        num_steps=self.num_steps)
        self.budget[idx] = self.width

    def refresh_hottest(self, nodes, budget: int,
                        heat: dict | None = None) -> np.ndarray:
        """Refresh up to ``budget`` of ``nodes``, hottest first by ``heat``
        (node -> score; unranked nodes score 0 and ties go by node id).
        Returns the refreshed nodes; the rest stay as they are."""
        nodes = np.unique(np.asarray(nodes, dtype=np.int32))
        if budget <= 0 or nodes.size == 0:
            return np.zeros(0, np.int32)
        heat = heat or {}
        ranked = sorted(nodes.tolist(),
                        key=lambda v: (-float(heat.get(int(v), 0.0)), v))
        picked = np.asarray(ranked[:budget], dtype=np.int32)
        self.refresh(picked)
        return picked
