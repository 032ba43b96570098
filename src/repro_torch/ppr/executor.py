"""Bridges the PPR engine to the D&A core (the paper's experiment plumbing).

``ForaExecutor`` satisfies the D&A executor interface
(:data:`repro_torch.core.slots.Executor`): given query ids it runs each
query through :func:`~repro_torch.ppr.fora.fora_fused` and returns the
**measured** per-query wall times. A query id maps to a source vertex
through the workload. One query per call is the paper's one-query-per-core
model; ``block_size > 1`` runs a whole block as one batched device call and
shares the block's time among its queries.

The graph goes to the device once, as a :class:`DeviceGraph`; the walk lane
count is calibrated once per workload from a probe push; every measured
block is one ``fora_fused`` call, timed up to a device synchronisation
after its readout. Each query's walks come from its own generator, seeded
from (workload seed, query id), so its answer does not depend on the block
it runs in. With ``index_budget > 0`` a :class:`~repro_torch.index.WalkIndex`
of that many lanes per node is built once, at warmup, and every block
serves its covered walk lanes from it (the FORA+ mode); ``walk_index``
hands the executor one already built instead. With ``devices=k > 1`` a
slot is a mesh of k devices (the first k cards, or k shards of the CPU)
over one :class:`~repro_torch.ppr.graph.ShardedDeviceGraph`.

The parts a continuous-batching engine calls are here too: ``run_chunk``
(one chunk as one device call), ``answer_chunk`` (a chunk's PPR rows, the
reference engine answers are held to) and the opt-in adaptive walk budget
(``adaptive_budget``: an EWMA of each block's observed worst residual mass
sets the next block's lane count).
"""

from __future__ import annotations

import math
import time
from collections.abc import Sequence
from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING

import numpy as np
import torch

from .._device import resolve_device, synchronize
from ..core.estimator import RuntimeStats
from .fora import (FusedForaResult, ForaParams, _pow2_ceil_host,
                   default_walk_budget, fora_fused, shard_lanes)
from .forward_push import forward_push_np
from .graph import DeviceGraph, DeviceMesh, Graph, ShardedDeviceGraph

if TYPE_CHECKING:
    from ..index import WalkIndex


@dataclass
class PprWorkload:
    """X queries = X source vertices, deterministic per seed."""

    graph: Graph
    num_queries: int
    seed: int = 0
    sources: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        self.sources = rng.integers(0, self.graph.n, size=self.num_queries,
                                    dtype=np.int64)

    def source_of(self, qid: int) -> int:
        """Source vertex of query ``qid``; out-of-range ids raise."""
        if not 0 <= qid < self.num_queries:
            raise IndexError(
                f"query id {qid} out of range [0, {self.num_queries})")
        return int(self.sources[qid])


@dataclass
class ForaExecutor:
    """Measured executor: wall-clocks FORA per query (paper mode) or per
    block (vectorised mode) on ``device``. A warmup run builds the kernels,
    uploads the graph and calibrates the walk budget before any measured
    query, mirroring the paper's steady-state measurements."""

    workload: PprWorkload
    params: ForaParams = field(default_factory=ForaParams)
    block_size: int = 1            # 1 = paper-faithful
    device: str | torch.device = "cuda"
    fused: bool = True             # the port has the fused query only
    devices: int = 1               # >1: a slot is a mesh of k devices
    walk_safety: float = 1.0       # calibration headroom on the probe r_sum
    ell_layout: str = "auto"       # auto|dense|sliced push table
    index_budget: int = 0          # >0: pre-draw a WalkIndex of this many
    #                                lanes per node and serve covered walk
    #                                lanes from it
    index_seed: int = 0
    # a prebuilt index of the workload's graph to serve from; its width
    # stands for index_budget and warmup builds none
    walk_index: "WalkIndex | None" = field(default=None, repr=False)
    adaptive_budget: bool = False  # recalibrate the walk budget per block
    #                                from observed residual mass (EWMA)
    budget_ewma: float = 0.5       # weight of the newest observed r_max
    calls: int = field(default=0, init=False)
    _dev: torch.device = field(init=False, repr=False)
    _warmed: bool = field(default=False, init=False)
    _device_graph: DeviceGraph | ShardedDeviceGraph | None = field(
        default=None, init=False, repr=False)
    _num_walks: int | None = field(default=None, init=False)
    _obs_rmax: float | None = field(default=None, init=False)

    def __post_init__(self) -> None:
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.devices < 1:
            raise ValueError("devices must be >= 1")
        if not self.fused:
            raise ValueError("the port's executor requires the fused hot "
                             "path; the legacy fora() path is "
                             "single-device only")
        if self.index_budget < 0:
            raise ValueError("index_budget must be >= 0")
        if self.walk_safety <= 0:
            raise ValueError("walk_safety must be > 0")
        if self.ell_layout not in ("auto", "dense", "sliced"):
            raise ValueError(f"ell_layout must be auto|dense|sliced, got "
                             f"{self.ell_layout!r}")
        if self.walk_index is not None:
            if self.index_budget not in (0, self.walk_index.width):
                raise ValueError(
                    f"index_budget {self.index_budget} != the given walk "
                    f"index's width {self.walk_index.width}")
            self.index_budget = self.walk_index.width
        if self.index_budget and self.devices > 1:
            raise ValueError("index_budget requires the fused hot path on a "
                             "single-device slot (the sharded residency "
                             "draws walk lanes per shard)")
        self._dev = resolve_device(self.device)

    @property
    def device_graph(self) -> DeviceGraph | ShardedDeviceGraph | None:
        return self._device_graph

    def _build_mesh(self) -> DeviceMesh:
        """The slot's mesh of ``devices`` shards: on CUDA ``devices``
        cards from the executor's own (the first ``devices`` cards for
        ``"cuda"`` on card 0), on the CPU ``devices`` shards of the CPU."""
        if self._dev.type == "cpu":
            return DeviceMesh((self._dev,) * self.devices)
        first = self._dev.index
        present = torch.cuda.device_count() - first
        if self.devices > present:
            raise ValueError(f"devices={self.devices} requested but only "
                             f"{present} present"
                             + (f" from {self._dev}" if first else ""))
        return DeviceMesh(tuple(torch.device("cuda", first + i)
                                for i in range(self.devices)))

    def _block_sources(self, qids: Sequence[int]) -> np.ndarray:
        return np.array([self.workload.source_of(q) for q in qids],
                        dtype=np.int64)

    def _run_block(self, qids: Sequence[int],
                   seed: int | None = None) -> FusedForaResult:
        return fora_fused(self._device_graph, self._block_sources(qids),
                          self.params,
                          self.workload.seed if seed is None else seed,
                          num_walks=self._num_walks, query_ids=qids,
                          index=self.walk_index, device=self._dev)

    def _timed_block(self, qids: Sequence[int], seed: int | None = None
                     ) -> tuple[float, FusedForaResult]:
        t0 = time.perf_counter()
        res = self._run_block(qids, seed)
        synchronize(self._dev)          # the block's readout
        return time.perf_counter() - t0, res

    def _calibration_qids(self, size: int = 8) -> list[int]:
        """Seeded random probe block without replacement, on a stream
        distinct from the one that drew the workload's sources."""
        nq = self.workload.num_queries
        rng = np.random.default_rng([self.workload.seed, 1])
        return np.sort(rng.choice(nq, size=min(size, nq),
                                  replace=False)).tolist()

    def _calibrate_walk_budget(self) -> int:
        """One walk lane count for the whole workload: push a probe block
        (during warmup, never in measured time), read the worst residual
        mass, and budget pow2(ceil(r_max * omega * walk_safety)). Rows
        that would need more lanes stay unbiased (weight r_sum/W), only
        noisier."""
        rp = self.params.resolve(self.workload.graph)
        sources = self._block_sources(self._calibration_qids())
        push = forward_push_np(self.workload.graph, sources, alpha=rp.alpha,
                               rmax=rp.rmax, device=self._dev)
        r_max = float(push.r.sum(dim=1).max())
        need = max(1, math.ceil(r_max * rp.omega * self.walk_safety))
        # the lane count the query runs: on k devices a multiple of k
        return shard_lanes(min(_pow2_ceil_host(need),
                               default_walk_budget(rp)), self.devices)

    def _probe_qids(self) -> list[int]:
        nq = self.workload.num_queries
        probes = {0, 1, nq // 2, nq - 1}
        return sorted(q for q in probes if 0 <= q < nq)

    def warmup(self) -> None:
        """Upload the graph, calibrate the walk budget and run a few probe
        blocks, so that kernel builds and first-call allocations stay out
        of the measured statistics."""
        if self._warmed:
            return
        if self._device_graph is None:
            graph = self.workload.graph
            mesh = self._build_mesh() if self.devices > 1 else None
            if mesh is not None:
                self._device_graph = (
                    graph.device(mesh=mesh) if self.ell_layout == "auto"
                    else ShardedDeviceGraph.from_graph(
                        graph, mesh, layout=self.ell_layout))
            else:
                self._device_graph = (
                    graph.device(self._dev) if self.ell_layout == "auto"
                    else DeviceGraph.from_graph(graph, layout=self.ell_layout,
                                                device=self._dev))
        if self._num_walks is None:
            self._num_walks = self._calibrate_walk_budget()
        if self.index_budget and self.walk_index is None:
            # drawn once per workload; build time is warmup, never measured
            from ..index import WalkIndex

            rp = self.params.resolve(self.workload.graph)
            self.walk_index = WalkIndex.build(
                self._device_graph, width=self.index_budget, alpha=rp.alpha,
                walk_tail=rp.walk_tail, seed=self.index_seed)
        nq = self.workload.num_queries
        size = min(self.block_size, nq)
        for qid in self._probe_qids():
            start = min(qid, nq - size)
            self._run_block(list(range(start, start + size)))
        synchronize(self._dev)
        self._warmed = True

    def run_chunk(self, query_ids: Sequence[int], *,
                  seed: int | None = None) -> RuntimeStats:
        """One chunk of queries as a single batched device call; its time
        is shared evenly among the chunk's queries. ``seed`` is the base of
        the chunk's per-query walk generators (default: the workload's), so
        a query's answer depends on (seed, query id) alone. With
        ``adaptive_budget`` the chunk first takes the walk budget of the
        residual-mass EWMA, and after the timed region its own worst
        residual mass is read back and folded in."""
        ids = list(query_ids)
        if not ids:
            raise ValueError("empty query chunk")
        self.warmup()
        self._recalibrate_block()
        dt, res = self._timed_block(ids, seed)
        if self.adaptive_budget:
            self.observe_residual_mass(float(res.residual_mass.max()))
        self.calls += 1
        return RuntimeStats(np.full(len(ids), dt / len(ids)))

    def observe_residual_mass(self, r_max: float) -> None:
        """Fold one block's observed worst residual mass into the EWMA
        that the next block's walk budget is recalibrated against."""
        if self._obs_rmax is None:
            self._obs_rmax = float(r_max)
        else:
            b = self.budget_ewma
            self._obs_rmax = (1.0 - b) * self._obs_rmax + b * float(r_max)

    def _recalibrate_block(self) -> None:
        """Adaptive walk budget (opt-in): the lane count becomes
        pow2(ceil(ewma_rmax * omega * walk_safety)), capped by the
        worst-case default, the same host integer the JAX package picks
        for the same sequence of observations."""
        if (not self.adaptive_budget or self._obs_rmax is None
                or self._num_walks is None):
            return
        rp = self.params.resolve(self.workload.graph)
        need = max(1, math.ceil(self._obs_rmax * rp.omega * self.walk_safety))
        self._num_walks = shard_lanes(min(_pow2_ceil_host(need),
                                          default_walk_budget(rp)),
                                      self.devices)

    def answer_chunk(self, query_ids: Sequence[int]) -> np.ndarray:
        """PPR rows (len(query_ids), n) for one chunk through the fused
        query: the reference a continuous-batching engine's answers are
        held to. Each query draws from its own generator, so on the CPU a
        query's row has the same bits in any chunk (the JAX package pads
        its batch to a multiple of 8 for that; the port's CPU products need
        no padding). On the card K1's lane layout follows the batch width
        and the live endpoint fold uses atomics, so rows there agree to
        rounding only."""
        ids = list(query_ids)
        if not ids:
            raise ValueError("empty query chunk")
        self.warmup()
        self._recalibrate_block()
        return self._run_block(ids).pi.cpu().numpy()

    def current_walk_budget(self) -> int | None:
        """The calibrated walk lane count (after warmup)."""
        return self._num_walks

    @property
    def index_coverage(self) -> float:
        """Fraction of the calibrated walk budget the walk index serves
        (0.0 without an index or before warmup)."""
        if self.walk_index is None or self._num_walks is None:
            return 0.0
        return self.walk_index.coverage(self._num_walks)

    def degrade(self, factor: float) -> None:
        """Graceful degradation for the remaining queries: raise epsilon by
        1/factor (coarser guarantee, fewer pushes and walks) and cap the
        calibrated walk lanes by ``factor`` (power-of-two floor; on k
        devices then up to a multiple of k). Answers
        stay unbiased, only noisier. The walk index stays: its endpoints
        depend on alpha and the truncation length, which this keeps."""
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must be in (0,1), got {factor}")
        self.params = replace(self.params,
                              epsilon=self.params.epsilon / factor)
        if self._num_walks is not None and self._num_walks > 1:
            capped = max(1, int(self._num_walks * factor))
            self._num_walks = shard_lanes(              # pow2 floor
                1 << (capped.bit_length() - 1), self.devices)
        self._warmed = False

    def __call__(self, query_ids: Sequence[int]) -> RuntimeStats:
        ids = list(query_ids)
        if not ids:
            raise ValueError("empty query block")
        self.warmup()
        times = np.empty(len(ids), dtype=np.float64)
        for lo in range(0, len(ids), self.block_size):
            chunk = ids[lo: lo + self.block_size]
            times[lo: lo + len(chunk)] = \
                self._timed_block(chunk)[0] / len(chunk)
            self.calls += 1
        return RuntimeStats(times)
