"""Graph container for PPR computations, and its device residency.

The host side is numpy and builds the same arrays as ``repro.ppr.graph``
(the tests hold them array-equal). One directed graph has three views;
dangling nodes receive a self-loop at construction so that both push and
walk semantics are total:

* **COO**  — ``edge_src``/``edge_dst`` sorted by source.
* **CSR**  — ``out_offsets`` into ``edge_dst``: O(1) uniform out-neighbour
  sampling for random walks (``edge_dst[offsets[v] + u % deg(v)]``).
* **Pull-form ELL** — ``ell_in()``: the (n, K) padded in-neighbour table,
  weights 1/deg_out(src), that turns a push sweep into one SpMM; and
  ``ell_in_sliced()``, its power-law-safe variant, where rows with
  in-degree > W are split into ceil(deg/W) *virtual* rows of width W and
  ``row_map`` points each virtual row back at its real row.

All index arrays are int32. ``DeviceGraph`` (via ``Graph.device()``) is the
upload-once device mirror: CSR walk arrays and the push table go to the
device once per graph and device, and every query of a workload reuses
them. It picks the dense or sliced table from the degree distribution.
``ShardedDeviceGraph`` (via ``Graph.device(mesh=...)``) is the node-sharded
residency over a :class:`DeviceMesh`: the push table cut into row blocks,
one a shard, and the walk arrays once a device of the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import autotune, ops
from ..kernels.ell_spmv import (DensePlan, SlicedFold, dense_plan,
                               sliced_fold)

# Pad multiple of the push-table widths. 8 is what the JAX package uses off
# the TPU, so the host tables here are array-equal to its tables.
PAD_MULTIPLE = 8


def _round_up(v: int, multiple: int) -> int:
    return max(multiple, ((v + multiple - 1) // multiple) * multiple)


def inverse_out_degree(out_degree: np.ndarray) -> np.ndarray:
    """FORA's spread factor 1/max(deg_out, 1) as float32 — the one weight
    formula of both push-table builders."""
    return 1.0 / np.maximum(out_degree, 1).astype(np.float32)


class SlicedEll(NamedTuple):
    """Sliced pull-form ELL view: high-degree rows split into virtual rows.

    ``neighbors``/``mask``/``weights`` are (n_virtual, width); ``row_map``
    (n_virtual,) int32 maps each virtual row to its real destination row and
    is sorted ascending (slices of one row are contiguous). Real rows with
    in-degree 0 have no virtual row and fold to 0.
    """

    neighbors: np.ndarray   # (n_virtual, width) int32, global source ids
    mask: np.ndarray        # (n_virtual, width) bool
    weights: np.ndarray     # (n_virtual, width) f32, 1/deg_out(src)
    row_map: np.ndarray     # (n_virtual,) int32, ascending
    width: int              # W — slice width
    n: int                  # real row count the view folds back into

    @property
    def n_virtual(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def nbytes(self) -> int:
        """Resident bytes of the sliced table (+ row_map)."""
        return (self.neighbors.nbytes + self.mask.nbytes
                + self.weights.nbytes + self.row_map.nbytes)


@dataclass(frozen=True)
class Graph:
    """Immutable directed graph in COO+CSR(+lazy ELL) form."""

    n: int
    edge_src: np.ndarray     # (m,) int32, sorted ascending
    edge_dst: np.ndarray     # (m,) int32
    directed: bool = True
    name: str = "graph"

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError("graph must have at least one node")
        es = np.asarray(self.edge_src, dtype=np.int32)
        ed = np.asarray(self.edge_dst, dtype=np.int32)
        if es.shape != ed.shape or es.ndim != 1:
            raise ValueError("edge_src/edge_dst must be equal-length 1-D")
        if es.size and (es.min() < 0 or es.max() >= self.n
                        or ed.min() < 0 or ed.max() >= self.n):
            raise ValueError("edge endpoints out of range")
        if es.size and np.any(np.diff(es) < 0):
            order = np.argsort(es, kind="stable")
            es, ed = es[order], ed[order]
        object.__setattr__(self, "edge_src", es)
        object.__setattr__(self, "edge_dst", ed)

    # -- basic stats ---------------------------------------------------------
    @property
    def m(self) -> int:
        return int(self.edge_src.size)

    @cached_property
    def out_degree(self) -> np.ndarray:
        return np.bincount(self.edge_src, minlength=self.n).astype(np.int32)

    @cached_property
    def out_offsets(self) -> np.ndarray:
        """CSR row offsets, shape (n+1,)."""
        off = np.zeros(self.n + 1, dtype=np.int32)
        np.cumsum(self.out_degree, out=off[1:])
        return off

    @cached_property
    def max_out_degree(self) -> int:
        return int(self.out_degree.max()) if self.n else 0

    @property
    def avg_out_degree(self) -> float:
        return self.m / self.n

    @cached_property
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.edge_dst, minlength=self.n).astype(np.int32)

    @cached_property
    def max_in_degree(self) -> int:
        return int(self.in_degree.max()) if self.m else 0

    # -- pull-form push tables ----------------------------------------------
    def ell_in(self, pad_multiple: int = PAD_MULTIPLE
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pull-form padded in-neighbour table for the push-as-SpMM kernel.

        Returns (neighbors (n,K) int32, mask (n,K) bool, weights (n,K) f32):
        row i lists the sources of i's in-edges; weights carry FORA's spread
        factor 1/deg_out(src), so ``ell_spmm(nbr, mask, w, pushed) ==
        P^T pushed``. Padding entries point at node 0 with mask False and
        weight 0.
        """
        order = np.argsort(self.edge_dst, kind="stable")
        src_s = self.edge_src[order]
        dst_s = self.edge_dst[order]
        in_deg = np.bincount(dst_s, minlength=self.n)
        K = _round_up(self.max_in_degree if self.m else 1, pad_multiple)
        neighbors = np.zeros((self.n, K), dtype=np.int32)
        mask = np.zeros((self.n, K), dtype=bool)
        off = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(in_deg, out=off[1:])
        pos = np.arange(self.m, dtype=np.int64) - off[dst_s]
        neighbors[dst_s, pos] = src_s
        mask[dst_s, pos] = True
        inv_deg = inverse_out_degree(self.out_degree)
        weights = inv_deg[neighbors] * mask
        return neighbors, mask, weights.astype(np.float32)

    def _sliced_width_cells(self, pad_multiple: int = PAD_MULTIPLE
                            ) -> tuple[int, int]:
        """(width, padded cell count) minimising the sliced-table area —
        the one cost formula of the width choice and the layout policy."""
        if pad_multiple < 1:
            raise ValueError("pad_multiple must be >= 1")
        dense_w = _round_up(self.max_in_degree if self.m else 1, pad_multiple)
        deg = self.in_degree.astype(np.int64)
        candidates = []
        w = pad_multiple
        while w < dense_w:
            candidates.append(w)
            w *= 2
        candidates.append(dense_w)
        costs = {W: int(np.ceil(deg / W).sum()) * W for W in candidates}
        best = min(candidates, key=lambda W: (costs[W], W))
        return best, costs[best]

    def sliced_ell_width(self, pad_multiple: int | None = None) -> int:
        """Slice width W minimising the padded sliced-table area.

        Candidates are ``pad_multiple * 2^j`` plus the dense width itself;
        cost(W) = sum_i ceil(deg_in(i)/W) * W, the cell count of the
        resulting (n_virtual, W) table. Ties go to the smaller W.
        ``pad_multiple=None`` takes ``PAD_MULTIPLE``, unless the active
        tuning cache (``kernels.autotune``) holds a measured width for the
        process's backend and this graph's shape bucket: then that width.
        A cold cache keeps the heuristic's answer.
        """
        if pad_multiple is None:
            tuned = _tuned_push_config(self, "sliced")
            if tuned is not None and tuned.width is not None:
                return tuned.width
            pad_multiple = PAD_MULTIPLE
        return self._sliced_width_cells(pad_multiple)[0]

    def ell_in_sliced(self, width: int | None = None,
                      pad_multiple: int = PAD_MULTIPLE) -> SlicedEll:
        """Power-law-safe pull-form ELL: rows wider than ``width`` are split.

        Same semantics as :meth:`ell_in` after folding virtual rows back
        through ``row_map``; memory is O(m + n_virtual·W) instead of
        O(n·k_max). ``width=None`` takes :meth:`sliced_ell_width`.
        """
        W = self.sliced_ell_width(pad_multiple) if width is None \
            else _round_up(width, pad_multiple)
        order = np.argsort(self.edge_dst, kind="stable")
        src_s = self.edge_src[order]
        dst_s = self.edge_dst[order]
        in_deg = self.in_degree.astype(np.int64)
        slices = -(-in_deg // W)                       # ceil; 0 for deg-0 rows
        n_virtual = int(slices.sum())
        if n_virtual == 0:                             # edgeless graph
            return SlicedEll(neighbors=np.zeros((1, W), np.int32),
                             mask=np.zeros((1, W), bool),
                             weights=np.zeros((1, W), np.float32),
                             row_map=np.zeros(1, np.int32), width=W, n=self.n)
        voff = np.zeros(self.n + 1, dtype=np.int64)    # first virtual row of i
        np.cumsum(slices, out=voff[1:])
        row_map = np.repeat(np.arange(self.n, dtype=np.int32),
                            slices).astype(np.int32)
        off = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(in_deg, out=off[1:])
        pos = np.arange(self.m, dtype=np.int64) - off[dst_s]  # rank in row
        vrow = voff[dst_s] + pos // W
        vpos = pos % W
        neighbors = np.zeros((n_virtual, W), dtype=np.int32)
        mask = np.zeros((n_virtual, W), dtype=bool)
        neighbors[vrow, vpos] = src_s
        mask[vrow, vpos] = True
        inv_deg = inverse_out_degree(self.out_degree)
        weights = (inv_deg[neighbors] * mask).astype(np.float32)
        return SlicedEll(neighbors=neighbors, mask=mask, weights=weights,
                         row_map=row_map, width=W, n=self.n)

    # -- device residency ----------------------------------------------------
    # sharded residencies kept a graph, least recently used first out:
    # elastic re-grants walk through mesh shapes over a long-lived graph, and
    # an unbounded cache would pin every superseded copy of the graph
    SHARDED_CACHE_MAX: ClassVar[int] = 2

    @cached_property
    def _devices(self) -> dict:
        return {}

    @cached_property
    def _sharded_devices(self) -> dict:
        return {}

    def device(self, device: str | torch.device = "cuda", *,
               mesh: "DeviceMesh | None" = None
               ) -> "DeviceGraph | ShardedDeviceGraph":
        """Upload-once device mirror; repeated calls for one device return
        the same object while the active tuning cache's entry for this
        graph stays the same. The cache is read when a mirror is built: a
        cache set before the first upload shapes it, and one that changes
        the entry afterwards makes the next call build a new mirror (the
        old object is left as it was).

        With ``mesh`` (then ``device`` is not read) it is the node-sharded
        :class:`ShardedDeviceGraph` over that mesh, kept for the
        ``SHARDED_CACHE_MAX`` most recently used meshes."""
        if mesh is not None:
            return self._sharded(mesh)
        dev = resolve_device(device)
        tuned = _tuned_push_config(self, "sliced",
                                   autotune.current_backend(dev))
        held = self._devices.get(dev)
        if held is None or held[0] != tuned:
            held = (tuned, DeviceGraph.from_graph(self, device=dev))
            self._devices[dev] = held
        return held[1]

    def _sharded(self, mesh: "DeviceMesh") -> "ShardedDeviceGraph":
        tuned = _tuned_push_config(
            self, "sliced", autotune.current_backend(mesh.devices[0]))
        cache = self._sharded_devices
        held = cache.pop(mesh, None)           # re-inserted: most recent
        if held is None or held[0] != tuned:
            held = (tuned, ShardedDeviceGraph.from_graph(self, mesh))
        cache[mesh] = held
        while len(cache) > self.SHARDED_CACHE_MAX:
            cache.pop(next(iter(cache)))       # the least recently used
        return held[1]

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray, *,
                   directed: bool = True, add_dangling_self_loops: bool = True,
                   dedup: bool = True, name: str = "graph") -> "Graph":
        """Build a graph, symmetrising if undirected, fixing dangling nodes.

        Dangling nodes (out-degree 0) get a self-loop so that the random-walk
        transition is total and forward push conserves mass; the
        power-iteration oracle uses the same adjacency.
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        keep = src != dst  # drop self-loops; re-added below only for dangling
        src, dst = src[keep], dst[keep]
        if not directed:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if dedup and src.size:
            key = src * n + dst
            _, idx = np.unique(key, return_index=True)
            src, dst = src[idx], dst[idx]
        if add_dangling_self_loops:
            deg = np.bincount(src, minlength=n)
            dangling = np.flatnonzero(deg == 0)
            if dangling.size:
                src = np.concatenate([src, dangling])
                dst = np.concatenate([dst, dangling])
        order = np.argsort(src, kind="stable")
        return Graph(n=n, edge_src=src[order].astype(np.int32),
                     edge_dst=dst[order].astype(np.int32),
                     directed=directed, name=name)

    def summary(self) -> dict:
        return {"name": self.name, "n": self.n, "m": self.m,
                "type": "Directed" if self.directed else "Undirected",
                "avg_out_degree": round(self.avg_out_degree, 2),
                "max_out_degree": self.max_out_degree}


class _PushLayout(NamedTuple):
    """Host-side pull table and the dense/sliced decision."""

    layout: str             # "dense" | "sliced"
    neighbors: np.ndarray   # (rows, K) int32 — real rows (dense) or virtual
    mask: np.ndarray        # (rows, K) bool
    weights: np.ndarray     # (rows, K) f32
    row_map: np.ndarray | None   # (rows,) int32 ascending, None when dense
    width: int              # K of the resident table


def _tuned_push_config(graph: Graph, layout: str, backend: str | None = None):
    """The active tuning cache's entry for this graph's shape bucket under
    ``layout`` on ``backend`` (default: the process's), or None when the
    cache is cold. Read only when a residency is built, on the host before
    upload, so a query never looks it up."""
    cache = autotune.get_cache()
    if cache is None:
        return None
    return cache.lookup(backend or autotune.current_backend(), layout,
                        autotune.shape_bucket(graph.n, graph.m))


def _resolve_push_layout(graph: Graph, layout: str,
                         width: int | None = None,
                         pad_multiple: int | None = None,
                         backend: str | None = None) -> _PushLayout:
    """``"auto"`` slices only when the dense table would hold at least
    ``AUTO_SLICE_RATIO`` times the sliced table's cells: power-law graphs
    slice, near-uniform graphs keep the dense table. ``width`` pins the
    slice width and ``pad_multiple`` the tables' pad multiple (default
    ``PAD_MULTIPLE``), as the JAX package's table build takes them. An
    active tuning cache's entry for ``backend`` refines the sliced table's
    width and pad multiple when the caller pinned neither; a cold cache
    leaves every value, and so the residency, as it was."""
    if layout not in ("auto", "dense", "sliced"):
        raise ValueError(f"layout must be auto|dense|sliced, got {layout!r}")
    pinned = width is not None or pad_multiple is not None
    if pad_multiple is None:
        pad_multiple = PAD_MULTIPLE
    if layout == "auto":
        sl_width, sliced_cells = graph._sliced_width_cells(pad_multiple)
        dense_cells = graph.n * _round_up(
            graph.max_in_degree if graph.m else 1, pad_multiple)
        layout = "sliced" if dense_cells >= DeviceGraph.AUTO_SLICE_RATIO * \
            max(1, sliced_cells) else "dense"
        if width is None:
            width = sl_width
    if layout == "sliced" and not pinned:
        tuned = _tuned_push_config(graph, layout, backend)
        if tuned is not None and tuned.width is not None:
            width = tuned.width
            if tuned.pad_multiple is not None:
                pad_multiple = tuned.pad_multiple
    if layout == "sliced":
        sl = graph.ell_in_sliced(width=width, pad_multiple=pad_multiple)
        return _PushLayout(layout="sliced", neighbors=sl.neighbors,
                           mask=sl.mask, weights=sl.weights,
                           row_map=sl.row_map, width=sl.width)
    nbr, mask, weights = graph.ell_in(pad_multiple)
    return _PushLayout(layout="dense", neighbors=nbr, mask=mask,
                       weights=weights, row_map=None,
                       width=int(nbr.shape[1]))


@dataclass(frozen=True, eq=False)
class DeviceGraph:
    """Device-resident graph arrays for the fused FORA query.

    Holds tensors for the CSR walk view (edge_dst / out_offsets /
    out_degree) and the pull-form push view (in_neighbors / in_mask /
    in_weights), either the dense (n, k_max) table (``in_row_map`` None)
    or the sliced (n_virtual, W) table with its ``row_map``. Built once
    from the table: a dense table's row plan, which K1 and K4 read
    (``in_plan``: each row's live extent and the lanes a row takes), or a
    sliced table's fold structure, which K2 reads (``in_fold``).
    ``DeviceGraph.uploads`` counts constructions, so tests can hold the
    upload-once contract.
    """

    n: int
    m: int
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    out_offsets: torch.Tensor
    out_degree: torch.Tensor
    in_neighbors: torch.Tensor
    in_mask: torch.Tensor
    in_weights: torch.Tensor
    in_row_map: torch.Tensor | None = None   # (n_virtual,) int32, or None
    ell_width: int = 0                       # K of the resident table
    in_fold: SlicedFold | None = None        # the sliced table's fold
    in_plan: DensePlan | None = None         # the dense table's row plan

    uploads: ClassVar[int] = 0
    AUTO_SLICE_RATIO: ClassVar[float] = 4.0
    ARRAY_FIELDS: ClassVar[tuple[str, ...]] = (
        "edge_src", "edge_dst", "out_offsets", "out_degree", "in_neighbors",
        "in_mask", "in_weights", "in_row_map")

    @property
    def layout(self) -> str:
        return "dense" if self.in_row_map is None else "sliced"

    @property
    def device(self) -> torch.device:
        return self.edge_dst.device

    @property
    def ell_nbytes(self) -> int:
        """Resident bytes of the device push table (+ row_map when sliced)."""
        arrays = (self.in_neighbors, self.in_mask, self.in_weights,
                  self.in_row_map)
        return int(sum(a.numel() * a.element_size()
                       for a in arrays if a is not None))

    @classmethod
    def from_graph(cls, graph: Graph, *, layout: str = "auto",
                   width: int | None = None, pad_multiple: int | None = None,
                   device: str | torch.device = "cuda") -> "DeviceGraph":
        lay = _resolve_push_layout(
            graph, layout, width, pad_multiple,
            autotune.current_backend(resolve_device(device)))
        arrays = {"edge_src": graph.edge_src, "edge_dst": graph.edge_dst,
                  "out_offsets": graph.out_offsets,
                  "out_degree": graph.out_degree,
                  "in_neighbors": lay.neighbors, "in_mask": lay.mask,
                  "in_weights": lay.weights, "in_row_map": lay.row_map}
        return cls.from_arrays(arrays, device=device)

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray | None], *,
                    device: str | torch.device = "cuda") -> "DeviceGraph":
        """A residency from host arrays named like this class's fields —
        e.g. ``np.asarray`` of each field of a ``repro.ppr.DeviceGraph``.
        ``in_row_map`` may be missing or None (dense table)."""
        unknown = set(arrays) - set(cls.ARRAY_FIELDS)
        if unknown:
            raise ValueError(f"unknown arrays {sorted(unknown)}")
        missing = [f for f in cls.ARRAY_FIELDS[:-1] if arrays.get(f) is None]
        if missing:
            raise ValueError(f"missing arrays {missing}")
        dev = resolve_device(device)
        dtypes = {"in_mask": torch.bool, "in_weights": torch.float32}
        tensors = {}
        for f in cls.ARRAY_FIELDS:
            a = arrays.get(f)
            if a is None:
                tensors[f] = None
                continue
            # a copy: the residency never aliases the caller's arrays
            t = torch.tensor(a, dtype=dtypes.get(f, torch.int32))
            tensors[f] = t.to(dev)
        nbr = tensors["in_neighbors"]
        if nbr.dim() != 2 or tensors["in_mask"].shape != nbr.shape \
                or tensors["in_weights"].shape != nbr.shape:
            raise ValueError("push table arrays must share one 2-D shape")
        n = int(tensors["out_degree"].shape[0])
        if tensors["out_offsets"].shape != (n + 1,):
            raise ValueError("out_offsets must have n + 1 entries")
        if tensors["in_row_map"] is None and nbr.shape[0] != n:
            raise ValueError("a dense push table needs one row per node")
        if tensors["in_row_map"] is None:
            fold, plan = None, dense_plan(tensors["in_mask"])
        else:
            fold = sliced_fold(tensors["in_row_map"], n, int(nbr.shape[1]))
            plan = None
        DeviceGraph.uploads += 1
        return cls(n=n, m=int(tensors["edge_dst"].shape[0]),
                   ell_width=int(nbr.shape[1]), in_fold=fold, in_plan=plan,
                   **tensors)


@dataclass(frozen=True)
class DeviceMesh:
    """The devices of a node-sharded residency, one a shard along the axis
    ``axis``: shard s runs on ``devices[s]``. One process drives every
    shard (the JAX package's single-controller mesh). A device may repeat:
    several shards on one card run one after another there. The devices
    are all CUDA or all the CPU; a bare ``"cuda"`` is the current card."""

    devices: tuple[torch.device, ...]
    axis: ClassVar[str] = "shard"

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"a mesh's devices must be all CUDA or all the "
                             f"CPU, got {[str(d) for d in devs]}")
        object.__setattr__(self, "devices",
                           tuple(resolve_device(d) for d in devs))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices, each once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


@dataclass(frozen=True, eq=False)
class ShardedDeviceGraph:
    """Node-sharded device residency over a :class:`DeviceMesh`.

    The pull-form push table is cut along its rows into ``num_shards``
    blocks of ``rows_per_shard`` rows (padded with empty rows to a
    multiple of the shard count), block s on the mesh's device s:

    * a **dense** table by destination row: shard s computes rows
      [s * rows_per_shard, (s + 1) * rows_per_shard) of the product, and
      the blocks are put together in shard order (``ops.ell_spmm_shard``).
      Its row plan (``in_plan``) is the block's rows of the whole table's
      plan, so each row is summed in the one order it has on one device;
    * a **sliced** table by *virtual* row: shard s folds its slices onto
      the full (B, n) frame through its own ``row_map`` block and fold
      structure (``in_fold``), and the frames are summed in shard order
      (``ops.ell_spmm_sliced_shard``). A row whose slices two shards share
      is summed in two parts. Padding rows carry ``row_map`` n, which the
      fold never reads (``sliced_fold``'s ``row_ptr[n]``).

    Gather ids stay global node ids. The CSR walk arrays are kept once on
    each distinct device of the mesh (``replicas``), so each shard walks
    its own window of the walk lanes beside its table. ``edge_dst``,
    ``out_offsets`` and ``out_degree`` are the first device's, where the
    controller keeps the push's state and a query's result.

    Built by ``Graph.device(mesh=...)`` (upload-once per graph and mesh);
    ``uploads`` counts constructions as :class:`DeviceGraph`'s does.
    """

    n: int
    m: int
    mesh: DeviceMesh
    num_shards: int
    rows_per_shard: int
    replicas: dict          # device -> (edge_dst, out_offsets, out_degree)
    in_neighbors: tuple[torch.Tensor, ...]   # per shard (rows_per_shard, K)
    in_mask: tuple[torch.Tensor, ...]
    in_weights: tuple[torch.Tensor, ...]
    in_row_map: tuple[torch.Tensor, ...] | None = None   # None: dense
    ell_width: int = 0
    in_fold: tuple[SlicedFold, ...] | None = None
    in_plan: tuple[DensePlan, ...] | None = None

    uploads: ClassVar[int] = 0

    @property
    def axis(self) -> str:
        return self.mesh.axis

    @property
    def layout(self) -> str:
        return "dense" if self.in_row_map is None else "sliced"

    @property
    def device(self) -> torch.device:
        """The mesh's first device: the push's state and results lie here."""
        return self.mesh.devices[0]

    @property
    def edge_dst(self) -> torch.Tensor:
        return self.replicas[self.device][0]

    @property
    def out_offsets(self) -> torch.Tensor:
        return self.replicas[self.device][1]

    @property
    def out_degree(self) -> torch.Tensor:
        return self.replicas[self.device][2]

    @property
    def ell_nbytes(self) -> int:
        """Resident bytes of the push table (+ row_map when sliced), summed
        over the shards."""
        arrays = (*self.in_neighbors, *self.in_mask, *self.in_weights,
                  *(self.in_row_map or ()))
        return int(sum(a.numel() * a.element_size() for a in arrays))

    def replicate(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``x`` on each shard's device, one copy a device of the mesh
        (``x`` itself where it lies already)."""
        return ops.replicate(x, self.mesh.devices)

    @classmethod
    def from_graph(cls, graph: Graph, mesh: DeviceMesh, *,
                   layout: str = "auto", width: int | None = None,
                   pad_multiple: int | None = None) -> "ShardedDeviceGraph":
        k = mesh.size
        first = mesh.devices[0]
        lay = _resolve_push_layout(graph, layout, width, pad_multiple,
                                   autotune.current_backend(first))
        nbr, mask, weights, row_map = (lay.neighbors, lay.mask, lay.weights,
                                       lay.row_map)
        rows = int(nbr.shape[0])
        per = -(-rows // k)
        pad = per * k - rows
        if pad:
            nbr = np.pad(nbr, ((0, pad), (0, 0)))
            mask = np.pad(mask, ((0, pad), (0, 0)))
            weights = np.pad(weights, ((0, pad), (0, 0)))
            if row_map is not None:
                row_map = np.concatenate(
                    [row_map, np.full(pad, graph.n, np.int32)])
        if row_map is None:
            # the whole table's plan, built where one device would build it
            whole = dense_plan(torch.from_numpy(mask).to(first))
        blocks = {f: [] for f in ("in_neighbors", "in_mask", "in_weights",
                                  "in_row_map", "in_fold", "in_plan")}
        for s, dev in enumerate(mesh.devices):
            lo, hi = s * per, (s + 1) * per
            blocks["in_neighbors"].append(torch.tensor(nbr[lo:hi]).to(dev))
            blocks["in_mask"].append(torch.tensor(mask[lo:hi]).to(dev))
            blocks["in_weights"].append(
                torch.tensor(weights[lo:hi], dtype=torch.float32).to(dev))
            if row_map is None:
                blocks["in_plan"].append(DensePlan(
                    extent=whole.extent[lo:hi].contiguous().to(dev),
                    lanes=whole.lanes, width=whole.width))
            else:
                rm = torch.tensor(row_map[lo:hi]).to(dev)
                blocks["in_row_map"].append(rm)
                blocks["in_fold"].append(sliced_fold(rm, graph.n, lay.width))
        walk = [torch.tensor(a) for a in (graph.edge_dst, graph.out_offsets,
                                           graph.out_degree)]
        replicas = {d: tuple(t.to(d) for t in walk) for d in mesh.distinct}
        ShardedDeviceGraph.uploads += 1
        return cls(n=graph.n, m=graph.m, mesh=mesh, num_shards=k,
                   rows_per_shard=per, replicas=replicas,
                   ell_width=lay.width,
                   **{f: tuple(v) if v else None for f, v in blocks.items()})
