"""Device residency of a graph that changes: streaming edge updates applied
where the tables live, without re-uploading them, and compaction that
rebuilds exactly what a fresh build gives.

``DynamicGraph`` keeps three pieces of state in step:

* a **host mirror**: the live non-self-loop edge set, as ascending pair
  keys ``u * n + v``, and each node's real out-degree. Every batch is
  normalised here into the *residency diff*: the effective adds and
  removes after deduplication (and symmetrisation for an undirected
  graph), plus the dangling self-loop toggles ``Graph.from_edges`` would
  make (a node losing its last real out-edge gains a self-loop; a node
  gaining its first loses it). The mirror holds exactly the edge set
  ``from_edges`` would be called with, which makes ``compact()`` exact.
* a **push table** on the device: the sliced pull-form table with spare
  capacity rows (``row_map == n``, read by nothing). Batches go through
  :func:`repro_torch.kernels.ops.push_delta_apply`: removals clear their
  cells, additions append virtual rows of at most W cells, a stable sort
  keeps ``row_map`` ascending, and the weights are re-derived from the
  resident inverse out-degrees with the gather-multiply of the host's
  table build. After each batch the table's fold structure (``DeviceGraph.
  in_fold``, which K2 reads) is rebuilt from the new ``row_map`` by
  :func:`~repro_torch.kernels.ell_spmv.sliced_fold`; its ``row_ptr[n]``
  ends before the spare rows, so K2 never reads them. The residency is
  sliced only, as the JAX package's is.
* a **walk view** on the device: CSR arrays with removals tombstoned,
  re-sorted each batch by :func:`repro_torch.kernels.ops.walk_delta_apply`
  so that its live prefix equals a fresh build's arrays (walks draw the
  same neighbours a rebuilt graph would).

Only the small per-batch delta arrays go to the device (padded to fixed
caps); the rewrite of the tables happens there. The host syncs of a batch
are the fold rebuild's (a ``nonzero`` and a count); the JAX package's
apply has none.

``compact()`` rebuilds on the host through ``Graph.from_edges`` and
``DeviceGraph.from_graph``, the path a fresh build takes, so the compacted
residency equals one built at the same version, and the spare and
tombstoned capacity is reclaimed. Node additions are out of scope: the
node universe is fixed at ``n``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.ell_spmv import sliced_fold
from ..kernels.ops import push_delta_apply, walk_delta_apply
from ..ppr.graph import DeviceGraph, Graph, inverse_out_degree
from .mutation_log import EdgeBatch, MutationLog

# delta caps of one device call
_APPLY_ROWS = 64        # push virtual rows per call
_APPLY_EDGES = 256      # walk edges / removals / degree updates per call


def _pow2_at_least(x: int, floor: int = 256) -> int:
    cap = floor
    while cap < x:
        cap *= 2
    return cap


def _chunks(seq: list, size: int):
    for lo in range(0, len(seq), size):
        yield seq[lo:lo + size]


def _pad_rows(t: torch.Tensor, rows: int, value) -> torch.Tensor:
    """``t`` with ``rows`` more rows (leading dim) filled with ``value``."""
    extra = torch.full((rows,) + tuple(t.shape[1:]), value, dtype=t.dtype,
                       device=t.device)
    return torch.cat([t, extra])


@dataclass(frozen=True)
class ApplyInfo:
    """What one batch did: the input of a runtime's invalidation."""

    version: int
    affected: np.ndarray      # sorted unique sources whose out-nbhd changed
    adds_applied: int         # residency edge insertions (incl. loop toggles)
    removes_applied: int      # residency edge tombstones (incl. loop toggles)
    push_rows: int            # delta virtual rows appended to the push table
    live_edges: int           # residency edge count after the batch


class DynamicGraph:
    """Mutable device residency over a fixed ``n``-node universe."""

    def __init__(self, graph: Graph, *, width: int | None = None,
                 pad_multiple: int | None = None, base_version: int = 0,
                 device: str | torch.device = "cuda"):
        canon = Graph.from_edges(graph.n, graph.edge_src, graph.edge_dst,
                                 directed=graph.directed, name=graph.name)
        if not (np.array_equal(canon.edge_src, graph.edge_src)
                and np.array_equal(canon.edge_dst, graph.edge_dst)):
            raise ValueError(
                "DynamicGraph requires a from_edges-normalised graph "
                "(self-loops only on dangling nodes, deduped, src-sorted) - "
                "rebuild it through Graph.from_edges first")
        self._dev = resolve_device(device)
        self._graph = graph
        self._build_args = dict(width=width, pad_multiple=pad_multiple)
        self.version = int(base_version)
        self.log = MutationLog(base_version=base_version)
        n = graph.n
        src = graph.edge_src.astype(np.int64)
        dst = graph.edge_dst.astype(np.int64)
        real = src != dst
        self._keys = np.unique(src[real] * n + dst[real])
        self._deg = np.bincount(src[real], minlength=n).astype(np.int64)
        self._attach(graph)

    # -- residency attach (init and compact share it) ----------------------
    def _attach(self, graph: Graph) -> DeviceGraph:
        dg = DeviceGraph.from_graph(graph, layout="sliced",
                                    device=self._dev, **self._build_args)
        n = dg.n
        nv = int(dg.in_neighbors.shape[0])
        cap = _pow2_at_least(nv + _APPLY_ROWS)
        self._push_nbr = _pad_rows(dg.in_neighbors, cap - nv, 0)
        self._push_mask = _pad_rows(dg.in_mask, cap - nv, False)
        self._push_rm = _pad_rows(dg.in_row_map, cap - nv, n)
        self._push_w = _pad_rows(dg.in_weights, cap - nv, 0.0)
        self._push_used = nv
        m = int(dg.edge_src.shape[0])
        ecap = _pow2_at_least(m + _APPLY_EDGES)
        self._walk_src = _pad_rows(dg.edge_src, ecap - m, n)
        self._walk_dst = _pad_rows(dg.edge_dst, ecap - m, 0)
        self._walk_alive = _pad_rows(
            torch.ones(m, dtype=torch.bool, device=self._dev), ecap - m,
            False)
        self._walk_live = m
        self._walk_off = dg.out_offsets
        self._walk_deg = dg.out_degree
        self._inv_out = torch.from_numpy(
            inverse_out_degree(graph.out_degree)).to(self._dev)
        self.dg = dg
        return dg

    # -- views -------------------------------------------------------------
    @property
    def n(self) -> int:
        return self._graph.n

    @property
    def width(self) -> int:
        return self.dg.ell_width

    @property
    def live_edges(self) -> int:
        return self._walk_live

    def graph(self) -> Graph:
        """Host graph at the current version, rebuilt from the mirror
        through ``Graph.from_edges`` (dangling self-loops re-derived
        there)."""
        n = self._graph.n
        return Graph.from_edges(n, self._keys // n, self._keys % n,
                                directed=self._graph.directed,
                                name=self._graph.name)

    # -- batch normalisation ----------------------------------------------
    def _normalise(self, pairs: np.ndarray) -> set:
        n = self._graph.n
        if pairs.size and (pairs.min() < 0 or pairs.max() >= n):
            raise ValueError("edge endpoints out of range (the node "
                             "universe is fixed at construction)")
        out = {(int(u), int(v)) for u, v in pairs if u != v}
        if not self._graph.directed:
            out |= {(v, u) for u, v in sorted(out)}
        return out

    def _present(self, edges) -> np.ndarray:
        """Which of ``edges`` (a list of pairs) the mirror holds."""
        n = self._graph.n
        keys = np.asarray([u * n + v for u, v in edges], dtype=np.int64)
        at = np.searchsorted(self._keys, keys)
        hit = at < self._keys.size
        hit[hit] = self._keys[at[hit]] == keys[hit]
        return hit

    # -- apply -------------------------------------------------------------
    def mutate(self, adds=(), removes=()) -> ApplyInfo:
        """Log and apply one batch."""
        return self.apply(self.log.append(adds, removes))

    def apply_record(self, rec: dict) -> ApplyInfo:
        """Apply a batch replayed from its record."""
        return self.apply(EdgeBatch.from_record(rec))

    def apply(self, batch: EdgeBatch) -> ApplyInfo:
        """Apply one ``EdgeBatch`` on the device; returns what it changed.
        Batches must arrive in version order."""
        if batch.version != self.version + 1:
            raise ValueError(f"batch version {batch.version} does not "
                             f"follow current version {self.version}")
        n = self._graph.n
        adds_n = sorted(self._normalise(batch.adds))
        removes_n = sorted(self._normalise(batch.removes))
        adds_eff = [e for e, p in zip(adds_n, self._present(adds_n))
                    if not p]
        added = set(adds_n)
        rem_eff = [e for e, p in zip(removes_n, self._present(removes_n))
                   if p and e not in added]
        # dangling self-loop toggles: residency-degree transitions
        delta: dict[int, int] = {}
        for u, _ in adds_eff:
            delta[u] = delta.get(u, 0) + 1
        for u, _ in rem_eff:
            delta[u] = delta.get(u, 0) - 1
        loop_adds, loop_removes, changed = [], [], {}
        for u, d in sorted(delta.items()):
            old, new = int(self._deg[u]), int(self._deg[u]) + d
            if old == 0 and new > 0:
                loop_removes.append((u, u))
            elif old > 0 and new == 0:
                loop_adds.append((u, u))
            if max(old, 1) != max(new, 1):
                changed[u] = max(new, 1)
        adds_res = sorted(adds_eff + loop_adds)
        removes_res = sorted(rem_eff + loop_removes)
        affected = np.unique(np.asarray(
            [u for u, _ in adds_res] + [u for u, _ in removes_res],
            dtype=np.int32))
        push_rows = self._apply_device(adds_res, removes_res, changed)
        # commit the mirror: the keys stay sorted (rem_eff and adds_eff
        # are sorted pairs, so their keys are too)
        if rem_eff:
            gone = np.asarray([u * n + v for u, v in rem_eff], np.int64)
            self._keys = np.delete(self._keys,
                                   np.searchsorted(self._keys, gone))
        if adds_eff:
            new = np.asarray([u * n + v for u, v in adds_eff], np.int64)
            self._keys = np.insert(self._keys,
                                   np.searchsorted(self._keys, new), new)
        for u, d in delta.items():
            self._deg[u] += d
        self._walk_live += len(adds_res) - len(removes_res)
        self._push_used += push_rows
        self.version = batch.version
        if self.log.version < batch.version:      # externally-built batch
            self.log.record(batch)
        self.dg = dataclasses.replace(
            self.dg, m=self._walk_live, edge_src=self._walk_src,
            edge_dst=self._walk_dst, out_offsets=self._walk_off,
            out_degree=self._walk_deg, in_neighbors=self._push_nbr,
            in_mask=self._push_mask, in_weights=self._push_w,
            in_row_map=self._push_rm,
            in_fold=sliced_fold(self._push_rm, n, self.width), in_plan=None)
        return ApplyInfo(version=self.version, affected=affected,
                         adds_applied=len(adds_res),
                         removes_applied=len(removes_res),
                         push_rows=push_rows, live_edges=self._walk_live)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self._dev)

    def _apply_device(self, adds_res, removes_res, changed) -> int:
        """Chunk the residency diff through the two delta ops; every delta
        array the device sees is padded to the fixed ``_APPLY_*`` caps."""
        n, W = self._graph.n, self.width
        # pack added cells into <= W-wide virtual rows, grouped by dst row
        by_dst: dict[int, list[int]] = {}
        for u, v in adds_res:                     # cell (row v, source u)
            by_dst.setdefault(v, []).append(u)
        rows = []
        for v in sorted(by_dst):
            srcs = by_dst[v]
            for lo in range(0, len(srcs), W):
                rows.append((v, srcs[lo:lo + W]))
        total_rows = len(rows)
        # grow push capacity so every chunk's (cursor + _APPLY_ROWS) fits
        cap = int(self._push_rm.shape[0])
        need = self._push_used + total_rows + _APPLY_ROWS
        if need > cap:
            grow = _pow2_at_least(need, floor=cap) - cap
            self._push_nbr = _pad_rows(self._push_nbr, grow, 0)
            self._push_mask = _pad_rows(self._push_mask, grow, False)
            self._push_rm = _pad_rows(self._push_rm, grow, n)
        # grow walk capacity (tombstones are recycled each sort, so live +
        # one padded add block is all a batch can need)
        ecap = int(self._walk_src.shape[0])
        eneed = self._walk_live + len(adds_res) + _APPLY_EDGES
        if eneed > ecap:
            egrow = _pow2_at_least(eneed, floor=ecap) - ecap
            self._walk_src = _pad_rows(self._walk_src, egrow, n)
            self._walk_dst = _pad_rows(self._walk_dst, egrow, 0)
            self._walk_alive = _pad_rows(self._walk_alive, egrow, False)

        deg_items = sorted(changed.items())
        row_chunks = list(_chunks(rows, _APPLY_ROWS)) or [[]]
        rem_chunks = list(_chunks(removes_res, _APPLY_EDGES)) or [[]]
        deg_chunks = list(_chunks(deg_items, _APPLY_EDGES)) or [[]]
        n_calls = max(len(row_chunks), len(rem_chunks), len(deg_chunks))
        cursor = self._push_used
        for i in range(n_calls):
            rc = row_chunks[i] if i < len(row_chunks) else []
            mc = rem_chunks[i] if i < len(rem_chunks) else []
            dc = deg_chunks[i] if i < len(deg_chunks) else []
            add_nbr = np.zeros((_APPLY_ROWS, W), np.int32)
            add_mask = np.zeros((_APPLY_ROWS, W), bool)
            add_rm = np.full(_APPLY_ROWS, n, np.int32)
            for j, (v, srcs) in enumerate(rc):
                add_nbr[j, :len(srcs)] = srcs
                add_mask[j, :len(srcs)] = True
                add_rm[j] = v
            rem_src = np.full(_APPLY_EDGES, -1, np.int32)
            rem_dst = np.full(_APPLY_EDGES, -1, np.int32)
            for j, (u, v) in enumerate(mc):
                rem_src[j], rem_dst[j] = u, v
            deg_nodes = np.full(_APPLY_EDGES, n, np.int32)
            deg_inv = np.zeros(_APPLY_EDGES, np.float32)
            if dc:
                nodes = np.asarray([u for u, _ in dc], np.int32)
                degs = np.asarray([d for _, d in dc], np.int64)
                deg_nodes[:len(dc)] = nodes
                deg_inv[:len(dc)] = inverse_out_degree(degs)
            (self._push_nbr, self._push_mask, self._push_w, self._push_rm,
             self._inv_out) = push_delta_apply(
                self._push_nbr, self._push_mask, self._push_rm,
                self._inv_out, self._tensor(add_nbr), self._tensor(add_mask),
                self._tensor(add_rm), self._tensor(rem_src),
                self._tensor(rem_dst), self._tensor(deg_nodes),
                self._tensor(deg_inv), cursor)
            cursor += len(rc)
        # walk view: tombstone removals, append additions, re-sort
        add_chunks = list(_chunks(adds_res, _APPLY_EDGES)) or [[]]
        n_calls = max(len(add_chunks), len(rem_chunks))
        live = self._walk_live
        for i in range(n_calls):
            ac = add_chunks[i] if i < len(add_chunks) else []
            mc = rem_chunks[i] if i < len(rem_chunks) else []
            add_src = np.full(_APPLY_EDGES, n, np.int32)
            add_dst = np.zeros(_APPLY_EDGES, np.int32)
            add_alive = np.zeros(_APPLY_EDGES, bool)
            for j, (u, v) in enumerate(ac):
                add_src[j], add_dst[j], add_alive[j] = u, v, True
            rem_src = np.full(_APPLY_EDGES, -1, np.int32)
            rem_dst = np.full(_APPLY_EDGES, -1, np.int32)
            for j, (u, v) in enumerate(mc):
                rem_src[j], rem_dst[j] = u, v
            (self._walk_src, self._walk_dst, self._walk_alive,
             self._walk_off, self._walk_deg) = walk_delta_apply(
                self._walk_src, self._walk_dst, self._walk_alive,
                self._tensor(add_src), self._tensor(add_dst),
                self._tensor(add_alive), self._tensor(rem_src),
                self._tensor(rem_dst), live, n)
            live += len(ac) - len(mc)
        return total_rows

    # -- compaction --------------------------------------------------------
    def compact(self) -> DeviceGraph:
        """Rebuild from scratch at the current version and reclaim the
        delta capacity, through ``Graph.from_edges`` and
        ``DeviceGraph.from_graph`` with the construction's layout
        arguments: the path a fresh build takes, so the result equals
        ``DeviceGraph.from_graph(fresh_graph, layout="sliced", ...)``."""
        self._graph = self.graph()
        return self._attach(self._graph)
