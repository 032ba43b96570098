"""CSR fanout neighbour sampler (GraphSAGE-style) for minibatch_lg, the port
of ``repro/data/neighbor_sampler.py`` on the port's ``ppr.Graph``.

Per hop it uniformly samples up to ``fanout[h]`` out-neighbours of the
current frontier from the CSR structure, deduplicates, and emits a padded
subgraph whose static shapes match the minibatch_lg cell (batch_nodes =
1024, fanout 15-10). Host numpy, deterministic per seed: for the same
``np.random.Generator`` it gives the JAX package's arrays. Global ids
become local ones by a sorted lookup (``searchsorted``) in place of the
JAX module's dict.
"""

from __future__ import annotations

from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np

from ..ppr.graph import Graph


@dataclass(frozen=True)
class SampledSubgraph:
    """Padded subgraph: edges reference *local* node ids (position in
    ``nodes``); ``nodes`` maps local -> global."""

    nodes: np.ndarray          # (N_pad,) int32, global ids (0-padded)
    node_mask: np.ndarray      # (N_pad,) bool
    edge_index: np.ndarray     # (2, M_pad) int32 local ids
    edge_mask: np.ndarray      # (M_pad,) bool
    seed_count: int            # seeds occupy nodes[:seed_count]


def sample_subgraph(graph: Graph, seeds: np.ndarray, fanout: tuple[int, ...],
                    rng: np.random.Generator,
                    pad_nodes: int | None = None,
                    pad_edges: int | None = None) -> SampledSubgraph:
    """Multi-hop uniform fanout sampling over the CSR out-neighbours."""
    seeds = np.asarray(seeds, dtype=np.int64)
    offsets = graph.out_offsets.astype(np.int64)
    targets = graph.edge_dst
    degrees = graph.out_degree.astype(np.int64)

    frontier = np.unique(seeds)
    all_nodes: list[np.ndarray] = [frontier]
    src_l: list[np.ndarray] = []
    dst_l: list[np.ndarray] = []

    for f in fanout:
        deg = degrees[frontier]
        active = frontier[deg > 0]
        if active.size == 0:
            break
        # sample f neighbour slots per active node (with replacement when
        # deg < f, standard GraphSAGE behaviour)
        draw = rng.integers(0, 1 << 62, size=(active.size, f))
        idx = offsets[active][:, None] + (draw % degrees[active][:, None])
        nbrs = targets[idx]                           # (n_active, f) global
        src_l.append(nbrs.reshape(-1))
        dst_l.append(np.repeat(active, f))
        frontier = np.unique(nbrs)
        all_nodes.append(frontier)

    nodes = np.unique(np.concatenate(all_nodes))
    # seeds first (so classification heads read nodes[:seed_count])
    seed_set = np.unique(seeds)
    rest = np.setdiff1d(nodes, seed_set, assume_unique=True)
    ordered = np.concatenate([seed_set, rest])
    # local id of a global one: its place in ``ordered``
    perm = np.argsort(ordered, kind="stable")
    ranked = ordered[perm]

    def local(g: np.ndarray) -> np.ndarray:
        return perm[np.searchsorted(ranked, g)].astype(np.int32)

    if src_l:
        l_src = local(np.concatenate(src_l))
        l_dst = local(np.concatenate(dst_l))
    else:
        l_src = l_dst = np.zeros(0, np.int32)

    n, m = ordered.size, l_src.size
    N = pad_nodes or n
    M = pad_edges or m
    if n > N or m > M:
        raise ValueError(f"subgraph ({n} nodes, {m} edges) exceeds padding "
                         f"({N}, {M})")
    nodes_out = np.zeros(N, np.int32)
    nodes_out[:n] = ordered
    node_mask = np.zeros(N, bool)
    node_mask[:n] = True
    ei = np.zeros((2, M), np.int32)
    ei[0, :m] = l_src
    ei[1, :m] = l_dst
    edge_mask = np.zeros(M, bool)
    edge_mask[:m] = True
    return SampledSubgraph(nodes=nodes_out, node_mask=node_mask,
                           edge_index=ei, edge_mask=edge_mask,
                           seed_count=seed_set.size)


def minibatch_stream(graph: Graph, *, batch_nodes: int,
                     fanout: tuple[int, ...], pad_nodes: int, pad_edges: int,
                     seed: int = 0, shard: int = 0,
                     num_shards: int = 1) -> Iterator[SampledSubgraph]:
    """Endless sampled-subgraph stream, sharded across data-parallel
    hosts."""
    rng = np.random.default_rng(seed * 4001 + shard)
    local = max(1, batch_nodes // num_shards)
    while True:
        seeds = rng.integers(0, graph.n, size=local)
        yield sample_subgraph(graph, seeds, fanout, rng,
                              pad_nodes=pad_nodes, pad_edges=pad_edges)
