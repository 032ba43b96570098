"""The port's dynamic graphs on the CPU: seeded mutation logs and their
records, the two delta ops against the JAX package's, a walk view whose
live prefix equals a fresh build after every batch, a push table that
answers as a fresh build does (and equals the JAX package's table after
the same batches), compaction equal to a fresh build, and the walk index
rebound to a changed residency."""

from __future__ import annotations

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dyn as jdyn
import repro.kernels.ops as jops
import repro.ppr as jppr
import repro_torch.ppr as tppr
from repro_torch.dyn import DynamicGraph, EdgeBatch, MutationLog
from repro_torch.index import WalkIndex
from repro_torch.kernels import ops
from repro_torch.kernels.ell_spmv import sliced_fold
from repro_torch.ppr.graph import DeviceGraph, Graph

# the package exports a function of the same name as this module
tfp = importlib.import_module("repro_torch.ppr.forward_push")

N, W = 30, 8
BUILD = dict(width=W, pad_multiple=8)
FIELDS = ("edge_src", "edge_dst", "out_offsets", "out_degree",
          "in_neighbors", "in_mask", "in_weights", "in_row_map")


def _graph(n=N, m=120, seed=0):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n, size=(m, 2))
    keep = pairs[:, 0] != pairs[:, 1]
    return Graph.from_edges(n, pairs[keep, 0], pairs[keep, 1], directed=True)


def _jax_graph(g: Graph) -> jppr.Graph:
    return jppr.Graph(n=g.n, edge_src=g.edge_src, edge_dst=g.edge_dst)


def _dyn(g: Graph) -> DynamicGraph:
    return DynamicGraph(g, device="cpu", **BUILD)


def _fresh(dyn: DynamicGraph) -> DeviceGraph:
    """The residency a fresh build gives at dyn's current version."""
    return DeviceGraph.from_graph(dyn.graph(), layout="sliced", device="cpu",
                                  **BUILD)


def _assert_dg_identical(a, b):
    assert a.n == b.n and a.m == b.m and a.ell_width == b.ell_width
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("row_ptr", "items", "hubs", "hub_chunks"):
        assert torch.equal(getattr(a.in_fold, f), getattr(b.in_fold, f)), f


def _push_pi(dg, sources=(0, 3, 7)):
    seeds = tfp.one_hot_seeds(sources, dg.n, dg.device)
    res = tfp.forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                           dg.out_degree, seeds, alpha=0.2, rmax=1e-3,
                           row_map=dg.in_row_map, fold=dg.in_fold)
    return res.pi.numpy()


# ---------------------------------------------------------------------------
# MutationLog: records, monotone versions, seeded determinism


def test_edge_batch_and_log_record_roundtrip():
    log = MutationLog(base_version=3)
    b1 = log.append(adds=[(0, 1), (2, 3)], removes=[(4, 5)])
    b2 = log.append(removes=[(0, 1)])
    assert (b1.version, b2.version) == (4, 5)
    assert b1.size == 3 and log.version == 5
    back = MutationLog.from_records(log.to_records(), base_version=3)
    assert len(back) == 2 and back.version == 5
    np.testing.assert_array_equal(back[0].adds, b1.adds)
    np.testing.assert_array_equal(back[1].removes, b2.removes)
    rt = EdgeBatch.from_record(b1.to_record())
    assert rt.version == 4 and rt.adds.dtype == np.int32
    # the JAX package reads the port's records and the port reads its own
    jback = jdyn.MutationLog.from_records(log.to_records(), base_version=3)
    assert jback.to_records() == log.to_records()


def test_log_version_monotonicity_enforced():
    log = MutationLog()
    log.append(adds=[(0, 1)])
    with pytest.raises(ValueError, match="does not follow"):
        log.record(EdgeBatch(adds=np.zeros((0, 2), np.int32),
                             removes=np.zeros((0, 2), np.int32), version=5))
    recs = log.to_records()
    recs[0]["version"] = 7
    with pytest.raises(ValueError, match="corrupt"):
        MutationLog.from_records(recs)
    with pytest.raises(ValueError, match="\\(k, 2\\)"):
        log.append(adds=[(0, 1, 2)])


@pytest.mark.parametrize("seed,batch_edges,add_frac",
                         [(11, 8, 0.5), (3, 16, 0.8), (5, 4, 0.1)])
def test_seeded_log_is_deterministic_effective_and_jax_s(seed, batch_edges,
                                                       add_frac):
    g = _graph()
    a = MutationLog.seeded(g, 4, seed=seed, batch_edges=batch_edges,
                           add_frac=add_frac)
    b = MutationLog.seeded(g, 4, seed=seed, batch_edges=batch_edges,
                           add_frac=add_frac)
    assert a.to_records() == b.to_records()
    assert MutationLog.seeded(g, 4, seed=seed + 1).to_records() != \
        a.to_records()
    assert a.to_records() == jdyn.MutationLog.seeded(
        _jax_graph(g), 4, seed=seed, batch_edges=batch_edges,
        add_frac=add_frac).to_records()
    # every batch is effective structural change, never self-loops
    live = {(int(u), int(v)) for u, v in zip(g.edge_src, g.edge_dst)
            if u != v}
    touched = 0
    for batch in a:
        for u, v in batch.adds:
            assert u != v and (int(u), int(v)) not in live
            live.add((int(u), int(v)))
        for u, v in batch.removes:
            assert (int(u), int(v)) in live
            live.discard((int(u), int(v)))
        touched += batch.size
    assert touched > 0


# ---------------------------------------------------------------------------
# the delta ops against the JAX package's


def test_delta_ops_match_jax():
    rng = np.random.default_rng(1)
    n, C, Wd, A, R = 40, 64, 8, 8, 16
    rm = np.sort(rng.integers(0, n, C - 10)).astype(np.int32)
    rm = np.concatenate([rm, np.full(10, n, np.int32)])
    nbr = rng.integers(0, n, (C, Wd)).astype(np.int32)
    mask = rng.random((C, Wd)) < 0.7
    inv = (1.0 / rng.integers(1, 9, n)).astype(np.float32)
    add_nbr = rng.integers(0, n, (A, Wd)).astype(np.int32)
    add_mask = rng.random((A, Wd)) < 0.5
    add_rm = np.concatenate([rng.integers(0, n, A - 3),
                             np.full(3, n)]).astype(np.int32)
    pick = rng.integers(0, C - 10, R - 4)
    rem_dst = np.concatenate([rm[pick], np.full(4, -1)]).astype(np.int32)
    rem_src = np.concatenate([nbr[pick, rng.integers(0, Wd, R - 4)],
                              np.full(4, -1)]).astype(np.int32)
    deg_nodes = np.concatenate([rng.permutation(n)[:5],
                                np.full(R - 5, n)]).astype(np.int32)
    deg_inv = (1.0 / rng.integers(1, 9, R)).astype(np.float32)
    cursor = C - 10
    want = jops.push_delta_apply(
        *map(jnp.asarray, (nbr, mask, rm, inv, add_nbr, add_mask, add_rm,
                           rem_src, rem_dst, deg_nodes, deg_inv)),
        jnp.int32(cursor))
    got = ops.push_delta_apply(
        *map(torch.from_numpy, (nbr, mask, rm, inv, add_nbr, add_mask,
                                add_rm, rem_src, rem_dst, deg_nodes,
                                deg_inv)), cursor)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    # the walk view: a small graph's CSR with spare slots
    gr = _graph(n=n, m=200, seed=2)
    m = gr.m
    E = m + 64
    src = np.concatenate([gr.edge_src, np.full(64, n)]).astype(np.int32)
    dst = np.concatenate([gr.edge_dst, np.zeros(64)]).astype(np.int32)
    alive = np.concatenate([np.ones(m, bool), np.zeros(64, bool)])
    take = rng.permutation(m)[:10]
    rem_src = np.concatenate([gr.edge_src[take], np.full(6, -1)])
    rem_dst = np.concatenate([gr.edge_dst[take], np.full(6, -1)])
    add_src = np.concatenate([rng.integers(0, n, 12), np.full(4, n)])
    add_dst = rng.integers(0, n, 16)
    add_alive = np.arange(16) < 12
    args = (src, dst, alive, add_src.astype(np.int32),
            add_dst.astype(np.int32), add_alive, rem_src.astype(np.int32),
            rem_dst.astype(np.int32))
    want = jops.walk_delta_apply(*map(jnp.asarray, args), jnp.int32(m),
                                 n=n)
    got = ops.walk_delta_apply(*map(torch.from_numpy, args), m, n)
    assert E == src.size
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


# ---------------------------------------------------------------------------
# DynamicGraph: delta application against the fresh build


def test_delta_walk_view_equals_fresh_build_after_every_batch():
    g = _graph(seed=3)
    dyn = _dyn(g)
    for batch in MutationLog.seeded(g, 4, seed=7):
        dyn.apply(batch)
        fresh = _fresh(dyn)
        m = fresh.m
        assert dyn.dg.m == m == dyn.live_edges
        # the live prefix of the CSR walk arrays: a rebuild's exact arrays
        assert torch.equal(dyn.dg.edge_src[:m], fresh.edge_src)
        assert torch.equal(dyn.dg.edge_dst[:m], fresh.edge_dst)
        assert torch.equal(dyn.dg.out_offsets, fresh.out_offsets)
        assert torch.equal(dyn.dg.out_degree, fresh.out_degree)
        # past the live prefix: dead capacity, which the walks never read
        assert bool(dyn._walk_alive[:m].all())
        assert not bool(dyn._walk_alive[m:].any())


def test_delta_push_table_answers_match_fresh_build_and_jax():
    g = _graph(seed=3)
    dyn = _dyn(g)
    jdg = jdyn.DynamicGraph(_jax_graph(g), **BUILD)
    for batch in MutationLog.seeded(g, 4, seed=7):
        dyn.apply(batch)
        jdg.apply(jdyn.EdgeBatch.from_record(batch.to_record()))
        fresh = _fresh(dyn)
        want = _push_pi(fresh)
        np.testing.assert_allclose(_push_pi(dyn.dg), want, rtol=1e-5,
                                   atol=1e-7)
        # the same table as the JAX package's after the same batches
        for f in ("in_neighbors", "in_mask", "in_weights", "in_row_map"):
            np.testing.assert_array_equal(getattr(dyn.dg, f).numpy(),
                                          np.asarray(getattr(jdg.dg, f)))
        # row_map ascending with the spare rows (row_map == n) at the tail,
        # and the fold rebuilt from it: K2 reads rows up to row_ptr[n]
        rm = dyn.dg.in_row_map
        assert bool((rm[1:] >= rm[:-1]).all()) and int(rm[-1]) == g.n
        fold = dyn.dg.in_fold
        want_fold = sliced_fold(rm, g.n, dyn.width)
        for f in ("row_ptr", "items", "hubs", "hub_chunks"):
            assert torch.equal(getattr(fold, f), getattr(want_fold, f))
        assert int(fold.row_ptr[-1]) == int((rm < g.n).sum())
        assert fold.rows == rm.numel() and dyn.dg.in_plan is None


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 3), (2, 6)])
def test_apply_then_compact_bit_identity(seed, k):
    """compact() after k batches gives a residency equal, every array and
    the fold, to a fresh build at the same version."""
    g = _graph(seed=seed)
    dyn = _dyn(g)
    for batch in MutationLog.seeded(g, k, seed=seed + 10, batch_edges=8):
        dyn.apply(batch)
    fresh = _fresh(dyn)
    compacted = dyn.compact()
    _assert_dg_identical(compacted, fresh)
    assert dyn.version == k
    # compaction keeps the mirror: the stream continues at version k + 1
    info = dyn.mutate(adds=[(0, 9)])
    assert info.version == k + 1 and dyn.version == k + 1


def test_answers_invariant_to_compaction_timing():
    """When compaction runs does not change what queries return."""
    g = _graph(seed=5)
    log = MutationLog.seeded(g, 4, seed=3)
    rng = np.random.default_rng(2)
    Wk, L = 64, 42
    draws = tppr.TableDraws(
        torch.from_numpy(rng.random((2, Wk), dtype=np.float32)),
        torch.from_numpy(rng.integers(0, 1 << 30, (L, 2, Wk),
                                      dtype=np.int32)))
    pis = []
    for compact_after in ((), (2,), (1, 2, 3, 4)):
        dyn = _dyn(g)
        for i, batch in enumerate(log, start=1):
            dyn.apply_record(batch.to_record())     # a replayed record
            if i in compact_after:
                dyn.compact()
        res = tppr.fora_fused(dyn.dg, np.asarray([0, 4]), tppr.ForaParams(),
                              num_walks=Wk, draws=draws, device="cpu")
        pis.append(res.pi.numpy())
    np.testing.assert_allclose(pis[1], pis[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pis[2], pis[0], rtol=1e-4, atol=1e-6)


def test_add_then_remove_restores_original_residency():
    g = _graph(seed=6)
    base = DeviceGraph.from_graph(g, layout="sliced", device="cpu", **BUILD)
    dyn = _dyn(g)
    live = {(int(u), int(v)) for u, v in zip(g.edge_src, g.edge_dst)}
    adds = [(u, v) for u in range(g.n) for v in range(g.n)
            if u != v and (u, v) not in live][:3]
    dyn.mutate(adds=adds)
    dyn.mutate(removes=adds)
    assert dyn.version == 2 and len(dyn.log) == 2
    _assert_dg_identical(dyn.compact(), base)


def test_apply_rejects_out_of_order_and_out_of_range():
    g = _graph()
    dyn = _dyn(g)
    batch = dyn.log.append(adds=[(0, 1)])
    dyn.apply(batch)
    with pytest.raises(ValueError, match="does not follow"):
        dyn.apply(batch)                            # replayed twice
    with pytest.raises(ValueError, match="out of range"):
        dyn.mutate(adds=[(0, g.n)])
    import dataclasses as dc
    scrambled = dc.replace(g, edge_src=g.edge_src[::-1].copy(),
                           edge_dst=g.edge_dst[::-1].copy())
    with pytest.raises(ValueError, match="from_edges-normalised"):
        DynamicGraph(scrambled, device="cpu", **BUILD)


def test_capacity_growth_preserves_identity():
    """Enough churn to outgrow the first capacity: the device tables grow
    and compaction still equals a fresh build."""
    g = _graph(seed=9, m=60)
    dyn = _dyn(g)
    cap0 = int(dyn._push_rm.shape[0])
    ecap0 = int(dyn._walk_src.shape[0])
    log = MutationLog.seeded(g, 24, seed=4, batch_edges=16, add_frac=0.8)
    for batch in log:
        dyn.apply(batch)
    assert int(dyn._push_rm.shape[0]) > cap0        # growth actually fired
    assert int(dyn._walk_src.shape[0]) >= ecap0
    fresh = _fresh(dyn)
    assert torch.equal(dyn.dg.edge_dst[:fresh.m], fresh.edge_dst)
    np.testing.assert_allclose(_push_pi(dyn.dg), _push_pi(fresh), rtol=1e-5,
                               atol=1e-7)
    _assert_dg_identical(dyn.compact(), fresh)


def test_undirected_batches_are_symmetrised():
    g0 = _graph(seed=4)
    g = Graph.from_edges(g0.n, g0.edge_src, g0.edge_dst, directed=False)
    dyn = _dyn(g)
    live = {(int(u), int(v)) for u, v in zip(g.edge_src, g.edge_dst)}
    u, v = next((u, v) for u in range(g.n) for v in range(g.n)
                if u != v and (u, v) not in live)
    info = dyn.mutate(adds=[(u, v)])
    assert info.adds_applied >= 2 and {u, v} <= set(info.affected.tolist())
    _assert_dg_identical(dyn.compact(), _fresh(dyn))


# ---------------------------------------------------------------------------
# the walk index on a changed residency


def test_walk_index_rebind_and_refresh_hottest():
    g = _graph(seed=2)
    dyn = _dyn(g)
    idx = WalkIndex.build(dyn.dg, width=4, alpha=0.2, seed=1)
    live = {(int(u), int(v)) for u, v in zip(g.edge_src, g.edge_dst)}
    adds, used = [], set()
    for u in range(g.n):                            # two fresh sources
        for v in range(g.n):
            if u != v and u not in used and (u, v) not in live:
                adds.append((u, v))
                used.add(u)
                break
        if len(adds) == 2:
            break
    info = dyn.mutate(adds=adds)
    idx.rebind(dyn.dg, graph_version=info.version)
    assert idx.graph_version == info.version
    assert idx.graph_arrays[0] is dyn.dg.edge_dst
    idx.retire(info.affected)
    assert idx.partial and idx.coverage(64) == 0.0
    affected = [int(v) for v in info.affected]
    assert used <= set(affected)
    hot = affected[-1]
    picked = idx.refresh_hottest(info.affected, budget=1, heat={hot: 4.0})
    assert picked.tolist() == [hot]
    budgets = idx.budget.numpy()
    assert budgets[hot] == 4                        # refreshed to full
    cold = [v for v in affected if v != hot]
    assert all(budgets[v] == 0 for v in cold)       # the rest stay retired
    assert idx.refresh_hottest(info.affected, budget=0).size == 0
    # the refreshed row walks the changed graph
    fresh = _fresh(dyn)
    assert bool((idx.endpoints[hot] < g.n).all())
    assert torch.equal(idx.graph_arrays[1], fresh.out_offsets)


def test_walk_index_rebind_rejects_node_count_mismatch():
    g = _graph()
    idx = WalkIndex.build(DeviceGraph.from_graph(g, layout="sliced",
                                                 device="cpu", **BUILD),
                          width=2, alpha=0.2)
    with pytest.raises(ValueError, match="node additions"):
        idx.rebind(types.SimpleNamespace(n=g.n + 1))
