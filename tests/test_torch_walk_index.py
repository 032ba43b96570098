"""Port parity of the walk index on the CPU: K3's plain version against the
JAX package's oracle and its Pallas kernel in interpret mode, the index
build on the JAX package's lane streams, the port's own hash streams, the
index-backed fused query fed the JAX package's index, starts and streams,
and the index's maintenance and executor contracts.

Tolerances: K3's plain version and the fused query against the JAX package
at rtol 1e-5 with atol 1e-6 of the largest output entry (float32 sums of
up to a few hundred terms in another order); integer results (endpoints,
starts, budgets) array-equal. Within the port, budget configurations of an
unrefreshed index are compared allclose at the same tolerance, because the
table and live lanes are folded by two different reductions, and a repeat
of one configuration must give the same bits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ppr as jppr
import repro_torch.ppr as tppr
from repro.index import WalkIndex as JaxWalkIndex
from repro.kernels import ref as jref
from repro.kernels.walk_gather import walk_endpoint_gather_pallas
from repro.ppr.random_walk import lane_streams as jax_lane_streams
from repro_torch.index import WalkIndex, walk_rows
from repro_torch.kernels import ops, ref, walk_gather
from repro_torch.ppr.random_walk import (LaneStreams, TableDraws,
                                         TableLaneStreams, walk_endpoints)

RTOL = 1e-5
ATOL_FRAC = 1e-6
SOURCES = np.array([0, 7, 42])
JPARAMS = jppr.ForaParams(alpha=0.2, epsilon=0.5)
TPARAMS = tppr.ForaParams(alpha=0.2, epsilon=0.5)
STEPS = tppr.walk_length_for_tail(0.2, 1e-4)


@pytest.fixture(scope="module")
def graphs():
    return (jppr.small_test_graph(n=120, avg_deg=6, seed=0),
            tppr.small_test_graph(n=120, avg_deg=6, seed=0))


@pytest.fixture(scope="module")
def graph80():
    return tppr.small_test_graph(n=80, avg_deg=5, seed=1)


def _close(got, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_FRAC * float(np.abs(want).max()))


def _index(graph, width, seed=3) -> WalkIndex:
    return WalkIndex.build(graph.device("cpu"), width=width, alpha=0.2,
                           seed=seed)


def _gather_inputs(n, W, B, L, retired, seed):
    rng = np.random.default_rng(seed)
    endpoints = rng.integers(0, n, (n, W)).astype(np.int32)
    budget = np.full(n, W, np.int32)
    if retired:
        rows = rng.choice(n, size=n // 3, replace=False)
        budget[rows] = rng.integers(0, W + 1, rows.size)
    starts = rng.integers(0, n, (B, L)).astype(np.int32)
    weights = rng.random((B, L)).astype(np.float32)
    return endpoints, budget, starts, weights


# ---------------------------------------------------------------------------
# K3's plain version


@pytest.mark.parametrize("B,L", [(1, 1), (3, 130), (4, 24), (2, 256)])
@pytest.mark.parametrize("retired", [False, True])
def test_gather_plain_matches_jax_oracle_and_pallas(B, L, retired):
    arrays = _gather_inputs(300, 260, B, L, retired, seed=B * 1000 + L)
    got = ref.walk_endpoint_gather_ref(*map(torch.from_numpy, arrays))
    assert got.dtype == torch.float32 and got.shape == (B, 300)
    jarrays = [jnp.asarray(a) for a in arrays]
    _close(got.numpy(), jref.walk_endpoint_gather_ref(*jarrays))
    _close(got.numpy(), walk_endpoint_gather_pallas(*jarrays))
    # the CPU dispatch is the plain version
    assert torch.equal(ops.walk_endpoint_gather(
        *map(torch.from_numpy, arrays)), got)


def test_gather_budget_masks_lanes():
    """Lane i counts iff i < budget[start]: here only lane 3 (at node 4,
    budget 4) lands, as in the JAX package's test."""
    endpoints = torch.full((8, 4), 5, dtype=torch.int32)
    budget = torch.tensor([0, 1, 2, 3, 4, 4, 4, 4], dtype=torch.int32)
    starts = torch.tensor([[0, 1, 2, 4]], dtype=torch.int32)
    out = ref.walk_endpoint_gather_ref(endpoints, budget, starts,
                                       torch.ones(1, 4))
    assert float(out[0, 5]) == 1.0 and float(out.sum()) == 1.0


def test_gather_wrapper_takes_only_cuda_tensors():
    arrays = [torch.from_numpy(a)
              for a in _gather_inputs(50, 16, 2, 16, False, seed=0)]
    with pytest.raises(ValueError, match="CUDA"):
        walk_gather.walk_endpoint_gather_cuda(*arrays)
    assert walk_gather.LAUNCHES["walk_endpoint_gather"] == 0


# ---------------------------------------------------------------------------
# lane streams and the build


def _splitmix_reference(key: int, lanes: np.ndarray, t: int) -> np.ndarray:
    """splitmix64 output number i * 2^16 + t + 1 from ``key``, top 30 bits,
    in numpy's wrapping uint64 arithmetic."""
    with np.errstate(over="ignore"):
        z = (np.uint64(key) + (lanes.astype(np.uint64) * np.uint64(1 << 16)
                               + np.uint64(t + 1))
             * np.uint64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(34)).astype(np.int32)


def test_hash_streams_are_splitmix_and_subset_invariant():
    streams = LaneStreams(11)
    full = torch.stack(list(streams.steps(torch.arange(4096), STEPS)))
    assert full.dtype == torch.int32 and full.shape == (STEPS, 4096)
    assert int(full.min()) >= 0 and int(full.max()) < 1 << 30
    for t in (0, 1, STEPS - 1):
        np.testing.assert_array_equal(
            full[t].numpy(),
            _splitmix_reference(streams.key, np.arange(4096), t))
    # any subset of lanes, in any order, gets the same draws
    lanes = torch.from_numpy(np.random.default_rng(0).permutation(4096)[:77])
    sub = torch.stack(list(streams.steps(lanes, STEPS)))
    assert torch.equal(sub, full[:, lanes])
    # near-uniform draws; fresh streams differ
    assert abs(float(full.double().mean()) / 2**30 - 0.5) < 0.01
    fresh = torch.stack(list(streams.fold_in(1).steps(torch.arange(64), 3)))
    assert (fresh != full[:3, :64]).float().mean() > 0.99
    assert LaneStreams(11).key == streams.key != LaneStreams(12).key


@pytest.mark.parametrize("lane_block", [None, 48, 7])
def test_build_on_jax_lane_streams_equals_jax_index(graphs, lane_block):
    jg, tg = graphs
    width = 100
    jidx = JaxWalkIndex.build(jg.device(), width=width, alpha=0.2, seed=3)
    table = jax_lane_streams(jidx.key, jnp.arange(width, dtype=jnp.int32),
                             jidx.num_steps)
    idx = WalkIndex.build(tg.device("cpu"), width=width, alpha=0.2,
                          streams=TableLaneStreams(
                              torch.from_numpy(np.array(table))),
                          lane_block=lane_block)
    assert idx.num_steps == jidx.num_steps and idx.n == jidx.n
    np.testing.assert_array_equal(idx.endpoints.numpy(),
                                  np.asarray(jidx.endpoints))
    np.testing.assert_array_equal(idx.budget.numpy(),
                                  np.asarray(jidx.budget))
    assert idx.nbytes == jidx.nbytes


def test_index_rows_match_live_walkers(graphs):
    """endpoints[v, i] equals a live walk from v on lane i's stream, and
    the table does not depend on the lane block it was built in."""
    tg = graphs[1]
    dg = tg.device("cpu")
    idx = _index(tg, width=160)
    lanes = torch.arange(160)
    for v in [0, 7, 42, tg.n - 1]:
        live = walk_endpoints(dg.edge_dst, dg.out_offsets, dg.out_degree,
                              torch.full((160,), v, dtype=torch.int32),
                              idx.streams.steps(lanes, idx.num_steps),
                              alpha=0.2)
        assert torch.equal(idx.endpoints[v], live)
    rows = walk_rows((dg.edge_dst, dg.out_offsets, dg.out_degree),
                     torch.tensor([42, 3]), idx.streams, 160, alpha=0.2,
                     num_steps=idx.num_steps, lane_block=13)
    assert torch.equal(rows, idx.endpoints[[42, 3]])


# ---------------------------------------------------------------------------
# the index-backed fused query against the JAX package


def _jax_start_uniforms(key, qids, W: int) -> torch.Tensor:
    """The start uniforms ``repro``'s fused query draws per query id:
    fold_in(key, qid), split once, the first half."""
    u = [np.asarray(jax.random.uniform(
        jax.random.split(jax.random.fold_in(key, int(q)))[0], (W,)))
        for q in qids]
    return torch.from_numpy(np.stack(u))


@pytest.mark.parametrize("case", ["full", "partial", "shortfall"])
def test_fora_fused_with_index_matches_jax(graphs, case):
    jg, tg = graphs
    width, W = (64, 256) if case == "shortfall" else (256, 256)
    jidx = JaxWalkIndex.build(jg.device(), width=width, alpha=0.2, seed=7)
    if case == "partial":
        rng = np.random.default_rng(1)
        nodes = rng.choice(jg.n, size=jg.n // 3, replace=False)
        jidx.retire(nodes, budget=int(rng.integers(0, width)))
        assert jidx.partial
    key = jax.random.PRNGKey(5)
    qids = np.array([11, 4, 29], np.int32)
    j = jppr.fora_fused(jg.device(), SOURCES, JPARAMS, key, num_walks=W,
                        index=jidx, query_seeds=qids)
    table = jax_lane_streams(jidx.key, jnp.arange(W, dtype=jnp.int32),
                             jidx.num_steps)
    idx = WalkIndex.from_arrays(
        {"endpoints": np.asarray(jidx.endpoints),
         "budget": np.asarray(jidx.budget), "alpha": jidx.alpha,
         "num_steps": jidx.num_steps, "partial": jidx.partial},
        streams=TableLaneStreams(torch.from_numpy(np.array(table))),
        device="cpu")
    assert idx.partial == (case == "partial")
    u = _jax_start_uniforms(key, qids, W)
    draws = TableDraws(u, torch.zeros((1, *u.shape), dtype=torch.int32))
    t = tppr.fora_fused(tg.device("cpu"), SOURCES, TPARAMS, num_walks=W,
                        draws=draws, index=idx, device="cpu")
    assert t.walks_budget == j.walks_budget == W
    assert int(t.push_iters) == int(j.push_iters)
    np.testing.assert_array_equal(t.walks_effective.numpy(),
                                  np.asarray(j.walks_effective))
    _close(t.pi.numpy(), j.pi)


# ---------------------------------------------------------------------------
# the port's own invariants


def _fused(graph, idx, W, seed=5, sources=(3, 11)):
    return tppr.fora_fused(graph.device("cpu"), list(sources), TPARAMS,
                           seed=seed, num_walks=W, index=idx, device="cpu")


@pytest.mark.parametrize("case", range(6))
def test_any_budget_configuration_matches_all_live(graph80, case):
    """Budgets only move lanes between the table and the live walk on the
    same streams, so every configuration of an unrefreshed index gives the
    all-live answer (allclose: two reductions), and a repeat gives the
    same bits."""
    all_live = _index(graph80, width=128, seed=7)
    all_live.retire(np.arange(graph80.n))
    want = _fused(graph80, all_live, 128, seed=case)
    rng = np.random.default_rng(case)
    idx = _index(graph80, width=128, seed=7)
    nodes = rng.choice(graph80.n, size=rng.integers(1, graph80.n),
                       replace=False)
    idx.retire(nodes, budget=int(rng.integers(0, 129)))
    got = _fused(graph80, idx, 128, seed=case)
    _close(got.pi.numpy(), want.pi.numpy())
    assert torch.equal(_fused(graph80, idx, 128, seed=case).pi, got.pi)


def test_full_coverage_and_shortfall_match_all_live(graphs):
    tg = graphs[1]
    for width in (256, 64):              # full coverage, then a shortfall
        all_live = _index(tg, width=width, seed=9)
        all_live.retire(np.arange(tg.n))
        want = _fused(tg, all_live, 256, sources=(0, 42))
        got = _fused(tg, _index(tg, width=width, seed=9), 256,
                     sources=(0, 42))
        _close(got.pi.numpy(), want.pi.numpy())
        assert torch.equal(got.walks_effective, want.walks_effective)


def test_partial_coverage_meets_fora_guarantee(graphs):
    """With refreshed rows (off the base streams) and retired ones the
    estimator still meets |pi_hat - pi| <= eps * pi for pi >= 1/n."""
    jg, tg = graphs
    exact = jppr.ppr_power_iteration(jg, SOURCES, alpha=0.2)
    idx = _index(tg, width=512, seed=4)
    idx.refresh(np.arange(0, tg.n, 3))
    idx.retire(np.arange(1, tg.n, 3), budget=128)
    res = tppr.fora_fused(tg.device("cpu"), SOURCES, TPARAMS, index=idx,
                          device="cpu")
    pi = res.pi.numpy()
    mask = exact >= 1.0 / tg.n
    rel = np.abs(pi - exact)[mask] / exact[mask]
    assert rel.max() < 0.5, f"rel err {rel.max()} exceeds eps"
    assert np.allclose(pi.sum(axis=1), 1.0, atol=1e-3)


def test_refresh_decorrelates_and_restores_budget(graphs):
    tg = graphs[1]
    idx = _index(tg, width=64)
    before = idx.endpoints.clone()
    nodes = np.arange(0, tg.n, 2)
    idx.retire(nodes, budget=0)
    assert idx.partial
    idx.refresh(nodes)
    assert idx.refreshed == nodes.size
    assert (idx.budget[nodes] == idx.width).all()
    changed = (before[nodes] != idx.endpoints[nodes]).float().mean()
    assert changed > 0.5, "refresh must redraw rows on fresh streams"
    untouched = np.setdiff1d(np.arange(tg.n), nodes)
    assert torch.equal(before[untouched], idx.endpoints[untouched])
    # a second refresh of the same rows draws on other streams again
    again = idx.endpoints[nodes].clone()
    idx.refresh(nodes)
    assert (again != idx.endpoints[nodes]).float().mean() > 0.5


def test_refresh_hottest_and_rebind(graphs, graph80):
    tg = graphs[1]
    idx = _index(tg, width=32)
    before = idx.endpoints.clone()
    picked = idx.refresh_hottest(np.array([5, 9, 2, 9]), budget=2,
                                 heat={9: 3.0, 2: 1.0})
    np.testing.assert_array_equal(picked, [9, 2])
    assert not torch.equal(before[9], idx.endpoints[9])
    assert torch.equal(before[5], idx.endpoints[5])
    assert idx.refresh_hottest(np.array([1]), budget=0).size == 0
    with pytest.raises(ValueError, match="n=80"):
        idx.rebind(graph80.device("cpu"))
    dg = tg.device("cpu")
    idx.rebind(dg, graph_version=4)
    assert idx.graph_version == 4 and idx.graph_arrays[0] is dg.edge_dst
    # an index carried across has no graph until one is bound
    carried = WalkIndex.from_arrays(
        {"endpoints": idx.endpoints.numpy(), "budget": idx.budget.numpy(),
         "alpha": 0.2, "num_steps": idx.num_steps},
        streams=idx.streams, device="cpu")
    with pytest.raises(ValueError, match="rebind"):
        carried.refresh([0])
    carried.rebind(dg)
    carried.refresh([0])
    assert carried.refreshed == 1


def test_coverage_and_validation(graphs):
    tg = graphs[1]
    idx = _index(tg, width=64)
    assert idx.coverage(64) == 1.0
    assert idx.coverage(256) == pytest.approx(0.25)
    idx.retire(np.arange(tg.n), budget=32)
    assert idx.coverage(64) == 0.0           # partial: no time saved
    with pytest.raises(ValueError):
        idx.coverage(0)
    with pytest.raises(ValueError):
        idx.retire([0], budget=65)
    with pytest.raises(ValueError, match="width"):
        _index(tg, width=0)
    dg = tg.device("cpu")
    with pytest.raises(ValueError, match="rebuild the index"):
        tppr.fora_fused(dg, [0], tppr.ForaParams(alpha=0.3, epsilon=0.5),
                        index=idx, device="cpu")
    other = tppr.small_test_graph(n=80, avg_deg=5, seed=1).device("cpu")
    with pytest.raises(ValueError, match="n=120"):
        tppr.fora_fused(other, [0], TPARAMS, index=idx, device="cpu")


def test_executor_builds_index_once_and_covers(graphs):
    tg = graphs[1]
    workload = tppr.PprWorkload(tg, num_queries=8, seed=0)
    builds = WalkIndex.builds
    ex = tppr.ForaExecutor(workload, TPARAMS, index_budget=1 << 11,
                           device="cpu")
    assert ex.index_coverage == 0.0           # not warmed yet
    stats = ex(list(range(4)))
    assert stats.n == 4 and (stats.times > 0).all()
    assert WalkIndex.builds == builds + 1
    assert ex.index_coverage == 1.0           # 2^11 covers the budget
    assert ex.walk_index.width == 1 << 11
    ex.run_chunk([4, 5])
    assert WalkIndex.builds == builds + 1     # build once
    idx = ex.walk_index
    ex.degrade(0.5)
    ex.run_chunk([6, 7])
    assert ex.walk_index is idx and WalkIndex.builds == builds + 1
    # the executor's answers are fora_fused's with its index
    res = tppr.fora_fused(ex.device_graph, [workload.source_of(3)],
                          ex.params, seed=0, num_walks=ex._num_walks,
                          query_ids=[3], index=idx, device="cpu")
    assert np.isfinite(res.pi.numpy()).all()
    with pytest.raises(ValueError, match="index_budget"):
        tppr.ForaExecutor(workload, TPARAMS, index_budget=-1, device="cpu")


def test_executor_serves_a_prebuilt_index(graphs):
    tg = graphs[1]
    workload = tppr.PprWorkload(tg, num_queries=8, seed=0)
    built = tppr.ForaExecutor(workload, TPARAMS, index_budget=1 << 11,
                              device="cpu")
    want = built(list(range(4)))
    builds = WalkIndex.builds
    ex = tppr.ForaExecutor(workload, TPARAMS, walk_index=built.walk_index,
                           device="cpu")
    assert ex.index_budget == 1 << 11
    ex(list(range(4)))
    assert WalkIndex.builds == builds            # warmup built none
    assert ex.walk_index is built.walk_index and ex.index_coverage == 1.0
    # both executors give one answer: the same index, draws and sources
    res = [tppr.fora_fused(e.device_graph, [workload.source_of(2)], e.params,
                           seed=0, num_walks=e.current_walk_budget(),
                           query_ids=[2], index=e.walk_index,
                           device="cpu").pi for e in (built, ex)]
    assert torch.equal(*res)
    with pytest.raises(ValueError, match="width"):
        tppr.ForaExecutor(workload, TPARAMS, index_budget=64,
                          walk_index=built.walk_index, device="cpu")


@pytest.mark.parametrize("field,value,match", [
    ("endpoints", -1, r"endpoints must lie in \[0, 120\)"),
    ("endpoints", 120, r"endpoints must lie in \[0, 120\)"),
    ("budget", -1, r"budget must lie in \[0, 4\]"),
    ("budget", 5, r"budget must lie in \[0, 4\]"),
])
def test_from_arrays_refuses_out_of_range_tables(graphs, field, value,
                                                 match):
    # K3 drops such lanes where its plain version raises; the index must
    # never hold one
    tg = graphs[1]
    arrays = {"endpoints": np.zeros((tg.n, 4), np.int32),
              "budget": np.full(tg.n, 4, np.int32), "alpha": 0.2,
              "num_steps": STEPS}
    arrays[field] = arrays[field].copy()
    arrays[field].flat[7] = value
    with pytest.raises(ValueError, match=match):
        WalkIndex.from_arrays(arrays, streams=LaneStreams(0), device="cpu")


def test_index_entry_points_default_to_cuda(graphs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tg = graphs[1]
    arrays = {"endpoints": np.zeros((tg.n, 4), np.int32),
              "budget": np.full(tg.n, 4, np.int32), "alpha": 0.2,
              "num_steps": STEPS}
    with pytest.raises(RuntimeError, match="CUDA"):
        WalkIndex.from_arrays(arrays, streams=LaneStreams(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tppr.ForaExecutor(tppr.PprWorkload(tg, 4), index_budget=8)


def test_quickstart_with_walk_index_on_cpu():
    from repro_torch import quickstart

    out = quickstart.run(scale=512, num_queries=16, index_budget=1 << 12,
                         device="cpu", log=lambda s: None)
    assert out["accepted"] and out["index_width"] == 1 << 12
    assert out["index_coverage"] == 1.0 and out["walk_lanes"] <= 1 << 12
    assert out["fora_max_rel_err"] < 0.5


@pytest.mark.parametrize("n,B,sms,want", [
    (281_903, 1, 132, (2144, 132)),      # the paper index path
    (2000, 1, 132, (32, 63)),            # the dense index path
    (2000, 8, 132, (128, 16)),
    (281_903, 8, 132, (4096, 69)),
    (5, 3, 132, (32, 1)),
    (100_000, 64, 132, (4096, 25)),
])
def test_walk_gather_fold_plan(n, B, sms, want):
    cells, blocks = walk_gather.fold_plan(n, B, sms)
    assert (cells, blocks) == want
    assert cells % 32 == 0 and 32 <= cells <= walk_gather.FOLD_MAX_CELLS
    assert (blocks - 1) * cells < n <= blocks * cells
    with pytest.raises(ValueError):
        walk_gather.fold_plan(n, 0, sms)
