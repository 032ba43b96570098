"""The port's node-sharded residency on the CPU, mirroring
``tests/test_sharded.py``: the residency's row blocks and its upload-once
LRU; its shards array-equal to the JAX package's ``ShardedDeviceGraph``
shards (one subprocess with eight forced host devices); the per-shard
SpMMs; sharded fused FORA against single-device fused FORA on the JAX
package's draws, bit for bit at one shard and on repeated calls; the
host syncs of a sharded query; ``ForaExecutor(devices=k)`` and ``serve
--devices k`` on a CPU mesh.

A mesh of the port is a tuple of devices driven by one process, so k
shards of the CPU run here one after another: every shard's code path
runs, the device copies between shards are no-ops.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_sliced_ell import powerlaw_graph

import repro.ppr as jppr
import repro.ppr.random_walk as jrw
import repro_torch.ppr as tppr
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.ppr import DeviceMesh, ShardedDeviceGraph
from repro_torch.ppr.fora import shard_lanes
from repro_torch.ppr.graph import Graph
from repro_torch.serving import QueryEngine

ROOT = Path(__file__).resolve().parents[1]
SOURCES = np.array([0, 7, 42])
QIDS = (11, 4, 29)              # the query ids of the pinned draws
SHARDS = (1, 2, 3, 4, 8)
W = 2048


def _mesh(k: int) -> DeviceMesh:
    return DeviceMesh(("cpu",) * k)


def _dense():
    return tppr.small_test_graph(n=200, avg_deg=8, seed=1)


def _sliced(n: int = 300, seed: int = 4) -> Graph:
    jg = powerlaw_graph(n, seed=seed)
    return Graph.from_edges(jg.n, jg.edge_src, jg.edge_dst, name=jg.name)


@pytest.fixture(scope="module")
def graphs():
    return {"dense": _dense(), "sliced": _sliced()}


# ---------------------------------------------------------------------------
# residency: upload-once per (graph, mesh), row blocks, the LRU


def test_sharded_residency_upload_once_and_row_blocks():
    g = tppr.small_test_graph(n=120, avg_deg=5, seed=2)
    mesh = _mesh(4)
    before = ShardedDeviceGraph.uploads
    sdg = g.device(mesh=mesh)
    assert ShardedDeviceGraph.uploads == before + 1
    assert g.device(mesh=_mesh(4)) is sdg          # equal mesh: cached
    assert ShardedDeviceGraph.uploads == before + 1
    assert sdg.layout == "dense" and sdg.num_shards == 4
    assert sdg.axis == "shard" and sdg.device == torch.device("cpu")
    for nbr, msk, w, plan in zip(sdg.in_neighbors, sdg.in_mask,
                                 sdg.in_weights, sdg.in_plan):
        assert nbr.shape == msk.shape == w.shape == (sdg.rows_per_shard,
                                                     sdg.ell_width)
        assert plan.extent.shape == (sdg.rows_per_shard,)
    assert sdg.rows_per_shard * 4 >= g.n > sdg.rows_per_shard * 3
    # the walk arrays once a distinct device, whole
    assert list(sdg.replicas) == [torch.device("cpu")]
    assert sdg.edge_dst.shape == (g.m,)
    assert sdg.out_offsets.shape == (g.n + 1,)
    whole = g.device("cpu")
    assert whole is not sdg
    # the shards hold the whole table, padded with empty rows
    assert torch.equal(torch.cat(sdg.in_neighbors)[:g.n], whole.in_neighbors)
    assert not torch.cat(sdg.in_mask)[g.n:].any()
    assert sdg.ell_nbytes == sum(t.numel() * t.element_size() for t in (
        *sdg.in_neighbors, *sdg.in_mask, *sdg.in_weights))
    # each row's plan is the whole table's, so a row sums in one order
    assert all(p.lanes == whole.in_plan.lanes for p in sdg.in_plan)
    assert torch.equal(torch.cat([p.extent for p in sdg.in_plan])[:g.n],
                       whole.in_plan.extent)
    shared = sdg.replicate(torch.arange(3))
    assert len(shared) == 4 and all(t is shared[0] for t in shared)


@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_sliced_shards_cut_by_virtual_row_and_fold_their_rows(k):
    g = _sliced()
    sl = g.ell_in_sliced()
    sdg = ShardedDeviceGraph.from_graph(g, _mesh(k))
    assert sdg.layout == "sliced" and sdg.num_shards == k
    assert int(sum(int(m.sum()) for m in sdg.in_mask)) == g.m
    rm_all = torch.cat(sdg.in_row_map)
    nv = sl.n_virtual
    assert torch.equal(rm_all[:nv], torch.from_numpy(sl.row_map))
    # padding rows: row_map n, no live cell
    assert (rm_all[nv:] == g.n).all()
    assert not torch.cat(sdg.in_mask)[nv:].any()
    split = 0
    for s, (rm, fold) in enumerate(zip(sdg.in_row_map, sdg.in_fold)):
        assert rm.shape == (sdg.rows_per_shard,)
        assert bool((rm[1:] >= rm[:-1]).all())           # ascending
        assert (fold.rows, fold.width) == (sdg.rows_per_shard, sdg.ell_width)
        # the block's fold covers exactly its rows' slices, padding unread
        count = torch.bincount(rm.long(), minlength=g.n + 1)[:g.n]
        assert torch.equal((fold.row_ptr[1:] - fold.row_ptr[:-1]).long(),
                           count)
        assert int(fold.row_ptr[-1]) == int((rm < g.n).sum())
        if s and int(rm[0]) == int(sdg.in_row_map[s - 1][-1]):
            split += 1                      # a row whose slices two share
    if k == 8:
        assert split > 0, "no row split between two shards"


def test_mesh_rejects_mixed_or_empty_devices():
    with pytest.raises(ValueError, match="all CUDA or all the CPU"):
        DeviceMesh(("cpu", "cuda:0"))
    with pytest.raises(ValueError, match="at least one"):
        DeviceMesh(())
    assert DeviceMesh(("cpu",) * 3).distinct == (torch.device("cpu"),)
    assert DeviceMesh(("cpu",) * 2) == _mesh(2)
    assert hash(DeviceMesh(("cpu",) * 2)) == hash(_mesh(2))


def test_sharded_residency_cache_is_bounded_lru():
    g = tppr.small_test_graph(n=80, avg_deg=4, seed=11)
    for k in (1, 2, 3, 4):
        g.device(mesh=_mesh(k))
    assert len(g._sharded_devices) == Graph.SHARDED_CACHE_MAX == 2
    before = ShardedDeviceGraph.uploads
    g.device(mesh=_mesh(4))                        # the most recent: a hit
    assert ShardedDeviceGraph.uploads == before
    # LRU, not FIFO: touching the older of the two keeps it resident
    g.device(mesh=_mesh(3))
    g.device(mesh=_mesh(1))                        # evicts 4, not 3
    before = ShardedDeviceGraph.uploads
    g.device(mesh=_mesh(3))
    assert ShardedDeviceGraph.uploads == before
    g.device(mesh=_mesh(4))
    assert ShardedDeviceGraph.uploads == before + 1


@pytest.mark.parametrize("layout", ["dense", "sliced"])
@pytest.mark.parametrize("k", SHARDS)
def test_shard_spmms_match_the_single_table(graphs, layout, k):
    g = graphs[layout]
    dg, sdg = g.device("cpu"), ShardedDeviceGraph.from_graph(g, _mesh(k))
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.random((3, g.n), dtype=np.float32))
    thr = torch.full((g.n,), 0.3)
    for t in (None, thr):
        if layout == "dense":
            want = ops.ell_spmm(dg.in_neighbors, dg.in_mask, dg.in_weights,
                                x, threshold=t)
            got = [ops.ell_spmm_shard(sdg.in_neighbors, sdg.in_mask,
                                      sdg.in_weights, x, threshold=t,
                                      plans=sdg.in_plan) for _ in range(2)]
        else:
            want = ops.ell_spmm_sliced(dg.in_neighbors, dg.in_mask,
                                       dg.in_weights, dg.in_row_map, x,
                                       threshold=t)
            got = [ops.ell_spmm_sliced_shard(
                sdg.in_neighbors, sdg.in_mask, sdg.in_weights,
                sdg.in_row_map, x, threshold=t, folds=sdg.in_fold)
                for _ in range(2)]
        assert got[0].shape == want.shape == (3, g.n)
        torch.testing.assert_close(got[0], want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))
        assert torch.equal(got[0], got[1])      # fixed combine order
        if k == 1:
            assert torch.equal(got[0], want)


# ---------------------------------------------------------------------------
# the shards against the JAX package's, from one forced-8-device process

_JAX_SHARDS = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.ppr import (ForaParams, ShardedDeviceGraph, fora_fused,
                       small_test_graph)
from test_sliced_ell import powerlaw_graph

assert len(jax.devices()) == 8
out = {}
for kind in ("dense", "sliced"):
    g = (small_test_graph(n=200, avg_deg=8, seed=1) if kind == "dense"
         else powerlaw_graph(300, seed=4))
    for k in (2, 3, 4, 8):
        sdg = ShardedDeviceGraph.from_graph(
            g, Mesh(np.array(jax.devices()[:k]), ("shard",)))
        key = f"{kind}_{k}"
        if k != 3:
            # the sharded query on the pinned draws of the fused tests
            res = fora_fused(sdg, np.array(SOURCES), ForaParams(epsilon=0.5),
                             jax.random.PRNGKey(5), num_walks=W,
                             query_seeds=np.array(QIDS, np.int32),
                             bulk_rng=True)
            for f in ("pi", "residual_mass", "push_iters",
                      "walks_effective", "walks_budget"):
                out[f"{key}_fora_{f}"] = np.asarray(getattr(res, f))
        out[key + "_meta"] = np.array([sdg.rows_per_shard, sdg.ell_width,
                                       sdg.num_shards])
        for f in ("in_neighbors", "in_mask", "in_weights", "in_row_map"):
            arr = getattr(sdg, f)
            if arr is None:
                continue
            shards = sorted(arr.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            for s, sh in enumerate(shards):
                out[f"{key}_{f}_{s}"] = np.asarray(sh.data)
        for f in ("edge_dst", "out_offsets", "out_degree"):
            out[f"{key}_{f}"] = np.asarray(
                getattr(sdg, f).addressable_shards[0].data)
np.savez(sys.argv[1], **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_shards") / "shards.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        + env.get("XLA_FLAGS", "")).strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    script = (f"SOURCES, QIDS, W = {SOURCES.tolist()}, {list(QIDS)}, {W}\n"
              + _JAX_SHARDS)
    proc = subprocess.run([sys.executable, "-c", script, str(path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("layout", ["dense", "sliced"])
@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_shards_equal_the_jax_shards(graphs, jax_shards, layout, k):
    """Every per-shard array equals the JAX residency's addressable shard,
    but for one convention: a padding row's ``row_map``, which the JAX
    package sets to the last real row (its segment stays ascending) and
    the port to n (past the fold's ``row_ptr[n]``, never read). Both
    leave the padding row without a live cell and weight 0."""
    g = graphs[layout]
    sdg = ShardedDeviceGraph.from_graph(g, _mesh(k))
    key = f"{layout}_{k}"
    rows, width, shards = jax_shards[key + "_meta"]
    assert (sdg.rows_per_shard, sdg.ell_width, sdg.num_shards) == (
        rows, width, shards)
    for f in ("edge_dst", "out_offsets", "out_degree"):
        np.testing.assert_array_equal(getattr(sdg, f).numpy(),
                                      jax_shards[f"{key}_{f}"])
    nv = g.ell_in_sliced().n_virtual if layout == "sliced" else g.n
    for s in range(k):
        for f in ("in_neighbors", "in_mask", "in_weights"):
            np.testing.assert_array_equal(getattr(sdg, f)[s].numpy(),
                                          jax_shards[f"{key}_{f}_{s}"])
        if layout == "dense":
            assert f"{key}_in_row_map_{s}" not in jax_shards
            continue
        got = sdg.in_row_map[s].numpy()
        want = jax_shards[f"{key}_in_row_map_{s}"]
        real = np.arange(s * rows, (s + 1) * rows) < nv
        np.testing.assert_array_equal(got[real], want[real])
        assert (got[~real] == g.n).all()
        if (~real).any():
            last = jax_shards[f"{key}_in_row_map_{k - 1}"]
            assert (want[~real] == last[-1]).all()
            assert not jax_shards[f"{key}_in_mask_{s}"][~real].any()


# ---------------------------------------------------------------------------
# sharded fused FORA against single-device fused FORA, on JAX's draws


def _jax_draws(key, qids, lanes: int, L: int) -> tppr.TableDraws:
    """The draws ``repro``'s fused query makes for each query id under a
    pinned bulk draw: fold_in(key, qid), split once into start and walk."""
    u, us = [], []
    for q in qids:
        k_start, k_walk = jax.random.split(jax.random.fold_in(key, int(q)))
        u.append(np.asarray(jax.random.uniform(k_start, (lanes,))))
        us.append(np.asarray(jax.random.randint(k_walk, (L, lanes), 0,
                                                1 << 30)))
    return tppr.TableDraws(torch.from_numpy(np.stack(u)),
                           torch.from_numpy(np.stack(us, axis=1)))


@pytest.fixture(scope="module")
def draws():
    params = jppr.ForaParams(epsilon=0.5)
    L = jrw.walk_length_for_tail(params.alpha, params.walk_tail)
    return _jax_draws(jax.random.PRNGKey(5), QIDS, W, L)


@pytest.mark.parametrize("layout", ["dense", "sliced"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_fora_matches_single_device(graphs, draws, layout, k):
    g = graphs[layout]
    params = tppr.ForaParams(epsilon=0.5)
    dg = g.device("cpu")
    sdg = g.device(mesh=_mesh(k))
    assert dg.layout == sdg.layout == layout
    want = tppr.fora_fused(dg, SOURCES, params, num_walks=W, draws=draws,
                           device="cpu")
    got, again = (tppr.fora_fused(sdg, SOURCES, params, num_walks=W,
                                  draws=draws, device="cpu")
                  for _ in range(2))
    assert got.walks_budget == want.walks_budget == W
    assert int(got.push_iters) == int(want.push_iters)
    torch.testing.assert_close(got.residual_mass, want.residual_mass,
                               rtol=1e-5, atol=0.0)
    assert torch.equal(got.walks_effective, want.walks_effective)
    assert torch.equal(got.walks_short, want.walks_short)
    torch.testing.assert_close(got.pi, want.pi, rtol=1e-4,
                               atol=1e-6 * float(want.pi.abs().max()))
    assert torch.equal(got.pi, again.pi)           # fixed combine orders
    if k == 1:
        for f in ("pi", "residual_mass", "push_iters", "walks_effective"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    np.testing.assert_allclose(got.pi.sum(dim=1).numpy(), 1.0, atol=1e-3)


@pytest.mark.parametrize("layout", ["dense", "sliced"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_sharded_fora_matches_the_jax_sharded_query(graphs, draws,
                                                    jax_shards, layout, k):
    """The port's sharded query against the JAX package's ``fora_fused``
    on its own ``ShardedDeviceGraph`` of k forced host devices, on the
    same draws: the split-hub sums, the combine orders and the lane
    windows held to the reference at the single-device tolerances."""
    g = graphs[layout]
    got = tppr.fora_fused(g.device(mesh=_mesh(k)), SOURCES,
                          tppr.ForaParams(epsilon=0.5), num_walks=W,
                          draws=draws, device="cpu")
    want = {f: jax_shards[f"{layout}_{k}_fora_{f}"] for f in (
        "pi", "residual_mass", "push_iters", "walks_effective",
        "walks_budget")}
    assert got.walks_budget == int(want["walks_budget"]) == W
    assert int(got.push_iters) == int(want["push_iters"])
    np.testing.assert_array_equal(got.walks_effective.numpy(),
                                  want["walks_effective"])
    np.testing.assert_allclose(got.residual_mass.numpy(),
                               want["residual_mass"], rtol=1e-5)
    np.testing.assert_allclose(got.pi.numpy(), want["pi"], rtol=1e-4,
                               atol=1e-6 * float(np.abs(want["pi"]).max()))


@pytest.mark.parametrize("layout", ["dense", "sliced"])
def test_sharded_fora_on_three_shards_meets_the_guarantee(graphs, layout):
    """k = 3 widens the lane count to a multiple of 3: another draw than
    one device's, still FORA's estimator within eps of power iteration."""
    g = graphs[layout]
    params = tppr.ForaParams(alpha=0.2, epsilon=0.5)
    got = tppr.fora_fused(g.device(mesh=_mesh(3)), SOURCES, params, seed=0,
                          num_walks=W, device="cpu")
    assert got.walks_budget % 3 == 0 and got.walks_budget >= W
    want = tppr.fora_fused(g.device("cpu"), SOURCES, params, seed=0,
                           num_walks=W, device="cpu")
    assert int(got.push_iters) == int(want.push_iters)
    torch.testing.assert_close(got.residual_mass, want.residual_mass,
                               rtol=1e-5, atol=0.0)
    pi = got.pi.numpy()
    np.testing.assert_allclose(pi.sum(axis=1), 1.0, atol=1e-3)
    exact = tppr.ppr_power_iteration(g, SOURCES, alpha=0.2, device="cpu")
    mask = exact >= 1.0 / g.n
    rel = np.abs(pi - exact)[mask] / exact[mask]
    assert rel.max() < 0.5, f"3-shard rel err {rel.max()}"


def test_residual_walk_windows_add_up_to_the_whole(graphs, draws):
    """``residual_walks(lanes=, lane_offset=)``: the windows of four
    shards, each on the global draws, sum to the single-device walks."""
    g = graphs["dense"]
    dg = g.device("cpu")
    push = tppr.forward_push_np(g, SOURCES, alpha=0.2, rmax=1e-3,
                                device="cpu")
    L = draws.steps.shape[0]
    act = torch.tensor([2000, 1, 700])
    args = (dg.edge_dst, dg.out_offsets, dg.out_degree, push.r, draws)
    kw = dict(alpha=0.2, num_walks=W, num_steps=L, active_walks=act)
    whole = tppr.residual_walks(*args, **kw)
    parts = [tppr.residual_walks(*args, lanes=W // 4, lane_offset=o, **kw)
             for o in range(0, W, W // 4)]
    torch.testing.assert_close(sum(parts), whole, rtol=1e-5,
                               atol=1e-6 * float(whole.abs().max()))
    # lanes at or past a row's active_walks carry no weight
    assert float(parts[-1][1].abs().max()) == 0.0
    assert torch.equal(tppr.residual_walks(*args, lanes=W, **kw), whole)


# ---------------------------------------------------------------------------
# host syncs: as many as the single-device query


def _count_syncs(monkeypatch, fn) -> list[str]:
    calls: list[str] = []
    for name in ("__bool__", "__int__", "__float__", "item", "tolist",
                 "numpy", "cpu"):
        original = getattr(torch.Tensor, name)

        def counting(self, *args, _name=name, _original=original, **kw):
            calls.append(_name)
            return _original(self, *args, **kw)

        monkeypatch.setattr(torch.Tensor, name, counting)
    try:
        fn()
    finally:
        monkeypatch.undo()
    return calls


@pytest.mark.parametrize("layout", ["dense", "sliced"])
def test_sharded_query_makes_the_single_device_host_syncs(graphs, draws,
                                                          layout,
                                                          monkeypatch):
    g = graphs[layout]
    params = tppr.ForaParams(epsilon=0.5)
    dg, sdg = g.device("cpu"), g.device(mesh=_mesh(4))
    run = [lambda d=d: tppr.fora_fused(d, SOURCES, params, num_walks=W,
                                       draws=draws, device="cpu")
           for d in (dg, sdg)]
    single = _count_syncs(monkeypatch, run[0])
    sharded = _count_syncs(monkeypatch, run[1])
    assert sharded == single
    iters = int(run[1]().push_iters)
    assert single.count("__bool__") == -(-iters // 8) + 1


# ---------------------------------------------------------------------------
# the executor: a slot as a mesh of k devices


def _workload(n_queries: int = 8):
    return tppr.PprWorkload(_dense(), num_queries=n_queries, seed=0)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_executor_devices_mode_runs_sharded(k):
    ex = tppr.ForaExecutor(_workload(), tppr.ForaParams(alpha=0.2,
                                                        epsilon=0.5),
                           block_size=2, devices=k, device="cpu")
    stats = ex(list(range(8)))
    assert stats.times.shape == (8,)
    assert (stats.times > 0).all() and np.isfinite(stats.times).all()
    assert isinstance(ex.device_graph, ShardedDeviceGraph)
    assert ex.device_graph.num_shards == k
    assert ex._num_walks is not None and ex._num_walks % k == 0
    # the budget it reports is the lane count its query runs
    assert ex._run_block([0, 3]).walks_budget == ex.current_walk_budget()
    ex.degrade(0.25)
    assert ex._num_walks % k == 0
    assert ex._run_block([1]).walks_budget == ex.current_walk_budget()
    rows = ex.answer_chunk([0, 5])
    np.testing.assert_allclose(rows.sum(axis=1), 1.0, atol=1e-3)
    assert ex.run_chunk([1, 2]).n == 2
    with pytest.raises(ValueError, match="single-device"):
        QueryEngine(ex, 2)
    one = tppr.ForaExecutor(_workload(), devices=1, device="cpu")
    one.warmup()
    assert isinstance(one.device_graph, tppr.DeviceGraph)


def test_executor_devices_over_capacity_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ex = tppr.ForaExecutor(_workload(4), devices=2, device="cuda:0")
    with pytest.raises(ValueError, match="devices=2 requested but only 1 "
                                         "present"):
        ex(list(range(2)))


def test_executor_mesh_starts_at_its_own_card(monkeypatch):
    """On CUDA a slot's mesh is ``devices`` cards from the executor's
    device on, so its first shard lies where the query is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    ex = tppr.ForaExecutor(_workload(4), devices=2, device="cuda:1")
    assert ex._build_mesh().devices == (torch.device("cuda", 1),
                                        torch.device("cuda", 2))
    assert tppr.ForaExecutor(_workload(4), devices=3,
                             device="cuda:0")._build_mesh().size == 3
    ex = tppr.ForaExecutor(_workload(4), devices=3, device="cuda:1")
    with pytest.raises(ValueError, match="devices=3 requested but only 2 "
                                         "present from cuda:1"):
        ex._build_mesh()


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8])
def test_shard_lanes_rounds_as_the_reference_and_keeps_its_counts(k):
    """A power-of-two request rounds as the JAX package rounds it (pow2,
    then up to a multiple of k), and a count so rounded is kept, so an
    executor's stored budget is the lane count its query runs."""
    for j in range(13):
        want = -(-(1 << j) // k) * k
        assert shard_lanes(1 << j, k) == want
        assert shard_lanes(want, k) == want
    for w in range(1, 300):
        lanes = shard_lanes(w, k)
        assert lanes >= w and lanes % k == 0
        assert shard_lanes(lanes, k) == lanes
    assert shard_lanes(2048) == 2048 and shard_lanes(1025) == 2048


def test_executor_devices_refusals_match_the_reference():
    wl = _workload(4)
    jwl = jppr.PprWorkload(jppr.small_test_graph(n=60, avg_deg=4, seed=0),
                           num_queries=4, seed=0)
    for kw, match in (({"devices": 0}, "devices must be >= 1"),
                      ({"fused": False, "devices": 2}, "requires the fused"),
                      ({"index_budget": 64, "devices": 2},
                       "single-device slot")):
        with pytest.raises(ValueError, match=match):
            tppr.ForaExecutor(wl, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jppr.ForaExecutor(jwl, **kw)
    with pytest.raises(ValueError, match="requires the fused hot path"):
        tppr.ForaExecutor(wl, fused=False, device="cpu")
    with pytest.raises(ValueError, match="single-device only"):
        tppr.fora_fused(_dense().device(mesh=_mesh(2)), [0], device="cpu",
                        index=object())


# ---------------------------------------------------------------------------
# serve --devices k


def test_serve_daemon_on_a_two_shard_cpu_mesh(monkeypatch, capsys):
    built = []
    make = tserve._fora_executor

    def recording(args, workload):
        ex = make(args, workload)
        built.append(ex)
        return ex

    monkeypatch.setattr(tserve, "_fora_executor", recording)
    capsys.readouterr()
    tserve.main(["--workload", "ppr", "--scale", "512", "--daemon",
                 "--num-jobs", "2", "--queries", "16", "--deadline", "20",
                 "--max-cores", "8", "--devices", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    summary = next(line for line in lines if "jobs=" in line)
    assert summary.strip().startswith("jobs=2 done=2 rejected=0"), summary
    assert len(built) == 2
    for ex in built:
        assert ex.devices == 2 and ex.calls > 0
        assert isinstance(ex.device_graph, ShardedDeviceGraph)
        assert ex.device_graph.num_shards == 2
        assert ex.device_graph.mesh == _mesh(2)

