"""Port parity of the FORA path on the CPU: forward push, walk starts and
endpoints, the fused query fed the JAX package's draws, the legacy query,
the power-iteration oracle and the executor; plus the FORA guarantee with
the port's own draws."""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sliced_ell import powerlaw_graph

import repro.ppr as jppr
import repro.ppr.random_walk as jrw
import repro_torch.ppr as tppr
import repro_torch.ppr.random_walk as trw
from repro_torch.ppr.graph import Graph

# the packages export a function of the same name as this module
jfp = importlib.import_module("repro.ppr.forward_push")
tfp = importlib.import_module("repro_torch.ppr.forward_push")

SOURCES = np.array([0, 7, 42])


@pytest.fixture(scope="module")
def graphs():
    jg = jppr.small_test_graph(n=200, avg_deg=8, seed=1)
    return jg, tppr.small_test_graph(n=200, avg_deg=8, seed=1)


@pytest.fixture(scope="module")
def powerlaw():
    jg = powerlaw_graph(300, seed=2)
    return jg, Graph.from_edges(jg.n, jg.edge_src, jg.edge_dst, name=jg.name)


@pytest.fixture(scope="module")
def exact(graphs):
    return jppr.ppr_power_iteration(graphs[0], SOURCES, alpha=0.2)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _seeds(n: int, sources) -> np.ndarray:
    seeds = np.zeros((len(sources), n), np.float32)
    seeds[np.arange(len(sources)), sources] = 1.0
    return seeds


def _push_both(jg, tg, max_iters=10_000):
    rp = jppr.ForaParams(epsilon=0.5).resolve(jg)
    jdg, tdg = jg.device(), tg.device("cpu")
    seeds = _seeds(jg.n, SOURCES)
    j = jfp.forward_push(jdg.in_neighbors, jdg.in_mask, jdg.in_weights,
                         jdg.out_degree, jnp.asarray(seeds), alpha=rp.alpha,
                         rmax=rp.rmax, n=jg.n, max_iters=max_iters,
                         row_map=jdg.in_row_map)
    t = tfp.forward_push(tdg.in_neighbors, tdg.in_mask, tdg.in_weights,
                         tdg.out_degree, torch.from_numpy(seeds),
                         alpha=rp.alpha, rmax=rp.rmax, max_iters=max_iters,
                         row_map=tdg.in_row_map)
    return rp, j, t


@pytest.mark.parametrize("which", ["dense", "sliced"])
@pytest.mark.parametrize("max_iters", [10_000, 5])
def test_forward_push_matches_jax(graphs, powerlaw, which, max_iters):
    jg, tg = graphs if which == "dense" else powerlaw
    assert tg.device("cpu").layout == which
    rp, j, t = _push_both(jg, tg, max_iters=max_iters)
    np.testing.assert_allclose(t.pi.numpy(), np.asarray(j.pi), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(t.r.numpy(), np.asarray(j.r), rtol=1e-5,
                               atol=1e-7)
    assert int(t.iters) == int(j.iters) <= max_iters
    if max_iters == 10_000:
        # FORA's invariant: residuals under threshold, mass conserved
        bound = rp.rmax * np.maximum(tg.out_degree, 1.0)
        assert (t.r.numpy() <= bound + 1e-6).all()
        total = t.pi.numpy().sum(axis=1) + t.r.numpy().sum(axis=1)
        np.testing.assert_allclose(total, 1.0, atol=1e-4)


def test_push_sync_cadence_and_resume_are_exact(powerlaw, monkeypatch):
    jg, tg = powerlaw
    dg = tg.device("cpu")
    rp = tppr.ForaParams().resolve(tg)
    seeds = torch.from_numpy(_seeds(tg.n, SOURCES))
    args = (dg.in_neighbors, dg.in_mask, dg.in_weights, dg.out_degree)
    kw = dict(alpha=rp.alpha, rmax=rp.rmax, row_map=dg.in_row_map)
    runs = []
    for k in (1, 3, 8):
        monkeypatch.setattr(tfp, "CHECK_EVERY", k)
        runs.append(tfp.forward_push(*args, seeds, **kw))
    for other in runs[1:]:
        assert torch.equal(other.pi, runs[0].pi)
        assert torch.equal(other.r, runs[0].r)
        assert int(other.iters) == int(runs[0].iters) > 3
    head = tfp.forward_push(*args, seeds, max_iters=3, **kw)
    tail = tfp.forward_push(*args, head.r, pi0=head.pi, **kw)
    assert torch.equal(tail.pi, runs[0].pi) and torch.equal(tail.r, runs[0].r)
    assert int(head.iters) + int(tail.iters) == int(runs[0].iters)


def test_walk_starts_and_endpoints_match_jax(graphs):
    jg, tg = graphs
    _, j, _ = _push_both(jg, tg)
    residual = np.asarray(j.r)
    key = jax.random.PRNGKey(3)
    W, L = 512, 20
    for b in range(len(SOURCES)):
        k = jax.random.fold_in(key, b)
        jstarts, jr_sum = jrw.sample_walk_starts(jnp.asarray(residual[b]), k,
                                                 num_walks=W, n=jg.n)
        u = np.asarray(jax.random.uniform(jax.random.split(k)[0], (W,)))
        jcsum = np.asarray(jnp.cumsum(jnp.asarray(residual[b])))
        tstarts = trw.starts_from_cdf(torch.tensor(jcsum),
                                      torch.tensor(u),
                                      torch.tensor(float(jr_sum)), jg.n)
        np.testing.assert_array_equal(tstarts.numpy(), np.asarray(jstarts))
        np.testing.assert_allclose(
            torch.cumsum(torch.tensor(residual[b]), 0).numpy(), jcsum,
            rtol=1e-6, atol=1e-7)
    starts = np.stack([np.asarray(jrw.sample_walk_starts(
        jnp.asarray(residual[b]), key, num_walks=W, n=jg.n)[0])
        for b in range(len(SOURCES))])
    us = jrw.lane_streams(key, jnp.arange(W, dtype=jnp.int32), L)
    jend = jrw.walk_endpoints(jnp.asarray(jg.edge_dst),
                              jnp.asarray(jg.out_offsets),
                              jnp.asarray(jg.out_degree), jnp.asarray(starts),
                              us, alpha=0.2)
    dg = tg.device("cpu")
    tend = trw.walk_endpoints(dg.edge_dst, dg.out_offsets, dg.out_degree,
                              torch.from_numpy(starts),
                              torch.tensor(np.asarray(us)), alpha=0.2)
    np.testing.assert_array_equal(tend.numpy(), np.asarray(jend))


def _jax_draws(key, qids, W: int, L: int) -> trw.TableDraws:
    """The draws ``repro``'s fused query makes for each query id under a
    pinned bulk draw: fold_in(key, qid), split once into start and walk."""
    u, us = [], []
    for q in qids:
        k_start, k_walk = jax.random.split(jax.random.fold_in(key, int(q)))
        u.append(np.asarray(jax.random.uniform(k_start, (W,))))
        us.append(np.asarray(jax.random.randint(k_walk, (L, W), 0, 1 << 30)))
    return trw.TableDraws(torch.from_numpy(np.stack(u)),
                          torch.from_numpy(np.stack(us, axis=1)))


@pytest.mark.parametrize("which", ["dense", "sliced"])
def test_fora_fused_matches_jax_on_its_draws(graphs, powerlaw, which):
    jg, tg = graphs if which == "dense" else powerlaw
    params = jppr.ForaParams(epsilon=0.5)
    W = 2048
    key = jax.random.PRNGKey(5)
    qids = np.array([11, 4, 29], np.int32)
    j = jppr.fora_fused(jg.device(), SOURCES, params, key, num_walks=W,
                        query_seeds=qids, bulk_rng=True)
    L = jrw.walk_length_for_tail(params.alpha, params.walk_tail)
    t = tppr.fora_fused(tg.device("cpu"), SOURCES,
                        tppr.ForaParams(epsilon=0.5), num_walks=W,
                        draws=_jax_draws(key, qids, W, L), device="cpu")
    assert t.walks_budget == j.walks_budget == W
    assert int(t.push_iters) == int(j.push_iters)
    np.testing.assert_array_equal(t.walks_effective.numpy(),
                                  np.asarray(j.walks_effective))
    np.testing.assert_allclose(t.residual_mass.numpy(),
                               np.asarray(j.residual_mass), rtol=1e-5)
    np.testing.assert_allclose(t.pi.numpy(), np.asarray(j.pi), rtol=1e-4,
                               atol=1e-6)


def test_fora_fused_on_carried_jax_arrays_matches_jax(powerlaw):
    """A residency carried across from the JAX package's DeviceGraph arrays
    (its sliced table, the fold built from its row_map) answers FORA as the
    port's own residency does, bit for bit, and as the JAX package does."""
    jg, tg = powerlaw
    jdg = jg.device()
    arrays = {f: np.asarray(getattr(jdg, f))
              for f in tppr.DeviceGraph.ARRAY_FIELDS
              if getattr(jdg, f) is not None}
    carried = tppr.DeviceGraph.from_arrays(arrays, device="cpu")
    assert carried.layout == "sliced" and carried.in_fold is not None
    params = jppr.ForaParams(epsilon=0.5)
    W = 2048
    key = jax.random.PRNGKey(7)
    qids = np.array([3, 8, 21], np.int32)
    j = jppr.fora_fused(jdg, SOURCES, params, key, num_walks=W,
                        query_seeds=qids, bulk_rng=True)
    L = jrw.walk_length_for_tail(params.alpha, params.walk_tail)
    draws = _jax_draws(key, qids, W, L)
    got = [tppr.fora_fused(dg, SOURCES, tppr.ForaParams(epsilon=0.5),
                           num_walks=W, draws=draws, device="cpu")
           for dg in (carried, tg.device("cpu"))]
    assert torch.equal(got[0].pi, got[1].pi)
    assert int(got[0].push_iters) == int(j.push_iters)
    np.testing.assert_allclose(got[0].pi.numpy(), np.asarray(j.pi),
                               rtol=1e-4, atol=1e-6)


def test_residual_walks_match_jax_with_active_walks(graphs):
    jg, tg = graphs
    _, j, _ = _push_both(jg, tg)
    W, L = 1024, 42
    key = jax.random.PRNGKey(9)
    act = np.array([1000, 1, 256], np.int32)
    jm = np.stack([np.asarray(jrw.residual_walks(
        jnp.asarray(jg.edge_dst), jnp.asarray(jg.out_offsets),
        jnp.asarray(jg.out_degree), j.r[b], jax.random.fold_in(key, b),
        alpha=0.2, n=jg.n, num_walks=W, num_steps=L,
        active_walks=jnp.int32(act[b]), bulk_rng=True)) for b in range(3)])
    dg = tg.device("cpu")
    tm = trw.residual_walks(dg.edge_dst, dg.out_offsets, dg.out_degree,
                            torch.tensor(np.asarray(j.r)),
                            _jax_draws(key, range(3), W, L), alpha=0.2,
                            num_walks=W, num_steps=L,
                            active_walks=torch.from_numpy(act))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-5, atol=1e-7)


def test_fora_meets_guarantee(graphs, exact):
    """|pi_hat - pi| <= eps*pi for pi >= delta with the port's own draws."""
    res = tppr.fora(graphs[1], SOURCES, tppr.ForaParams(alpha=0.2,
                                                        epsilon=0.5),
                    seed=0, device="cpu")
    mask = exact >= 1.0 / graphs[1].n
    rel = np.abs(res.pi - exact)[mask] / exact[mask]
    assert rel.max() < 0.5, f"rel err {rel.max()} exceeds eps"
    assert np.allclose(res.pi.sum(axis=1), 1.0, atol=1e-3)


def test_fora_fused_matches_fora(graphs, exact):
    tg = graphs[1]
    params = tppr.ForaParams(alpha=0.2, epsilon=0.5)
    res = tppr.fora(tg, SOURCES, params, seed=0, device="cpu")
    fres = tppr.fora_fused(tg.device("cpu"), SOURCES, params, seed=0,
                           device="cpu")
    np.testing.assert_allclose(fres.residual_mass.numpy(), res.residual_mass,
                               rtol=1e-5)
    assert int(fres.push_iters) == res.push_iters
    pi = fres.pi.numpy()
    mask = exact >= 1.0 / tg.n
    rel = np.abs(pi - exact)[mask] / exact[mask]
    assert rel.max() < 0.5, f"fused rel err {rel.max()} exceeds eps"
    assert np.allclose(pi.sum(axis=1), 1.0, atol=1e-3)
    assert int(fres.walks_effective.max()) == res.walks_used


@pytest.mark.parametrize("num_walks", [None, 64])
def test_walks_short_marks_rows_the_lane_count_cut(graphs, num_walks):
    tg = graphs[1]
    params = tppr.ForaParams(alpha=0.2, epsilon=0.5)
    fres = tppr.fora_fused(tg.device("cpu"), SOURCES, params, seed=0,
                           num_walks=num_walks, device="cpu")
    need = np.ceil(fres.residual_mass.numpy() * params.resolve(tg).omega)
    want = need > fres.walks_effective.numpy()
    np.testing.assert_array_equal(fres.walks_short.numpy(), want)
    # the default lane count covers every row here; 64 lanes cover none
    assert want.all() == (num_walks == 64) and want.any() == want.all()
    # the legacy query's cap is max_walks
    capped = tppr.ForaParams(alpha=0.2, epsilon=0.5,
                             max_walks=num_walks or 1 << 22)
    legacy = tppr.fora(tg, SOURCES, capped, seed=0, device="cpu")
    np.testing.assert_array_equal(legacy.walks_short, want)


def test_query_answer_does_not_depend_on_its_batch(powerlaw):
    tg = powerlaw[1]
    dg = tg.device("cpu")
    params = tppr.ForaParams(epsilon=0.5)
    alone = tppr.fora_fused(dg, [42], params, seed=3, num_walks=1024,
                            query_ids=[7], device="cpu")
    batch = tppr.fora_fused(dg, [5, 42, 9], params, seed=3, num_walks=1024,
                            query_ids=[2, 7, 1], device="cpu")
    np.testing.assert_allclose(batch.pi[1].numpy(), alone.pi[0].numpy(),
                               rtol=1e-6, atol=1e-8)
    assert int(batch.walks_effective[1]) == int(alone.walks_effective[0])


def test_power_iteration_matches_jax(graphs, exact):
    got = tppr.ppr_power_iteration(graphs[1], SOURCES, alpha=0.2,
                                   device="cpu")
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-7)


def test_executor_calibration_and_calls(graphs):
    jg, tg = graphs
    jw = jppr.PprWorkload(graph=jg, num_queries=24, seed=4)
    tw = tppr.PprWorkload(graph=tg, num_queries=24, seed=4)
    np.testing.assert_array_equal(tw.sources, jw.sources)
    jex = jppr.ForaExecutor(workload=jw, params=jppr.ForaParams(epsilon=0.5))
    tex = tppr.ForaExecutor(workload=tw, params=tppr.ForaParams(epsilon=0.5),
                            block_size=2, device="cpu")
    assert tex._calibration_qids() == jex._calibration_qids()
    assert tex._calibrate_walk_budget() == jex._calibrate_walk_budget()
    stats = tex(list(range(5)))
    assert stats.n == 5 and (stats.times > 0).all()
    assert stats.times[0] == stats.times[1]        # one block of two
    assert tex.calls == 3
    assert tex.run_chunk([3, 4, 5]).n == 3
    budget = tex.current_walk_budget()
    tex.degrade(0.5)
    assert tex.params.epsilon == 1.0 and tex.current_walk_budget() == budget // 2
    with pytest.raises(IndexError):
        tex([24])
    with pytest.raises(ValueError):
        tex.degrade(1.5)


def test_entry_points_default_to_cuda_and_raise_without_it(graphs, no_cuda):
    tg = graphs[1]
    dg = tg.device("cpu")
    for call in (lambda: tppr.fora_fused(dg, [0]),
                 lambda: tppr.fora(tg, [0]),
                 lambda: tppr.ppr_power_iteration(tg, [0]),
                 lambda: tfp.forward_push_np(tg, [0], alpha=0.2, rmax=1e-3),
                 lambda: tppr.ForaExecutor(tppr.PprWorkload(tg, 4))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_draw_shapes_and_query_ids_are_checked(graphs):
    dg = graphs[1].device("cpu")
    with pytest.raises(ValueError, match="starts"):
        trw.TableDraws(torch.zeros(2, 4),
                       torch.zeros(3, 2, 5, dtype=torch.int32))
    with pytest.raises(ValueError, match="query ids"):
        tppr.fora_fused(dg, [0, 1], query_ids=[3], device="cpu")
    L = trw.walk_length_for_tail(0.2)
    short = trw.TableDraws(torch.rand(1, 4), torch.zeros(L, 1, 4,
                                                         dtype=torch.int32))
    with pytest.raises(ValueError, match="draws give"):
        tppr.fora_fused(dg, [0], num_walks=8, draws=short, device="cpu")
