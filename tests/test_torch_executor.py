"""Port parity of the executor parts a continuous-batching engine calls:
``answer_chunk`` (a query's row does not depend on its chunk), ``run_chunk``
(one chunk, one device call) and the adaptive walk budget, whose EWMA and
lane count are the host numbers the JAX package computes for the same
observations."""

from __future__ import annotations

import numpy as np
import pytest

import repro.ppr as jppr
import repro_torch.ppr as tppr

PARAMS = dict(epsilon=0.5)


@pytest.fixture(scope="module")
def graphs():
    return {"dense": tppr.small_test_graph(n=300, seed=2),
            "sliced": tppr.load("web-stanford", scale=256)}


def _executor(graph, **kw):
    return tppr.ForaExecutor(tppr.PprWorkload(graph, 20, seed=3),
                             params=tppr.ForaParams(**PARAMS), device="cpu",
                             **kw)


@pytest.mark.parametrize("layout", ["dense", "sliced"])
def test_answer_chunk_rows_do_not_depend_on_the_chunk(graphs, layout):
    g = graphs[layout]
    assert g.device("cpu").layout == layout
    ex = _executor(g)
    both = ex.answer_chunk([4, 11])
    assert both.shape == (2, g.n) and both.dtype == np.float32
    assert np.array_equal(both[0], ex.answer_chunk([4])[0])
    assert np.array_equal(both[1], ex.answer_chunk([11])[0])
    # a repeated query is the same row; the rows are PPR rows
    again = ex.answer_chunk([11, 2, 11])
    assert np.array_equal(again[0], again[2])
    assert np.array_equal(again[0], both[1])
    np.testing.assert_allclose(both.sum(axis=1), 1.0, atol=1e-3)
    with pytest.raises(ValueError):
        ex.answer_chunk([])


def test_run_chunk_returns_the_chunks_stats(graphs):
    ex = _executor(graphs["dense"])
    stats = ex.run_chunk([3, 4, 5])
    assert stats.n == 3 and (stats.times > 0).all()
    assert len(set(stats.times.tolist())) == 1       # one block, shared
    assert ex.calls == 1
    assert ex.run_chunk([7], seed=11).n == 1 and ex.calls == 2
    with pytest.raises(ValueError):
        ex.run_chunk([])
    # the seed is the base of the per-query walk streams
    dg = graphs["dense"].device("cpu")
    src = ex.workload.sources[[7]]
    a = tppr.fora_fused(dg, src, ex.params, 11, num_walks=1024,
                        query_ids=[7], device="cpu").pi
    b = tppr.fora_fused(dg, src, ex.params, 12, num_walks=1024,
                        query_ids=[7], device="cpu").pi
    assert not np.array_equal(a.numpy(), b.numpy())


R_MAX = [0.93, 0.41, 0.05, 0.6, 0.6, 0.002, 1.0, 0.33]


@pytest.mark.parametrize("ewma", [0.5, 0.2, 1.0])
def test_adaptive_budget_matches_jax(graphs, ewma):
    tg = graphs["sliced"]
    jg = jppr.load("web-stanford", scale=256)
    jex = jppr.ForaExecutor(jppr.PprWorkload(jg, 20, seed=3),
                            params=jppr.ForaParams(**PARAMS),
                            adaptive_budget=True, budget_ewma=ewma)
    tex = _executor(tg, adaptive_budget=True, budget_ewma=ewma)
    start = tex._calibrate_walk_budget()
    jex._num_walks = tex._num_walks = start
    for r in R_MAX:
        jex.observe_residual_mass(r)
        tex.observe_residual_mass(r)
        assert tex._obs_rmax == jex._obs_rmax
        jex._recalibrate_block()
        tex._recalibrate_block()
        assert tex.current_walk_budget() == jex.current_walk_budget()
        assert isinstance(tex.current_walk_budget(), int)


def test_adaptive_budget_is_opt_in_and_observes_each_chunk(graphs):
    ex = _executor(graphs["dense"])
    ex.run_chunk([0, 1])
    budget = ex.current_walk_budget()
    ex.observe_residual_mass(1e-6)
    ex.run_chunk([2])
    assert ex.current_walk_budget() == budget        # off: never moves
    ad = _executor(graphs["dense"], adaptive_budget=True)
    ad.run_chunk([0, 1])
    first = ad._obs_rmax
    res = tppr.fora_fused(ad.device_graph, ad.workload.sources[[0, 1]],
                          ad.params, 3, num_walks=budget, query_ids=[0, 1],
                          device="cpu")
    assert first == float(res.residual_mass.max())
    ad.run_chunk([5])
    rp = ad.params.resolve(ad.workload.graph)
    need = max(1, int(np.ceil(first * rp.omega)))
    want = min(1 << (need - 1).bit_length(), tppr.default_walk_budget(rp))
    assert ad.current_walk_budget() == want
