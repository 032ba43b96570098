"""The port's continuous-batching engine on the CPU: its rows have the bits
of the port's chunked ``answer_chunk`` rows at every lane count, sweep
count, layout and interleaving, and agree with the JAX package's chunked
answers on its draws; the lane pool's mechanics, its refusals, a step's
host syncs, the walk budget it adopts and feeds back, and the
virtual-time ``SimLaneEngine`` twin."""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:          # optional dev dep (requirements-dev.txt)
    from _hypothesis_fallback import given, settings, st

import repro.ppr as jppr
import repro.ppr.random_walk as jrw
import repro.serving as jserving
import repro_torch.ppr as tppr
from repro_torch.serving import (HarvestedQuery, QueryEngine, SimLaneEngine)

# the package exports a function of the same name as this module
tfp = importlib.import_module("repro_torch.ppr.forward_push")

NUM_QUERIES = 12
PARAMS = dict(epsilon=0.5)

# hypothesis examples may not take function-scoped fixtures: the executors
# and their chunked answers are built once and shared
_STATE: dict = {}


def _graph(layout: str):
    return (tppr.small_test_graph(n=300, seed=2) if layout == "dense"
            else tppr.load("web-stanford", scale=256))


def _setup(layout: str):
    if layout not in _STATE:
        g = _graph(layout)
        ex = tppr.ForaExecutor(tppr.PprWorkload(g, NUM_QUERIES, seed=3),
                               params=tppr.ForaParams(**PARAMS),
                               device="cpu")
        ref = ex.answer_chunk(list(range(NUM_QUERIES)))
        assert ex.device_graph.layout == layout
        _STATE[layout] = (ex, ref)
    return _STATE[layout]


def _drain(eng: QueryEngine, qids) -> dict[int, HarvestedQuery]:
    pending = list(qids)
    got = {}
    while pending or eng.busy:
        while pending and eng.free:
            eng.insert(pending.pop(0))
        eng.step()
        for h in eng.harvest():
            got[h.qid] = h
    return got


@pytest.mark.parametrize("layout", ["dense", "sliced"])
@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("sweeps", [1, 4])
def test_engine_rows_bit_identical_to_answer_chunk(layout, lanes, sweeps):
    ex, ref = _setup(layout)
    eng = QueryEngine(ex, lanes, sweeps=sweeps)
    got = _drain(eng, range(NUM_QUERIES))
    assert sorted(got) == list(range(NUM_QUERIES))
    res = tppr.fora_fused(ex.device_graph, ex.workload.sources, ex.params,
                          ex.workload.seed,
                          num_walks=ex.current_walk_budget(),
                          query_ids=list(range(NUM_QUERIES)), device="cpu")
    for qid, h in got.items():
        assert np.array_equal(h.pi, ref[qid]), f"query {qid} bits diverged"
        assert 0 <= h.lane < lanes
        assert h.walks_effective == int(res.walks_effective[qid])
        assert h.residual_mass == float(res.residual_mass[qid])
        assert h.walks_short == bool(res.walks_short[qid])
    assert eng.inserted == eng.harvested == NUM_QUERIES
    assert (eng.busy, eng.free) == (0, lanes)


def _run_interleaved(ex, lanes, rng, sweeps):
    """insert/step/harvest in a seeded random order until every query is
    harvested; returns {qid: row}."""
    eng = QueryEngine(ex, lanes, sweeps=sweeps)
    pending = list(range(NUM_QUERIES))
    got = {}
    for _ in range(10_000):
        if len(got) == NUM_QUERIES:
            return got
        choices = ["step", "harvest"]
        if pending and eng.free:
            choices.append("insert")
        act = choices[int(rng.integers(len(choices)))]
        if act == "insert":
            eng.insert(pending.pop(0))
        elif act == "step":
            eng.step()
        else:
            for h in eng.harvest():
                got[h.qid] = h.pi
    raise AssertionError("interleaved engine failed to drain")


@pytest.mark.parametrize("layout", ["dense", "sliced"])
@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_engine_any_interleaving_matches_answer_chunk(layout, seed):
    """A query's row does not depend on its lane, its neighbours in the
    pool, or when it was inserted, stepped or harvested."""
    ex, ref = _setup(layout)
    rng = np.random.default_rng(seed)
    lanes = int(rng.integers(1, 6))
    sweeps = int(rng.integers(1, 5))
    got = _run_interleaved(ex, lanes, rng, sweeps)
    assert sorted(got) == list(range(NUM_QUERIES))
    for qid, pi in got.items():
        assert np.array_equal(pi, ref[qid]), \
            f"query {qid} diverged (lanes={lanes}, seed={seed})"


@pytest.mark.parametrize("layout,rtol", [("dense", 1e-5), ("sliced", 1e-4)])
def test_engine_matches_jax_answer_chunk_on_its_draws(layout, rtol):
    g = _graph(layout)
    jg = (jppr.small_test_graph(n=300, seed=2) if layout == "dense"
          else jppr.load("web-stanford", scale=256))
    jex = jppr.ForaExecutor(jppr.PprWorkload(jg, NUM_QUERIES, seed=3),
                            jppr.ForaParams(**PARAMS), fused=True)
    want = jex.answer_chunk(list(range(NUM_QUERIES)))
    W = jex.current_walk_budget()
    assert jex._bulk_rng          # one (L, W) draw a query
    L = jrw.walk_length_for_tail(0.2, 1e-4)
    key = jax.random.PRNGKey(3)

    def draws_of(qid: int) -> tppr.TableDraws:
        k_start, k_walk = jax.random.split(jax.random.fold_in(key, qid))
        u = np.array(jax.random.uniform(k_start, (W,)))[None]
        us = np.array(jax.random.randint(k_walk, (L, W), 0, 1 << 30))
        return tppr.TableDraws(torch.from_numpy(u),
                               torch.from_numpy(us[:, None]))

    ex = tppr.ForaExecutor(tppr.PprWorkload(g, NUM_QUERIES, seed=3),
                           params=tppr.ForaParams(**PARAMS), device="cpu")
    ex.warmup()
    assert ex.current_walk_budget() == W
    eng = QueryEngine(ex, 3, draws_of=draws_of)
    got = _drain(eng, range(NUM_QUERIES))
    # the two pushes' residuals differ in their last bits (rtol 1e-5), so
    # their cumulative sums can put a walk start on either side of a CDF
    # boundary: such a walker moves its weight r_sum / w_eff between two
    # entries. Rows whose starts all agree are held to rtol; the others
    # must differ by exactly their moved walkers' weight
    rp = jppr.ForaParams(**PARAMS).resolve(jg)
    jpush = jppr.forward_push_np(jg, jex.workload.sources, alpha=rp.alpha,
                                 rmax=rp.rmax)
    tpush = tppr.forward_push_np(g, ex.workload.sources, alpha=rp.alpha,
                                 rmax=rp.rmax, device="cpu")
    atol = 1e-6 * float(np.abs(want).max())
    clean = 0
    for qid in range(NUM_QUERIES):
        theirs, _ = jrw.sample_walk_starts(
            jax.numpy.asarray(jpush.r[qid]), jax.random.fold_in(key, qid),
            num_walks=W, n=jg.n)
        mine, _ = tppr.sample_walk_starts(tpush.r[qid:qid + 1],
                                          draws_of(qid).start_uniforms())
        moved = int((mine[0].numpy() != np.asarray(theirs)).sum())
        if moved == 0:
            clean += 1
            np.testing.assert_allclose(got[qid].pi, want[qid], rtol=rtol,
                                       atol=atol)
            continue
        weight = got[qid].residual_mass / got[qid].walks_effective
        diff = np.abs(got[qid].pi - want[qid])
        over = diff > rtol * np.abs(want[qid]) + atol
        assert moved <= 2 and int(over.sum()) <= 2 * moved
        slack = rtol * np.abs(want[qid][over]) + atol
        assert (diff[over] <= moved * weight * (1 + rtol) + slack).all()
    assert clean >= NUM_QUERIES - 2


def test_engine_lane_pool_mechanics():
    ex, ref = _setup("dense")
    eng = QueryEngine(ex, lanes=3)
    assert (eng.busy, eng.free) == (0, 3)
    assert eng.insert(0) == 0                   # lowest free lane first
    assert eng.insert(1) == 1
    assert eng.insert(2, lane=2) == 2           # explicit pin
    assert (eng.busy, eng.free) == (3, 0)
    assert eng.occupants() == {0: 0, 1: 1, 2: 2}
    with pytest.raises(RuntimeError, match="no free lane"):
        eng.insert(3)
    out = eng.run_to_completion()
    assert (eng.busy, eng.free) == (0, 3)
    assert {h.lane for h in out} == {0, 1, 2}
    with pytest.raises(RuntimeError, match="occupied"):
        eng.insert(4, lane=1)
        eng.insert(5, lane=1)
    with pytest.raises(IndexError):
        eng.insert(NUM_QUERIES)                 # no such query: no lane taken
    assert eng.free == 2
    # the evicted lane is reusable and still bit-exact after re-insertion
    eng.run_to_completion()
    lane = eng.insert(6, lane=1)
    (h,) = eng.run_to_completion()
    assert (lane, h.qid) == (1, 6)
    assert np.array_equal(h.pi, ref[6])
    assert eng.harvest() == []


def test_engine_rejects_unsupported_executors():
    ex, _ = _setup("dense")
    with pytest.raises(ValueError, match="lane pool"):
        QueryEngine(ex, lanes=0)
    with pytest.raises(ValueError, match="sweeps"):
        QueryEngine(ex, lanes=2, sweeps=0)
    workload = ex.workload
    indexed = tppr.ForaExecutor(workload, tppr.ForaParams(**PARAMS),
                                index_budget=4, device="cpu")
    with pytest.raises(ValueError, match="bypass"):
        QueryEngine(indexed, lanes=2)
    from repro_torch.index import WalkIndex
    idx = WalkIndex.build(ex.device_graph, width=4, alpha=0.2, seed=1)
    served = tppr.ForaExecutor(workload, tppr.ForaParams(**PARAMS),
                               walk_index=idx, device="cpu")
    with pytest.raises(ValueError, match="bypass"):
        QueryEngine(served, lanes=2)


@pytest.mark.parametrize("sweeps", [1, 4, 16])
def test_engine_step_host_syncs(sweeps, monkeypatch):
    """A step that pushes syncs with the host at forward_push's convergence
    test (once every CHECK_EVERY sweeps) and at one readback of the lanes
    that walk now; a step with no lane to push makes none."""
    ex, ref = _setup("sliced")
    eng = QueryEngine(ex, 4, sweeps=sweeps)
    for qid in range(4):
        eng.insert(qid)
    calls = []
    for name in ("__bool__", "__int__", "__float__", "item", "tolist",
                 "numpy", "cpu"):
        original = getattr(torch.Tensor, name)

        def counting(self, *args, _name=name, _original=original, **kw):
            calls.append(_name)
            return _original(self, *args, **kw)

        monkeypatch.setattr(torch.Tensor, name, counting)
    eng.step()
    want = -(-sweeps // tfp.CHECK_EVERY) + 1
    assert sorted(calls) == sorted(["__bool__"] * (want - 1) + ["tolist"])
    monkeypatch.undo()
    got = {h.qid: h.pi for h in eng.run_to_completion()}
    assert all(np.array_equal(got[q], ref[q]) for q in range(4))
    idle = QueryEngine(ex, 2)
    calls.clear()
    for name in ("__bool__", "tolist"):
        original = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _n=name, _o=original, **k:
            calls.append(_n) or _o(self, *a, **k))
    idle.step()
    assert calls == [] and idle.steps == 1


def test_engine_adopts_and_feeds_the_walk_budget():
    g = _graph("dense")
    ex = tppr.ForaExecutor(tppr.PprWorkload(g, NUM_QUERIES, seed=3),
                           params=tppr.ForaParams(**PARAMS),
                           adaptive_budget=True, device="cpu")
    eng = QueryEngine(ex, 2)
    ex._num_walks = 4                  # a budget that cuts every row
    eng.insert(0)
    ex._num_walks = 1 << 15
    eng.insert(1)
    out = {h.qid: h for h in eng.run_to_completion()}
    assert out[0].walks_effective <= 4 and out[0].walks_short
    assert out[1].walks_effective > 4 and not out[1].walks_short
    assert ex._obs_rmax == max(h.residual_mass for h in out.values())
    res = tppr.fora_fused(ex.device_graph, ex.workload.sources[[0]],
                          ex.params, ex.workload.seed, num_walks=4,
                          query_ids=[0], device="cpu")
    assert np.array_equal(out[0].pi, res.pi[0].numpy())
    assert bool(res.walks_short[0])


def test_sim_lane_engine_edf_and_occupancy():
    sims = (SimLaneEngine(lanes=2), jserving.SimLaneEngine(lanes=2))
    for sim in sims:
        sim.enqueue(deadline=9.0, job_id=1, qid=0, duration=0.5)
        sim.enqueue(deadline=4.0, job_id=2, qid=1, duration=0.5)
        sim.enqueue(deadline=6.0, job_id=1, qid=2, duration=0.5)
        assert sim.pending() == 3 and sim.pending_of(1) == 2
        assert sim.pop_ready()[1:3] == (2, 1)   # earliest deadline first
        assert sim.pop_ready()[1:3] == (1, 2)
        lane = sim.free_lane(cap=2)
        assert lane == 0
        sim.occupy(lane, qid=1, job_id=2, now=0.0, t_end=0.5, work=0.5)
        assert sim.busy == 1 and sim.free_lane(cap=1) is None
        # a lane flipping jobs is a rebalance
        task = sim.release(0)
        assert (task.qid, task.job_id) == (1, 2)
        assert sim.occupy(0, qid=2, job_id=1, now=0.5, t_end=1.0, work=0.5)
        sim.resize(0)
        assert sim.lanes == 1
    port, ref = sims
    assert port.state_dict() == ref.state_dict()
    rt = SimLaneEngine.from_state(ref.state_dict())
    assert rt.state_dict() == port.state_dict()
    assert rt.busy == port.busy and rt.pending() == port.pending()
    with pytest.raises(ValueError):
        SimLaneEngine(0)
    with pytest.raises(RuntimeError, match="occupied"):
        rt.occupy(0, qid=5, job_id=1, now=1.0, t_end=2.0, work=1.0)
