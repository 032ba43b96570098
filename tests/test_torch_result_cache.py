"""Port parity: the result cache (``repro_torch.index.ResultCache``) and
cache-aware admission, mirroring ``tests/test_index_cache.py`` on the
port, with each seeded scenario also driven through the JAX package's
runtime and held equal to it."""

from __future__ import annotations

import json

import numpy as np
import pytest
from _serving_pair import JAX, PACKAGES, TORCH, outcome, sim_factory

from repro_torch.core import CacheAwareCostModel, DeviceAllocator, RuntimeStats
from repro_torch.index import ResultCache
from repro_torch.serving import (CorePool, JobState, ServingConfig,
                                 ServingRuntime, SimJobExecutor)


def _factory(mean=0.05, cv=0.3):
    return lambda job_id, nq, sd: SimJobExecutor(mean=mean, cv=cv, seed=sd)


# ---------------------------------------------------------------------------
# ResultCache unit behaviour


def test_cache_lru_eviction_order():
    cache = ResultCache(capacity=2)
    cache.put(("a",), cost=1.0)
    cache.put(("b",), cost=2.0)
    assert cache.get(("a",)) is not None
    cache.put(("c",), cost=3.0)
    assert ("b",) not in cache and ("a",) in cache and ("c",) in cache
    assert cache.stats.evictions == 1


def test_cache_ttl_expiry_virtual_time():
    cache = ResultCache(capacity=8, ttl=5.0)
    cache.put(("k",), cost=1.0, now=0.0)
    assert cache.get(("k",), now=4.9) is not None
    assert cache.peek(("k",), now=10.1) is None
    assert ("k",) in cache
    assert cache.get(("k",), now=10.1) is None
    assert ("k",) not in cache
    assert cache.stats.expirations == 1


def test_cache_per_key_hit_cost_accounting():
    cache = ResultCache(capacity=8)
    cache.put(("hot",), cost=0.25)
    cache.put(("cold",), cost=1.0)
    for _ in range(3):
        assert cache.get(("hot",)) is not None
    assert cache.peek(("hot",)).hits == 3
    assert cache.peek(("hot",)).saved == pytest.approx(0.75)
    assert cache.stats.saved_cost == pytest.approx(0.75)
    assert cache.hit_rate == pytest.approx(1.0)
    assert cache.top_keys(1)[0][0] == ("hot",)


def test_cache_republish_carries_hit_accounting():
    cache = ResultCache(capacity=8)
    cache.put(("hot",), cost=0.5, now=0.0)
    cache.get(("hot",))
    cache.get(("hot",))
    cache.put(("hot",), cost=0.3, now=1.0)
    assert cache.peek(("hot",)).hits == 2
    assert cache.peek(("hot",)).created == 1.0


def test_cache_capacity_zero_disabled():
    cache = ResultCache(capacity=0)
    cache.put(("k",), cost=1.0)
    assert len(cache) == 0
    assert cache.get(("k",)) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity,ttl,factor", [(8, None, None),
                                                 (32, 3.0, None),
                                                 (16, 2.0, 4.0)])
def test_cache_op_sequence_equals_jax(seed, capacity, ttl, factor):
    """A seeded stream of put/get/peek/update operations leaves both
    packages' caches in the same state, operation for operation."""
    rng = np.random.default_rng(seed)
    caches = [pkg.index.ResultCache(capacity, ttl, ttl_update_factor=factor)
              for pkg in PACKAGES]
    now = 0.0
    for _ in range(400):
        now += float(rng.exponential(0.1))
        op = int(rng.integers(0, 4))
        key = ResultCache.make_key(int(rng.integers(0, 40)), 0.5,
                                   int(rng.integers(0, 2)))
        got = []
        for cache in caches:
            if op == 0:
                cache.put(key, cost=float(now % 1.0), now=now)
                got.append(None)
            elif op == 1:
                e = cache.get(key, now=now)
                got.append(None if e is None else (e.hits, e.cost, e.created))
            elif op == 2:
                e = cache.peek(key, now=now)
                got.append(None if e is None else (e.hits, e.cost, e.created))
            else:
                cache.note_update(now)
                got.append(None)
        assert got[0] == got[1]
    j, t = caches
    assert vars(j.stats) == vars(t.stats)
    assert list(j._entries) == list(t._entries)
    assert (j.ttl, j.update_cadence, j.cadence_state(), j.top_keys(5),
            j.source_heat()) == (t.ttl, t.update_cadence, t.cadence_state(),
                                 t.top_keys(5), t.source_heat())


# ---------------------------------------------------------------------------
# cost model: cold neutrality


def test_cost_model_cold_is_exactly_neutral():
    model = CacheAwareCostModel()
    assert model.work_discount() == 1.0
    assert model.time_discount() == 1.0
    assert model.discounted_queries(400) == 400
    stats = RuntimeStats(np.array([1.0, 2.0]))
    assert model.discounted_stats(stats) is stats


def test_cost_model_learns_and_clamps():
    model = CacheAwareCostModel(decay=0.5, max_trust=0.8)
    model.observe(100, 100)
    assert model.hit_rate == 1.0
    assert model.work_discount() == pytest.approx(0.2)
    model.observe(0, 100)
    assert model.hit_rate == pytest.approx(0.5)
    model.index_coverage = 1.0
    model.walk_share = 0.6
    assert model.time_discount() == pytest.approx(0.4)
    with pytest.raises(ValueError):
        model.observe(5, 4)


def test_readmit_uses_discounted_estimate():
    alloc = DeviceAllocator(devices=list(range(2)), spares_fraction=0.0)
    stats = RuntimeStats(np.full(4, 1.0))
    assert not alloc.readmit(8, 2.0, stats).feasible
    model = CacheAwareCostModel(max_trust=0.9)
    model.observe(9, 10)
    adm = alloc.readmit(8, 2.0, stats, cost_model=model)
    assert adm.feasible and adm.cores == 1


# ---------------------------------------------------------------------------
# serving integration, each scenario in both runtimes


def _distinct_sources(num_jobs, x):
    return [list(range(i * 10 * x, i * 10 * x + x)) for i in range(num_jobs)]


def test_cold_cache_run_matches_uncached_bit_for_bit():
    def drive(pkg, cache):
        rt = pkg.serving.ServingRuntime(
            pkg.serving.CorePool.of(24), sim_factory(pkg),
            pkg.serving.ServingConfig(scaling_factor=0.9), cache=cache)
        for i, s in enumerate(_distinct_sources(3, 60)):
            rt.submit(60, 8.0, at=i * 0.5, seed=i, sources=s)
        return outcome(rt, rt.run())

    for pkg in PACKAGES:
        base = drive(pkg, None)
        assert base == drive(pkg, pkg.index.ResultCache(capacity=4096))
        assert base == drive(pkg, pkg.index.ResultCache(capacity=0))
    assert drive(JAX, None) == drive(TORCH, None)


def test_fully_cached_job_bypasses_pool():
    cache = ResultCache(capacity=64)
    rt = ServingRuntime(CorePool.of(1), _factory(mean=0.05),
                        ServingConfig(scaling_factor=0.9), cache=cache)
    hog = rt.submit(40, 30.0, at=0.0, seed=0, sources=list(range(100, 140)))
    for src in range(20):
        cache.put(ResultCache.make_key(src, None, 0), cost=0.05, now=0.0)
    cached = rt.submit(20, 1.0, at=0.1, seed=1, sources=list(range(20)))
    report = rt.run()
    rec = report.records[cached.job_id]
    assert cached.state is JobState.DONE
    assert cached.completion == 0.1
    assert rec.cache_hits == 20 and rec.core_seconds == 0.0
    assert rec.grant_peak == 0
    assert rec.hit
    assert hog.state is JobState.DONE


@pytest.mark.parametrize("engine", [False, True])
def test_late_hits_shed_pending_work(engine):
    shared = list(range(300))

    def drive(pkg, cache):
        rt = pkg.serving.ServingRuntime(
            pkg.serving.CorePool.of(16), sim_factory(pkg, mean=0.05),
            pkg.serving.ServingConfig(scaling_factor=0.9, engine=engine),
            cache=cache)
        rt.submit(300, 20.0, at=0.0, seed=0, sources=shared)
        rt.submit(300, 20.0, at=0.5, seed=1, sources=shared)
        return rt, rt.run()

    _, uncached = drive(TORCH, None)
    rt, cached = drive(TORCH, ResultCache(capacity=4096))
    trailing = cached.records[1]
    assert trailing.cache_hits + trailing.late_hits > 0
    assert cached.core_seconds < uncached.core_seconds
    assert cached.completed == 2
    assert rt.model.hit_rate > 0.0
    jrt, jrep = drive(JAX, JAX.index.ResultCache(capacity=4096))
    assert outcome(rt, cached) == outcome(jrt, jrep)
    assert rt.model.hit_rate == jrt.model.hit_rate
    assert vars(rt.cache.stats) == vars(jrt.cache.stats)


def test_warm_model_admits_otherwise_rejected_job():
    cfg = ServingConfig(scaling_factor=0.9, degrade=False, extend=False,
                        sample_size=4)

    def drive(model):
        rt = ServingRuntime(CorePool.of(4), _factory(mean=0.1, cv=0.0),
                            cfg, cost_model=model)
        job = rt.submit(100, 1.2, at=0.0, seed=0)
        rt.run()
        return job

    assert drive(None).state is JobState.REJECTED
    warm = CacheAwareCostModel()
    warm.observe(9, 10)
    job = drive(warm)
    assert job.state is not JobState.REJECTED
    assert any("admitted" in line for line in job.log)


def test_grant_arrives_and_reshapes_as_mesh():
    def drive(pkg):
        rt = pkg.serving.ServingRuntime(
            pkg.serving.CorePool.of(8, lanes_per_device=8), sim_factory(pkg),
            pkg.serving.ServingConfig(scaling_factor=0.7))
        job = rt.submit(500, 12.0, at=0.0, seed=3)
        return rt, job, rt.run()

    rt, job, report = drive(TORCH)
    rec = report.records[0]
    assert rec.state == "done"
    mesh_lines = [line for line in job.log if "mesh" in line]
    assert len(mesh_lines) >= 2
    shapes = {line.split("mesh ")[1].split(" ")[0] for line in mesh_lines}
    assert len(shapes) >= 2
    assert rec.mesh_devices == job.mesh.devices
    assert rec.mesh_lanes == job.mesh.lanes
    assert job.mesh.cores_granted >= 1
    jrt, _, jreport = drive(JAX)
    assert outcome(rt, report) == outcome(jrt, jreport)


def test_pool_reserve_unreserve_arithmetic():
    pool = CorePool.of(4)
    assert pool.reserve(0, 3)
    assert pool.free == 1 and pool.reserved == 3
    assert not pool.reserve(1, 2)
    with pytest.raises(ValueError):
        pool.reserve(0, 1)
    assert pool.acquire(1, 1)
    assert pool.free == 0
    assert pool.unreserve(0) == 3
    assert pool.free == 3
    assert pool.unreserve(0) == 0


def test_preprocess_cores_occupy_pool():
    cfg = ServingConfig(scaling_factor=0.9, preprocess_cores=3,
                        sample_size=6)
    rt = ServingRuntime(CorePool.of(4), _factory(mean=0.1, cv=0.0), cfg)
    a = rt.submit(40, 30.0, at=0.0, seed=0)
    b = rt.submit(40, 30.0, at=0.05, seed=1)
    report = rt.run()
    assert report.completed == 2
    assert any("queued" in line for line in b.log)
    assert b.completion > a.arrival
    assert rt.pool.reserved == 0
    assert a.core_seconds >= 3 * a.t_pre


def test_preprocess_reservation_released_on_rejection():
    cfg = ServingConfig(scaling_factor=0.9, degrade=False, extend=False)
    rt = ServingRuntime(CorePool.of(1), _factory(mean=0.01, cv=0.1), cfg)
    a = rt.submit(40, 30.0, at=0.0, seed=0)
    b = rt.submit(200, 1e-4, at=0.0, seed=1)
    c = rt.submit(40, 30.0, at=0.0, seed=2)
    report = rt.run()
    assert a.state is JobState.DONE
    assert b.state is JobState.REJECTED
    assert c.state is JobState.DONE
    assert rt.pool.reserved == 0
    assert report.completed == 2


def test_trace_roundtrip_identical_admission_decisions():
    def drive(pkg, trace=None):
        rt = pkg.serving.ServingRuntime(
            pkg.serving.CorePool.of(32), sim_factory(pkg),
            pkg.serving.ServingConfig(scaling_factor=0.9))
        if trace is None:
            rt.submit_poisson(8, rate=0.7, queries=(100, 250),
                              deadline=(5.0, 9.0), seed=11)
        else:
            rt.submit_trace(trace)
        return rt, rt.run()

    rt1, rep1 = drive(TORCH)
    assert rep1.completed == len(rep1.records)
    records = rt1.trace_records()
    rt2, rep2 = drive(TORCH, records)
    assert rep1 == rep2
    for j1, j2 in zip(rt1.jobs, rt2.jobs):
        assert j1.log == j2.log
    jrt, jrep = drive(JAX, records)
    assert outcome(rt2, rep2) == outcome(jrt, jrep)
    assert drive(JAX)[0].trace_records() == records


def test_trace_records_preserve_sources_and_skip_unfinished():
    rt = ServingRuntime(CorePool.of(8), _factory(),
                        ServingConfig(scaling_factor=0.9, degrade=False,
                                      extend=False))
    rt.submit(20, 10.0, at=0.0, seed=0, sources=list(range(20)))
    rt.submit(500, 1e-4, at=0.1, seed=1)
    rt.run()
    records = rt.trace_records()
    assert len(records) == 1
    assert records[0]["sources"] == list(range(20))
    assert json.loads(json.dumps(records)) == records


def test_serve_cli_record_and_replay(tmp_path, capsys):
    from repro_torch.launch import serve

    path = tmp_path / "trace.json"
    serve.main(["--workload", "lm-decode", "--daemon", "--num-jobs", "4",
                "--arrival-rate", "0.8", "--queries", "60", "--deadline",
                "8", "--max-cores", "16", "--record-trace", str(path),
                "--device", "cpu"])
    rows = json.loads(path.read_text())
    assert len(rows) == 4 and all("at" in r and "deadline" in r for r in rows)
    capsys.readouterr()
    serve.main(["--workload", "lm-decode", "--daemon", "--trace", str(path),
                "--max-cores", "16", "--device", "cpu"])
    assert "trace" in capsys.readouterr().out
