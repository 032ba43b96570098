"""Port parity: the online serving runtime (``repro_torch.serving``).

Each seeded ``SimJobExecutor`` scenario — Poisson arrivals, a replayed
trace, failure injection, degradation, the cold-compile surcharge,
stragglers with slowdowns, heartbeats, mutations, in slot and in engine
mode — runs through both packages' runtimes, which must give identical
``JobRecord``s, ``ServingReport.summary()`` strings, job logs and
controller events. Then the port's runtime drives the port's
``ForaExecutor`` on the CPU over ``small_test_graph``, slot by slot
through ``run_chunk`` and as an engine-mode daemon, mirroring
``tests/test_serving.py``."""

from __future__ import annotations

import pytest
from _serving_pair import JAX, TORCH, outcome, sim_factory

from repro_torch.core import SimulatedTimeSource, dna_real
from repro_torch.ft.elastic import ElasticController, HeartbeatMonitor
from repro_torch.ppr import (ForaExecutor, ForaParams, PprWorkload,
                             small_test_graph)
from repro_torch.serving import (CorePool, JobState, ServingConfig,
                                 ServingRuntime, SimJobExecutor,
                                 run_single_job)

TRACE = [{"at": 0.0, "queries": 120, "deadline": 6.0, "seed": 4},
         {"at": 0.4, "queries": 60, "deadline": 3.0, "seed": 9,
          "sources": list(range(60))},
         {"at": 0.4, "queries": 200, "deadline": 8.0},
         {"at": 2.5, "queries": 90, "deadline": 5.0, "seed": 1}]


def _poisson(rt, n=8, rate=0.7, queries=(100, 250), deadline=(5.0, 9.0),
             seed=11):
    rt.submit_poisson(n, rate=rate, queries=queries, deadline=deadline,
                      seed=seed)


def _drive(pkg, *, cores=32, spares=0.0, lanes=1, cfg=None, mean=0.05,
           cv=0.3, submit=_poisson, extra=None, heartbeat=None):
    s = pkg.serving
    pool = s.CorePool.of(cores, lanes_per_device=lanes,
                         spares_fraction=spares)
    hb = heartbeat(pkg) if heartbeat is not None else None
    controller = pkg.ft_elastic.ElasticController(allocator=pool.allocator,
                                                  heartbeat=hb)
    rt = s.ServingRuntime(pool, sim_factory(pkg, mean, cv),
                          s.ServingConfig(**(cfg or {})),
                          controller=controller)
    submit(rt)
    if extra is not None:
        extra(rt)
    return rt, rt.run()


def _heartbeat(pkg):
    clk = [0.0]
    hb = pkg.ft_elastic.HeartbeatMonitor(8, timeout=1.0,
                                         clock=lambda: clk[0])
    clk[0] = 5.0
    for i in range(1, 8):
        hb.beat(i)                       # device 0 has been silent 5 s
    return hb


SCENARIOS = {
    "poisson": dict(cfg=dict(scaling_factor=0.9)),
    "poisson_engine": dict(cfg=dict(scaling_factor=0.9, engine=True)),
    "engine_small_lane_pool": dict(cores=16, cfg=dict(engine=True,
                                                      lane_pool=6)),
    "trace": dict(cores=16, submit=lambda rt: rt.submit_trace(TRACE),
                  cfg=dict(scaling_factor=0.9)),
    "trace_engine": dict(cores=16, submit=lambda rt: rt.submit_trace(TRACE),
                         cfg=dict(scaling_factor=0.9, engine=True)),
    "failures": dict(cores=12, cfg=dict(scaling_factor=0.9), submit=lambda
                     rt: _poisson(rt, 8, 0.8, (250, 450), (5.0, 8.0), 0),
                     extra=lambda rt: rt.inject_failures(
                         {4.0: [0, 1, 2, 3, 4, 5, 6, 7], 9.0: [8]})),
    "failures_engine": dict(cores=12, cfg=dict(engine=True), submit=lambda
                            rt: _poisson(rt, 6, 0.8, (150, 300), (5.0, 8.0),
                                         0),
                            extra=lambda rt: rt.inject_failures(
                                {3.0: [0, 1, 2, 3, 4, 5]})),
    "degradation": dict(cores=2, mean=0.08, submit=lambda rt: rt.submit(
        300, 4.0, at=0.0, seed=0), cfg=dict(degrade_factor=0.5,
                                            max_degrades=3)),
    "extended_no_degrade": dict(cores=2, mean=0.1, submit=lambda rt:
                                rt.submit(200, 2.0, at=0.0, seed=0),
                                cfg=dict(degrade=False)),
    "replan_shrink": dict(cores=64, submit=lambda rt: rt.submit(
        500, 12.0, at=0.0, seed=3), cfg=dict(scaling_factor=0.7)),
    "mesh_lanes": dict(cores=8, lanes=8, submit=lambda rt: rt.submit(
        500, 12.0, at=0.0, seed=3), cfg=dict(scaling_factor=0.7)),
    "queued_and_rejected": dict(cores=1, mean=0.01, cv=0.1, submit=lambda
                                rt: [rt.submit(40, 30.0, seed=0),
                                     rt.submit(200, 1e-4, seed=1),
                                     rt.submit(40, 30.0, seed=2)],
                                cfg=dict(degrade=False, extend=False)),
    "cold_compile": dict(cores=16, cfg=dict(cold_compile_s=2.0),
                         submit=lambda rt: _poisson(rt, 4, 1.0, (60, 120),
                                                    (5.0, 8.0), 3)),
    "cold_compile_engine": dict(cores=16, cfg=dict(cold_compile_s=2.0,
                                                   engine=True),
                                submit=lambda rt: _poisson(
                                    rt, 4, 1.0, (60, 120), (5.0, 8.0), 3)),
    "warm_start": dict(cores=16, cfg=dict(cold_compile_s=2.0,
                                          warm_start=True),
                       submit=lambda rt: _poisson(rt, 4, 1.0, (60, 120),
                                                  (5.0, 8.0), 3)),
    "stragglers": dict(cores=16, spares=0.15, cfg=dict(stragglers=True),
                       submit=lambda rt: _poisson(rt, 6, 1.0, (60, 120),
                                                  (4.0, 7.0), 5),
                       extra=lambda rt: rt.schedule_slowdowns({2.5: 3.0})),
    "slowdowns_engine": dict(cores=16, cfg=dict(engine=True), submit=lambda
                             rt: _poisson(rt, 5, 1.0, (60, 120), (4.0, 7.0),
                                          5),
                             extra=lambda rt: rt.schedule_slowdowns(
                                 {1.0: 2.0, 2.5: 4.0})),
    "heartbeat": dict(cores=8, heartbeat=_heartbeat, submit=lambda rt:
                      _poisson(rt, 4, 1.0, (40, 80), (4.0, 7.0), 2)),
    "mutations": dict(cores=16, cfg=dict(engine=True), submit=lambda rt:
                      _poisson(rt, 4, 1.0, (60, 120), (4.0, 7.0), 1),
                      extra=lambda rt: rt.schedule_mutations(
                          5, 2.0, seed=3, graph_n=1000, refresh_budget=20,
                          node_cost=0.001)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax_runtime(name):
    kw = SCENARIOS[name]
    jrt, jrep = _drive(JAX, **kw)
    trt, trep = _drive(TORCH, **kw)
    assert outcome(trt, trep) == outcome(jrt, jrep)
    assert trep.summary() == jrep.summary()
    assert (trt.pre_core_s, trt.graph_version, trt.mutations_applied,
            trt.pending_refresh, trt.refresh_core_s, trt.rebuild_core_s) == \
        (jrt.pre_core_s, jrt.graph_version, jrt.mutations_applied,
         jrt.pending_refresh, jrt.refresh_core_s, jrt.rebuild_core_s)
    assert trt.trace_records(completed_only=False) == \
        jrt.trace_records(completed_only=False)
    # the port's own contract: no job is lost, and a second drive repeats
    assert all(r.state in ("done", "rejected") for r in trep.records)
    assert outcome(*_drive(TORCH, **kw)) == outcome(trt, trep)


def test_scenarios_exercise_their_paths():
    """Each scenario reaches the path it is named for (so the parity above
    compares something)."""
    def run(name):
        return _drive(TORCH, **SCENARIOS[name])

    rt, rep = run("failures")
    assert rep.completed == len(rep.records) and rep.rejected == 0
    assert rt.pool.total == 3 and len(rt.controller.rescale_events) == 2
    assert rep.extended > 0
    rt, rep = run("degradation")
    assert rep.records[0].degraded and rt.jobs[0].executor.scale < 1.0
    rt, rep = run("replan_shrink")
    assert any("shrink" in line for line in rt.jobs[0].log)
    assert rep.core_seconds < rep.lemma2_core_seconds
    rt, rep = run("queued_and_rejected")
    assert [j.state for j in rt.jobs] == [JobState.DONE, JobState.REJECTED,
                                         JobState.DONE]
    rt, rep = run("stragglers")
    assert rt.controller.straggler_events
    rt, rep = run("heartbeat")
    assert rt.pool.allocator.failed == {0}
    rt, rep = run("mutations")
    assert rt.mutations_applied == 5 and rt.graph_version == 5
    rt, rep = run("poisson_engine")
    assert rt.controller.occupancy_events and rep.completed == 8
    rt_c, _ = run("cold_compile")
    rt_w, rep_w = run("warm_start")
    rt_0, rep_0 = _drive(TORCH, cores=16, submit=SCENARIOS["warm_start"][
        "submit"])
    assert rep_w == rep_0 and rt_w.pre_core_s == rt_0.pre_core_s
    assert rt_c.pre_core_s - rt_0.pre_core_s == pytest.approx(2.0)


def test_single_job_reproduces_dna_real_bit_for_bit():
    src = SimulatedTimeSource(mean=0.05, cv=0.3, seed=5)
    res = dna_real(400, deadline=10.0, executor=lambda ids: src.measure(ids),
                   max_cores=64, sample_size=25, scaling_factor=0.9, seed=9)
    ex = SimJobExecutor(mean=0.05, cv=0.3, seed=5)
    job, report = run_single_job(400, 10.0, ex, 64, sample_size=25,
                                 scaling_factor=0.9, seed=9)
    rec = report.records[0]
    assert rec.grant_peak == res.cores
    assert job.completion == res.completion_time
    assert job.state is JobState.DONE
    assert rec.hit and not rec.degraded and not rec.extended


def test_runtime_accounting_consistency():
    rt = ServingRuntime(CorePool.of(16), sim_factory(TORCH),
                        ServingConfig(scaling_factor=0.9))
    rt.submit_poisson(5, rate=1.0, queries=(80, 160), deadline=(5.0, 8.0),
                      seed=2)
    report = rt.run()
    for rec in report.records:
        assert rec.core_seconds > 0
        assert rec.lemma2_core_seconds > 0
        assert rec.lateness >= 0
    assert rt.pool.used == 0


# ---------------------------------------------------------------------------
# the port's ForaExecutor under the port's runtime, on the CPU


GRAPH = small_test_graph(n=120, avg_deg=6, seed=0)


def _fora_factory(executors):
    def factory(job_id, nq, sd):
        ex = ForaExecutor(PprWorkload(GRAPH, num_queries=nq, seed=sd),
                          ForaParams(alpha=0.2, epsilon=0.5), device="cpu")
        executors[job_id] = ex
        return ex
    return factory


def test_runtime_drives_fora_executor_via_run_chunk():
    """Each slot is one batched device call through ``run_chunk``; the
    sample runs query by query through ``__call__``."""
    executors: dict = {}
    rt = ServingRuntime(CorePool.of(8), _fora_factory(executors),
                        ServingConfig(scaling_factor=0.9, sample_size=4))
    rt.submit(16, 60.0, at=0.0, seed=0)
    rt.submit(16, 60.0, at=0.1, seed=1)
    report = rt.run()
    assert report.completed == 2
    for job_id, ex in executors.items():
        job = rt.jobs[job_id]
        assert ex.calls == 4 + job.stepper.steps


def test_ppr_daemon_engine_accounting_on_the_cpu(tmp_path):
    """An engine-mode PPR daemon as ``serve_daemon`` builds it: every job
    ends done, degraded or extended with consistent accounting, the lane
    ledger drains, and each job's measured queries ran through its
    ``ForaExecutor``."""
    executors: dict = {}
    pool = CorePool.of(8)
    rt = ServingRuntime(pool, _fora_factory(executors),
                        ServingConfig(scaling_factor=0.9, engine=True),
                        controller=ElasticController(allocator=pool.allocator,
                                                     heartbeat=None))
    rt.submit_poisson(3, 4.0, queries=16, deadline=2.0, seed=1)
    report = rt.run()
    assert report.completed == 3 and report.rejected == 0
    for rec in report.records:
        assert rec.core_seconds > 0 and rec.lemma2_core_seconds >= 0
        assert rec.lateness >= 0
    assert rt.ledger.outstanding == pytest.approx(0.0, abs=1e-12)
    assert rt.engine.busy == 0 and rt.pool.used == 0
    for job_id, ex in executors.items():
        job = rt.jobs[job_id]
        assert ex.calls == job.num_queries      # sample + rest, per query
        assert job.engine_done == job.engine_total
        # c * t_pre of preprocessing plus every measured query's time
        assert job.core_seconds > job.t_pre > 0.0
        assert ex.device_graph is not None and ex.device_graph.n == GRAPH.n


def test_daemon_heartbeat_uses_wall_clock():
    import time

    from repro_torch.launch.serve import _daemon_heartbeat, build_parser

    args = build_parser().parse_args(
        ["--daemon", "--workload", "lm-decode", "--heartbeat-timeout", "5"])
    hb = _daemon_heartbeat(args, num_devices=4)
    assert isinstance(hb, HeartbeatMonitor)
    assert hb.clock is time.monotonic
    assert hb.timeout == 5.0 and len(hb.last_seen) == 4
    args = build_parser().parse_args(["--daemon", "--workload", "lm-decode"])
    assert _daemon_heartbeat(args, num_devices=4) is None


@pytest.mark.parametrize("layout,safety", [("dense", 2.0), ("sliced", 0.5),
                                           ("auto", 1.0)])
def test_cli_executor_options_reach_the_executor(layout, safety):
    """``--ell-layout`` and ``--walk-safety`` reach the port's executor as
    they reach the JAX one: the same push table layout and the same
    calibrated walk budget."""
    import repro.ppr as jppr
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args([
        "--ell-layout", layout, "--walk-safety", str(safety), "--device",
        "cpu"])
    serve.prepare(args)
    ex = serve._fora_executor(args, PprWorkload(GRAPH, num_queries=32,
                                                seed=3))
    ex.warmup()
    jgraph = jppr.small_test_graph(n=120, avg_deg=6, seed=0)
    jex = jppr.ForaExecutor(jppr.PprWorkload(jgraph, num_queries=32, seed=3),
                            jppr.ForaParams(alpha=0.2, epsilon=args.epsilon),
                            ell_layout=layout, walk_safety=safety)
    jex.warmup()
    assert ex.device_graph.layout == jex._device_graph.layout
    assert ex.device_graph.ell_width == jex._device_graph.ell_width
    assert ex.current_walk_budget() == jex.current_walk_budget()
    with pytest.raises(ValueError, match="walk_safety"):
        ForaExecutor(PprWorkload(GRAPH, 4), device="cpu", walk_safety=0.0)
    with pytest.raises(ValueError, match="ell_layout"):
        ForaExecutor(PprWorkload(GRAPH, 4), device="cpu", ell_layout="csr")
