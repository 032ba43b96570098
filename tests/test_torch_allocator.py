"""Port parity of the D&A device layer: the allocator, mesh plans, the time
sources, the cache-aware cost model and the elastic control loop give what
``repro.core`` and ``repro.ft.elastic`` give on the same seeds and
arguments; and the port's deadline-serving scenario prints the JAX
example's numbers. Samples are non-degenerate (unequal times), so the two
packages' ``t_avg`` agree exactly (ROADMAP F6)."""

from __future__ import annotations

from dataclasses import asdict

import numpy as np
import pytest

import repro.core as jcore
import repro.ft.elastic as jft
import repro_torch.core as tcore
import repro_torch.ft as tft
from repro_torch import deadline_serving

# t_max = 1.0 exactly, mean below it
TIMES = np.array([1.0, 0.7, 0.9, 0.8, 0.95])


def test_readmit_honest_feasibility():
    """tests/test_core_dna.py::test_readmit_honest_feasibility on both
    packages: readmit goes through Lemma 1 and reports feasible=False, with
    the minimal §III-A extension, when the asked deadline does not hold."""
    out = []
    for core in (jcore, tcore):
        alloc = core.DeviceAllocator(devices=list(range(4)),
                                     spares_fraction=0.0)
        stats = core.RuntimeStats(TIMES)
        ok = alloc.readmit(2, 10.0, stats)
        assert ok.feasible and not ok.extended and ok.cores == 1
        bad = alloc.readmit(100, 1.0, stats)
        assert not bad.feasible and bad.extended
        assert bad.deadline == pytest.approx(25.0)
        assert bad.cores == 4
        tight = alloc.readmit(1, 0.5, stats)
        assert not tight.feasible and tight.extended
        assert tight.deadline >= stats.t_max and tight.cores == 1
        zero = alloc.readmit(10, 0.0, stats)
        assert not zero.feasible and zero.extended and zero.deadline >= 2.5
        done = alloc.readmit(0, 1.0, stats)
        assert done.feasible and done.cores == 0
        out.append([asdict(a) for a in (ok, bad, tight, zero, done)])
    assert out[0] == out[1]


def test_admission_or_extend_adopts_extension():
    for core, ft in ((jcore, jft), (tcore, tft)):
        alloc = core.DeviceAllocator(devices=list(range(4)),
                                     spares_fraction=0.0)
        stats = core.RuntimeStats(TIMES)
        assert ft.admission_or_extend(alloc, 4, 10.0, stats) == 10.0
        assert ft.admission_or_extend(alloc, 100, 1.0, stats) == \
            pytest.approx(25.0)


@pytest.mark.parametrize("devices,spares,k", [(64, 0.05, 19), (16, 0.02, 16),
                                              (5, 0.5, 3)])
def test_allocator_capacity_and_slices(devices, spares, k):
    got = []
    for core in (jcore, tcore):
        alloc = core.DeviceAllocator(devices=list(range(devices)),
                                     spares_fraction=spares)
        sl = alloc.allocate(k)
        for i in (0, 2):
            alloc.mark_failed(i)
        with pytest.raises(IndexError):
            alloc.mark_failed(devices)
        with pytest.raises(core.InfeasibleDeadline):
            alloc.allocate(alloc.capacity + 1)
        got.append((sl, alloc.healthy, alloc.capacity, alloc.spares,
                    str(alloc.mesh_plan(3 * devices))))
    assert got[0] == got[1]
    with pytest.raises(ValueError):
        tcore.DeviceAllocator(devices=[])


@pytest.mark.parametrize("cores,num_devices,cap", [
    (1, 4, None), (4, 4, None), (7, 4, None), (9, 4, 3), (128, 3, None),
    (5, 8, 1)])
def test_plan_core_mesh_matches_jax(cores, num_devices, cap):
    j = jcore.plan_core_mesh(cores, num_devices, max_lanes_per_device=cap)
    t = tcore.plan_core_mesh(cores, num_devices, max_lanes_per_device=cap)
    assert asdict(t) == asdict(j) and str(t) == str(j)
    assert t.cores_granted >= cores
    assert t.cores_granted - cores <= t.devices - 1


def test_plan_core_mesh_refuses_what_jax_refuses():
    for args, kw, err in (((10, 4), {"max_lanes_per_device": 2},
                           "InfeasibleDeadline"),
                          ((0, 4), {}, "ValueError"),
                          ((3, 0), {}, "ValueError"),
                          ((3, 2), {"max_lanes_per_device": 0},
                           "ValueError")):
        for core in (jcore, tcore):
            with pytest.raises(getattr(core, err, ValueError)):
                core.plan_core_mesh(*args, **kw)


def test_elastic_controller_rescale_flow():
    """tests/test_substrates.py::test_elastic_controller_rescale_flow on
    both packages, with a heartbeat and a metrics sink attached."""
    got = []
    for core, ft in ((jcore, jft), (tcore, tft)):
        t = [0.0]
        sink = []

        class Sink:
            def emit(self, kind, **fields):
                sink.append((kind, fields))

        alloc = core.DeviceAllocator(devices=list(range(16)))
        events = []
        hb = ft.HeartbeatMonitor(16, timeout=5.0, clock=lambda: t[0])
        ctl = ft.ElasticController(
            allocator=alloc, injector=ft.FailureInjector({5: [0, 1]}),
            heartbeat=hb, on_rescale=lambda h: events.append(h),
            metrics=Sink())
        assert not ctl.tick(4)
        stats = core.RuntimeStats(TIMES / 10)
        assert ctl.tick(5, stats=stats, queries_left=100, deadline_left=10.0)
        assert events == [14]
        assert ctl.rescale_events[0]["readmission"]["cores"] >= 1
        t[0] = 6.0
        for i in range(16):
            if i != 9:
                hb.beat(i)
        t[0] = 10.0
        assert ctl.poll_heartbeat() == [9]
        assert events == [14, 13]
        ctl.note_stragglers(7, 1, [3], 1.0, 0.16)
        ctl.note_occupancy(1.5, 3, 4, 2)
        got.append((ctl.rescale_events, ctl.straggler_events,
                    ctl.occupancy_events, sink, events))
    assert got[0] == got[1]


def test_readmission_extends_deadline():
    for core in (jcore, tcore):
        alloc = core.DeviceAllocator(devices=list(range(4)),
                                     spares_fraction=0.0)
        stats = core.RuntimeStats(np.linspace(0.5, 1.0, 8))
        adm = alloc.readmit(num_queries_left=100, deadline_left=1.0,
                            stats=stats)
        assert adm.extended
        assert adm.deadline >= 100 * 1.0 / 4


def test_straggler_mitigation_cuts_makespan():
    outs = []
    for core, ft in ((jcore, jft), (tcore, tft)):
        mon = core.StragglerMonitor(t_hat=1.0, scaling_factor=0.8)
        lanes = np.array([0.5, 0.6, 9.0, 0.4])
        out = ft.run_with_straggler_mitigation(
            lanes, mon, spares=1, reissue_times=np.full(4, 0.5))
        assert out["reissued"] == [2]
        assert out["makespan_after"] < out["makespan_before"]
        assert out["makespan_after"] == pytest.approx(mon.threshold + 0.5)
        # the default re-issue times: a seeded permutation of the lanes
        outs.append((out, ft.run_with_straggler_mitigation(
            np.array([3.0, 0.2, 2.5, 0.1]), mon, spares=2)))
        assert mon.decide([3.0, 2.5], [False, True], spares=0) == []
        with pytest.raises(ValueError):
            core.StragglerMonitor(t_hat=0.0)
    assert outs[0] == outs[1]


def test_heartbeat_monitor():
    for ft in (jft, tft):
        t = [0.0]
        mon = ft.HeartbeatMonitor(3, timeout=5.0, clock=lambda: t[0])
        t[0] = 4.0
        mon.beat(0)
        t[0] = 7.0
        assert mon.dead() == [1, 2]


@pytest.mark.parametrize("mean,cv,base,seed", [(0.05, 0.4, 0.0, 7),
                                               (1.0, 0.0, 0.2, 0),
                                               (0.3, 1.5, 0.01, 11)])
def test_simulated_time_source_draws_and_resumes(mean, cv, base, seed):
    j = jcore.SimulatedTimeSource(mean=mean, cv=cv, base=base, seed=seed)
    t = tcore.SimulatedTimeSource(mean=mean, cv=cv, base=base, seed=seed)
    np.testing.assert_array_equal(t.measure(range(50)).times,
                                  j.measure(range(50)).times)
    state = t.state_dict()
    assert state == j.state_dict()
    ahead = t.measure(range(7)).times
    t.load_state(state)
    np.testing.assert_array_equal(t.measure(range(7)).times, ahead)
    np.testing.assert_array_equal(ahead, j.measure(range(7)).times)
    with pytest.raises(ValueError):
        t.measure([])
    with pytest.raises(ValueError):
        tcore.SimulatedTimeSource(mean=0.0)


def test_measured_time_source_warms_up_and_times_each_query():
    seen = []
    src = tcore.MeasuredTimeSource(run_query=seen.append, warmup=2)
    stats = src.measure([5, 6, 7])
    assert seen == [5, 6, 5, 6, 7]
    assert stats.n == 3 and (stats.times >= 0).all()
    assert isinstance(src, tcore.TimeSource)
    with pytest.raises(ValueError):
        src.measure([])


@pytest.mark.parametrize("cv,per_block", [(0.0, 1), (0.0, 8), (0.3, 4)])
def test_roofline_time_source_matches_jax(cv, per_block):
    got = []
    for core in (jcore, tcore):
        terms = core.RooflineTerms(compute_s=2e-3, memory_s=5e-3,
                                   collective_s=1e-3)
        assert terms.step_time_s == 5e-3 and terms.dominant == "memory"
        src = core.RooflineTimeSource(terms, queries_per_block=per_block,
                                      jitter_cv=cv, seed=3)
        got.append(src.measure(range(20)).times)
    np.testing.assert_array_equal(got[1], got[0])


def test_cache_aware_cost_model_matches_jax():
    j = jcore.CacheAwareCostModel(walk_share=0.6, index_coverage=0.5)
    t = tcore.CacheAwareCostModel(walk_share=0.6, index_coverage=0.5)
    stats = (jcore.RuntimeStats(TIMES), tcore.RuntimeStats(TIMES))
    # cold: both discounts exactly 1
    assert t.work_discount() == 1.0 and t.hit_rate == 0.0
    assert t.discounted_queries(100) == 100
    for hits, lookups in ((3, 10), (0, 0), (10, 10), (7, 20), (0, 5)):
        j.observe(hits, lookups)
        t.observe(hits, lookups)
        assert t.hit_rate == j.hit_rate
        assert t.work_discount() == j.work_discount()
        assert t.time_discount() == j.time_discount()
        for x in (0, 1, 37, 1000):
            assert t.discounted_queries(x) == j.discounted_queries(x)
        np.testing.assert_array_equal(t.discounted_stats(stats[1]).times,
                                      j.discounted_stats(stats[0]).times)
    # the readmission consumes the discounts the same way
    adm = []
    for core, model, st in ((jcore, j, stats[0]), (tcore, t, stats[1])):
        alloc = core.DeviceAllocator(devices=list(range(8)),
                                     spares_fraction=0.0)
        adm.append(asdict(alloc.readmit(400, 30.0, st, cores_per_device=2,
                                        cost_model=model)))
    assert adm[0] == adm[1]
    for bad in ({"decay": 1.0}, {"max_trust": -0.1}, {"walk_share": 2.0},
                {"index_coverage": -1.0}):
        with pytest.raises(ValueError):
            tcore.CacheAwareCostModel(**bad)
    with pytest.raises(ValueError):
        t.observe(3, 2)
    assert not hasattr(tcore.CacheAwareCostModel, "seeded_from_tuning")


def test_deadline_serving_prints_the_jax_example(capsys):
    out = deadline_serving.run()
    assert (out["cores"], out["lemma2_cores"]) == (19, 20)
    assert round(out["reduction_vs_lemma2_pct"]) == 5
    assert out["allocated"] == 19 and out["healthy"] == 56
    assert out["readmit_cores"] == 34 and not out["extended"]
    assert round(out["makespan_before"], 2) == 1.00
    assert round(out["makespan_after"], 2) == 0.16
    assert out["reissued"] == [3]
    printed = capsys.readouterr().out.splitlines()
    assert printed == [
        "allocation: 19 cores for X=2000 T=6.0s (Lemma-2 says 20; -5%)",
        "allocated devices: [0, 1, 2, 3, 4]... (19 total)",
        "after failure: 56 healthy; readmission needs 34 cores, deadline "
        "unchanged",
        "straggler mitigation: makespan 1.00s -> 0.16s (re-issued lanes [3])"]


def test_slot_lanes_feed_the_straggler_monitor():
    # the example's allocation (19 cores): one slot's per-query times, one
    # lane stalled by 20 t_hat, re-issued at the example's 50 ms
    fleet = tcore.DeviceAllocator(devices=list(range(deadline_serving.FLEET)),
                                  spares_fraction=0.05)
    src = tcore.SimulatedTimeSource(mean=0.05, cv=0.4, seed=7)
    res = tcore.dna_real(2_000, 6.0, lambda ids: src.measure(ids),
                         max_cores=fleet.capacity, sample_size=100,
                         preprocess_cores=8, scaling_factor=0.9)
    qids, lanes = deadline_serving.slot_lanes(res.execution)
    assert res.cores >= 2 and tuple(qids) in res.execution.plan.slots
    assert lanes.tolist() == [res.execution.per_query_times[q] for q in qids]
    assert lanes.max() == max(res.execution.per_query_times.values())
    lanes[1] += 20 * res.sample_stats.t_hat()
    out = deadline_serving.survive(fleet, res, 2_000, 6.0, 0.9, lanes,
                                   reissue_times=np.full(lanes.size, 0.05),
                                   log=lambda s: None)
    thr = res.sample_stats.t_hat() * (2 - 0.9)
    over = sorted(((t, i) for i, t in enumerate(lanes) if t > thr),
                  reverse=True)
    assert out["reissued"] == [i for _, i in over][:fleet.spares]
    assert 1 in out["reissued"]
    assert out["makespan_after"] < out["makespan_before"]
    with pytest.raises(ValueError, match="no executed slot"):
        deadline_serving.slot_lanes(tcore.SlotExecution(
            plan=tcore.build_slot_plan([], 1, 1), core_totals=np.zeros(1),
            per_query_times={}))
