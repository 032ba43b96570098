"""Port parity: the write-ahead log, snapshots, recovery, compaction and
the chaos harness of the port's serving runtime, mirroring
``tests/test_wal_recovery.py``, ``tests/test_wal_compaction.py`` and
``tests/test_chaos.py``; the two packages' WAL event streams are held
equal record for record, and a snapshot the port writes reads back leaf
for leaf through the JAX package's store.

It also pins a fault of both packages (ROADMAP queue 3, F8): recovery
re-executes the logged event suffix, which is deterministic only for an
executor whose times are a function of the logged inputs; with a
measuring executor (``ForaExecutor`` wall-clocks its queries) the replay
diverges."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch
from _serving_pair import JAX, PACKAGES, TORCH, outcome, records, sim_factory

import repro.checkpoint.store as jstore
from repro_torch.checkpoint import store
from repro_torch.ft.chaos import ChaosSchedule, ChaosSpec, drive_with_crashes
from repro_torch.index import ResultCache
from repro_torch.serving import JobState, RecoveryInfo, WriteAheadLog
from repro_torch.serving.wal import WAL_FILE, pack_state, unpack_state


def _runtime(pkg=TORCH, wal_dir=None, *, pool_cores=8, snapshot_every=5,
             compact_keep=0, cache=None, engine=False, spares=0.0,
             stragglers=False):
    s = pkg.serving
    rt = s.ServingRuntime(
        s.CorePool.of(pool_cores, spares_fraction=spares), sim_factory(pkg),
        s.ServingConfig(scaling_factor=0.9, sample_frac=0.05, engine=engine,
                        stragglers=stragglers),
        cache=cache)
    if wal_dir is not None:
        rt.attach_wal(s.WriteAheadLog(wal_dir, fsync=False),
                      snapshot_every=snapshot_every,
                      compact_keep=compact_keep)
    return rt


def _submit_small(rt, num_jobs=4):
    rt.submit_poisson(num_jobs, 1.2, queries=(10, 25), deadline=(2.0, 4.0),
                      seed=3)


def _reference(**kw):
    rt = _runtime(**kw)
    _submit_small(rt)
    return rt.run(), rt.events_processed


def _recover(wal_dir, pkg=TORCH):
    return pkg.serving.ServingRuntime.recover(wal_dir, sim_factory(pkg),
                                              fsync=False)


# ---------------------------------------------------------------------------
# the WAL file and the two packages' streams


def test_wal_roundtrip_and_torn_tail(tmp_path):
    wal = WriteAheadLog(tmp_path)
    recs = [{"type": "note", "i": i, "x": [1.5, None, "s"]} for i in range(4)]
    for r in recs:
        wal.append(r)
    wal.close()
    back = WriteAheadLog.read(tmp_path)
    assert [{k: v for k, v in r.items() if k != "v"} for r in back] == recs
    assert all(r["v"] == 1 for r in back)
    with open(tmp_path / WAL_FILE, "a") as fh:
        fh.write('{"type": "note", "i": 4')
    assert len(WriteAheadLog.read(tmp_path)) == 4
    assert JAX.serving.WriteAheadLog.read(tmp_path) == \
        WriteAheadLog.read(tmp_path)


def test_wal_mid_file_corruption_and_version_raise(tmp_path):
    wal = WriteAheadLog(tmp_path / "a")
    for i in range(3):
        wal.append({"type": "note", "i": i})
    wal.close()
    lines = (tmp_path / "a" / WAL_FILE).read_text().splitlines()
    lines[1] = lines[1][:5] + "garbage"
    (tmp_path / "a" / WAL_FILE).write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="corrupt"):
        WriteAheadLog.read(tmp_path / "a")
    (tmp_path / "b").mkdir()
    with open(tmp_path / "b" / WAL_FILE, "w") as fh:
        fh.write(json.dumps({"v": 99, "type": "init"}) + "\n")
    with pytest.raises(ValueError, match="version"):
        WriteAheadLog.read(tmp_path / "b")


@pytest.mark.parametrize("engine", [False, True])
@pytest.mark.parametrize("extras", ["plain", "cache_failures_mutations"])
def test_wal_event_streams_equal_jax(tmp_path, engine, extras):
    """The two runtimes write the same WAL, record for record: inputs,
    events (kind, tag, virtual time), notes and snapshot markers."""
    streams, snaps = [], []
    for pkg in PACKAGES:
        d = tmp_path / pkg.name
        cache = (pkg.index.ResultCache(64, ttl_update_factor=4.0)
                 if extras != "plain" else None)
        rt = _runtime(pkg, d, pool_cores=6, cache=cache, engine=engine,
                      snapshot_every=7)
        _submit_small(rt, 5)
        if extras != "plain":
            rt.inject_failures({1.5: [0], 2.5: [3]})
            rt.schedule_slowdowns({1.0: 2.0})
            rt.schedule_mutations(3, 1.0, seed=9, graph_n=200,
                                  refresh_budget=4, node_cost=0.01)
        rt.run()
        streams.append(pkg.serving.WriteAheadLog.read(d))
        steps = [r["step"] for r in streams[-1] if r["type"] == "snapshot"]
        snaps.append([pkg.wal.unpack_state(
            jstore.restore_list(d / "snapshots", s)[1]) for s in steps[-2:]])
    assert len(streams[0]) > 20
    assert streams[0] == streams[1]
    # the snapshots hold the same state (arrays compared by value)
    for a, b in zip(*snaps):
        assert json.dumps(pack_state(a)[0].tobytes().decode()) == \
            json.dumps(pack_state(b)[0].tobytes().decode())


def test_pack_unpack_state_roundtrip():
    state = {
        "clock": 3.25, "seq": 17, "big": 2**80,
        "heap": [[0.5, 1, "arrive", 0], [1.5, 2, "slot", 3]],
        "rng": {"state": {"state": 2**127 + 5, "inc": 11}},
        "times": np.linspace(0.0, 1.0, 7),
        "jobs": [{"mesh": np.arange(6).reshape(2, 3),
                  "none": None, "flag": True}],
    }
    leaves = pack_state(state)
    for a, b in zip(leaves, JAX.wal.pack_state(state)):
        np.testing.assert_array_equal(a, b)
    out = unpack_state(leaves)
    assert out["clock"] == state["clock"] and out["big"] == state["big"]
    assert out["rng"] == state["rng"]
    np.testing.assert_array_equal(out["times"], state["times"])
    np.testing.assert_array_equal(out["jobs"][0]["mesh"],
                                  state["jobs"][0]["mesh"])
    assert out["jobs"][0]["none"] is None and out["jobs"][0]["flag"] is True
    with pytest.raises(TypeError):
        pack_state({1: "non-string keys cannot survive JSON"})


# ---------------------------------------------------------------------------
# checkpoint store


def test_store_snapshot_reads_back_through_jax_restore_list(tmp_path):
    """A snapshot the port writes — numpy leaves, tensors (copied to the
    host), a bfloat16 tensor (stored widened), nested dicts and lists —
    reads back leaf for leaf through the JAX package's ``restore_list``,
    in ``jax.tree_util``'s leaf order."""
    import jax

    rng = np.random.default_rng(0)
    tree = {"b": [np.arange(5, dtype=np.int32),
                  torch.from_numpy(rng.random((3, 4), dtype=np.float32))],
            "a": {"z": np.float64(2.5), "y": None,
                  "x": torch.arange(6, dtype=torch.int64).reshape(2, 3)},
            "c": (torch.ones(2, dtype=torch.bfloat16), np.array([True]))}
    rt = _runtime(TORCH, tmp_path / "wal", snapshot_every=0)
    _submit_small(rt)
    rt.run(max_events=9)
    state_leaves = pack_state(rt._state_dict())
    store.save(tmp_path / "ck", 3, tree)
    store.save(tmp_path / "snap", 9, state_leaves)

    step, got = jstore.restore_list(tmp_path / "ck")
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda v: v.float().numpy() if isinstance(v, torch.Tensor)
        and v.dtype == torch.bfloat16 else np.asarray(v), tree,
        is_leaf=lambda v: isinstance(v, torch.Tensor)))
    assert step == 3 and len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.int64               # sorted keys: a/x first
    step, back = jstore.restore_list(tmp_path / "snap")
    assert step == 9 and len(back) == len(state_leaves)
    for g, w in zip(back, state_leaves):
        np.testing.assert_array_equal(g, w)
    # and the port restores into a template, tensors back on their device
    _, restored = store.restore(tmp_path / "ck", 3, tree)
    assert restored["c"][0].dtype == torch.bfloat16
    torch.testing.assert_close(restored["b"][1], tree["b"][1])
    assert restored["a"]["y"] is None and restored["a"]["z"] == 2.5
    with pytest.raises(ValueError, match="leaves"):
        store.restore(tmp_path / "ck", 3, {"only": np.zeros(1)})


def test_save_cleans_stale_tmp_and_gc(tmp_path):
    root = tmp_path / "ck"
    store.save(root, 1, [np.arange(4)])
    stale = root / ".tmp_step_00000007"
    stale.mkdir()
    (stale / "leaf_00000.npy").write_bytes(b"partial")
    store.save(root, 2, [np.arange(5)])
    assert not any(p.name.startswith(".tmp_step_") for p in root.iterdir())
    step, leaves = store.restore_list(root)
    assert step == 2
    np.testing.assert_array_equal(leaves[0], np.arange(5))
    (root / ".tmp_step_00000009").mkdir()
    assert store.restore_list(root)[0] == 2
    assert not (root / ".tmp_step_00000009").exists()
    for s in range(3, 7):
        store.save(root, s, [np.arange(s)], keep=2)
    assert sorted(p.name for p in root.glob("step_*")) == \
        ["step_00000005", "step_00000006"]
    assert store.latest_step(root) == 6
    with pytest.raises(FileNotFoundError):
        store.restore_list(tmp_path / "none")


def test_async_checkpointer_copies_before_returning(tmp_path):
    ck = store.AsyncCheckpointer(tmp_path / "ck", keep=2)
    t = torch.arange(4, dtype=torch.float32)
    ck.save(1, {"w": t})
    t.add_(100.0)                       # the caller moves on at once
    ck.wait()
    _, leaves = store.restore_list(tmp_path / "ck", 1)
    np.testing.assert_array_equal(leaves[0], np.arange(4, dtype=np.float32))


# ---------------------------------------------------------------------------
# recovery: crash transparency


def test_recover_from_snapshot_matches_uncrashed(tmp_path):
    ref, _ = _reference()
    rt = _runtime(TORCH, tmp_path)
    _submit_small(rt)
    assert rt.run(max_events=12) is None
    rt2, info = _recover(tmp_path)
    assert isinstance(info, RecoveryInfo)
    assert (info.snapshot_step, info.logged_events,
            info.replayed_events) == (10, 12, 2)
    rep = rt2.run()
    assert rep.records == ref.records and rep.end_time == ref.end_time


@pytest.mark.parametrize("mode", ["slots", "engine", "mutations",
                                  "compacted"])
def test_crash_anywhere_never_loses_a_job(tmp_path, mode):
    """Crash after every event prefix, recover, finish: the records equal
    the uncrashed run's (and the JAX package's), every job done."""
    engine = mode == "engine"
    keep = 1 if mode == "compacted" else 0

    def build(pkg, wal_dir=None):
        cache = (pkg.index.ResultCache(64, ttl_update_factor=4.0)
                 if mode == "mutations" else None)
        rt = _runtime(pkg, wal_dir, engine=engine, cache=cache,
                      pool_cores=4 if mode == "mutations" else 8,
                      compact_keep=keep)
        _submit_small(rt)
        if mode == "mutations":
            rt.schedule_mutations(5, 1.0, seed=9, graph_n=200,
                                  affected_frac=0.05, refresh_budget=4,
                                  node_cost=0.01)
        return rt

    ref_rt = build(TORCH)
    ref = ref_rt.run()
    jref_rt = build(JAX)
    assert records(jref_rt.run()) == records(ref)
    total = ref_rt.events_processed
    assert total > 10
    for point in range(1, total):
        wal_dir = tmp_path / f"crash_{point:03d}"
        rt = build(TORCH, wal_dir)
        assert rt.run(max_events=point) is None
        rt2, info = _recover(wal_dir)
        rep = rt2.run()
        assert rep.records == ref.records, f"diverged after crash @ {point}"
        assert all(j.state is JobState.DONE for j in rt2.jobs)
        if engine:
            assert rt2.ledger.outstanding == 0.0 and rt2.engine.busy == 0
        if mode == "mutations":
            assert (rt2.graph_version, rt2.mutations_applied,
                    rt2.pending_refresh, rt2.cache.ttl) == \
                (5, 5, ref_rt.pending_refresh, ref_rt.cache.ttl)


def test_recovery_determinism_with_failures_and_cache(tmp_path):
    shared = list(range(120))

    def build(wal_dir):
        rt = _runtime(TORCH, wal_dir, pool_cores=12,
                      cache=ResultCache(capacity=4096))
        rt.submit(120, 6.0, at=0.0, seed=0, sources=shared)
        rt.submit(120, 6.0, at=0.4, seed=1, sources=shared)
        rt.submit(80, 5.0, at=0.8, seed=2, sources=list(range(500, 580)))
        rt.inject_failures({1.0: [0, 1]})
        return rt

    ref_rt = build(None)
    ref = ref_rt.run()
    rt = build(tmp_path)
    assert rt.run(max_events=9) is None
    rt2, _ = _recover(tmp_path)
    rep = rt2.run()
    assert rep.records == ref.records
    assert [j.log for j in rt2.jobs] == [j.log for j in ref_rt.jobs]
    assert rt2.cache.stats == ref_rt.cache.stats
    assert rt2.model.hit_rate == ref_rt.model.hit_rate


def test_replay_rebills_divergence_and_deleted_snapshots(tmp_path):
    rt = _runtime(TORCH, tmp_path / "a", snapshot_every=0)
    _submit_small(rt)
    assert rt.run(max_events=6) is None
    rt2, info = _recover(tmp_path / "a")
    assert info.snapshot_step is None
    assert info.replayed_events == info.logged_events == 6
    rep = rt2.run()
    assert rt2.replay_pre_core_s > 0.0
    assert rep.completed == len(rep.records)
    markers = [r for r in WriteAheadLog.read(tmp_path / "a")
               if r["type"] == "recover"]
    assert markers and markers[-1]["replayed"] == 6

    rt = _runtime(TORCH, tmp_path / "b", snapshot_every=0)
    _submit_small(rt)
    assert rt.run(max_events=8) is None
    path = tmp_path / "b" / WAL_FILE
    lines = path.read_text().splitlines()
    for i, line in enumerate(lines):
        rec = json.loads(line)
        if rec["type"] == "event":
            rec["tag"] = 999
            lines[i] = json.dumps(rec)
            break
    path.write_text("\n".join(lines) + "\n")
    rt2, _ = _recover(tmp_path / "b")
    with pytest.raises(RuntimeError, match="diverged"):
        rt2.run()

    ref, _ = _reference()
    rt = _runtime(TORCH, tmp_path / "c", snapshot_every=5)
    _submit_small(rt)
    assert rt.run(max_events=13) is None
    shutil.rmtree(rt.wal.snapshot_dir)
    rt2, info = _recover(tmp_path / "c")
    assert info.snapshot_step is None and info.replayed_events == 13
    assert rt2.run().records == ref.records


# ---------------------------------------------------------------------------
# compaction


def test_compaction_truncates_covered_prefix(tmp_path):
    ref, _ = _reference()
    rt = _runtime(TORCH, tmp_path, compact_keep=1)
    _submit_small(rt)
    assert rt.run(max_events=12) is None
    recs = WriteAheadLog.read(tmp_path)
    assert [r["step"] for r in recs if r["type"] == "snapshot"] == [10]
    compacts = [r for r in recs if r["type"] == "compact"]
    assert len(compacts) == 1 and compacts[0]["covered"] == 10
    assert all(int(r["n"]) > 10 for r in recs if r["type"] == "event")
    assert sorted(d.name for d in rt.wal.snapshot_dir.glob("step_*")) == \
        ["step_00000010"]
    assert sum(r["type"] == "submit" for r in recs) == 4
    rt2, info = _recover(tmp_path)
    assert (info.snapshot_step, info.replayed_events) == (10, 2)
    rep = rt2.run()
    assert rep.records == ref.records and rep.end_time == ref.end_time
    assert rt2._compact_keep == 1


def test_compaction_fallback_and_refusal(tmp_path):
    ref, _ = _reference()
    rt = _runtime(TORCH, tmp_path / "a", compact_keep=2)
    _submit_small(rt)
    assert rt.run(max_events=12) is None
    shutil.rmtree(rt.wal.snapshot_dir / "step_00000010")
    rt2, info = _recover(tmp_path / "a")
    assert (info.snapshot_step, info.replayed_events) == (5, 7)
    assert rt2.run().records == ref.records

    rt = _runtime(TORCH, tmp_path / "b", compact_keep=1)
    _submit_small(rt)
    assert rt.run(max_events=12) is None
    before = WriteAheadLog.read(tmp_path / "b")
    stats = rt.wal.compact(keep=1)
    assert stats["dropped_events"] == 0 and stats["dropped_snapshots"] == 0
    assert WriteAheadLog.read(tmp_path / "b") == before
    shutil.rmtree(rt.wal.snapshot_dir)
    with pytest.raises(ValueError, match="compacted"):
        _recover(tmp_path / "b")

    wal = WriteAheadLog(tmp_path / "c", fsync=False)
    wal.append({"type": "init", "config": {}})
    for i in range(3):
        wal.append({"type": "event", "n": i + 1})
    before = WriteAheadLog.read(tmp_path / "c")
    assert wal.compact(keep=1) == {"covered": 0, "dropped_events": 0,
                                   "dropped_snapshots": 0}
    assert WriteAheadLog.read(tmp_path / "c") == before


# ---------------------------------------------------------------------------
# chaos


@pytest.mark.parametrize("spec", [
    "", "seed=7,failures=1,slowdowns=2,horizon=18,slow_factor=2.5",
    "seed=42,failures=3,slowdowns=2,crashes=4,horizon=10,crash_span=50",
    "seed=7,failures=1,slowdowns=2,crashes=2"])
@pytest.mark.parametrize("devices", [1, 8, 64])
def test_chaos_spec_and_schedule_equal_jax(spec, devices):
    got = ChaosSpec.parse(spec)
    want = JAX.chaos.ChaosSpec.parse(spec)
    assert vars(got) == vars(want)
    a = ChaosSchedule.from_spec(got, devices)
    b = JAX.chaos.ChaosSchedule.from_spec(want, devices)
    assert (a.failures, a.slowdowns, a.crashes) == \
        (b.failures, b.slowdowns, b.crashes)
    assert ChaosSchedule.from_spec(got, devices) == a


def test_chaos_spec_refusals():
    with pytest.raises(ValueError, match="unknown chaos spec key"):
        ChaosSpec.parse("seed=1,bogus=3")
    with pytest.raises(ValueError, match="not k=v"):
        ChaosSpec.parse("seed")
    with pytest.raises(ValueError, match="horizon"):
        ChaosSpec.parse("horizon=0")
    with pytest.raises(ValueError, match="crash_span"):
        ChaosSpec(crash_span=1)
    with pytest.raises(ValueError):
        ChaosSchedule.from_spec(ChaosSpec(), num_devices=0)


@pytest.mark.parametrize("engine", [False, True])
def test_drive_with_crashes_gives_the_uncrashed_records(tmp_path, engine):
    """A chaos run (failures, slowdowns, stragglers on spares) crashed at
    the schedule's points and recovered from the WAL ends with the records
    of the same run uncrashed, in both packages alike."""
    spec = ChaosSpec.parse("seed=7,failures=1,slowdowns=2,crashes=3,"
                           "horizon=4,crash_span=40")

    def build(pkg, wal_dir=None):
        rt = _runtime(pkg, wal_dir, pool_cores=16, engine=engine,
                      spares=0.15, stragglers=True,
                      cache=pkg.index.ResultCache(128))
        rt.submit_poisson(6, 1.5, queries=(30, 60), deadline=(2.0, 4.0),
                          seed=5)
        pkg.chaos.ChaosSchedule.from_spec(
            pkg.chaos.ChaosSpec(**vars(spec)), 16).apply(rt)
        return rt

    sched = ChaosSchedule.from_spec(spec, 16)
    assert len(sched.crashes) >= 2
    ref_rt = build(TORCH)
    ref = ref_rt.run()
    out = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg.name
        rep, infos, final = pkg.chaos.drive_with_crashes(
            build(pkg, d), d, sim_factory(pkg), sched.crashes, fsync=False)
        assert len(infos) == len(sched.crashes)
        assert all(r.state == "done" for r in rep.records)
        out[pkg.name] = outcome(final, rep)
    assert out["torch"]["records"] == records(ref)
    assert out["torch"]["records"] == out["jax"]["records"]
    assert out["torch"]["summary"] == out["jax"]["summary"]
    with pytest.raises(ValueError, match="no WAL"):
        drive_with_crashes(build(TORCH), tmp_path / "x", sim_factory(TORCH),
                           [5])


def test_drive_with_crashes_skips_passed_points(tmp_path):
    rt = _runtime(TORCH, tmp_path, snapshot_every=0)
    rt.submit(15, 5.0, seed=1)
    report, infos, final = drive_with_crashes(
        rt, tmp_path, sim_factory(TORCH), [100_000], fsync=False)
    assert report is not None and infos == []
    assert final.jobs[0].state is JobState.DONE


# ---------------------------------------------------------------------------
# F8: a measuring executor does not replay


def test_measuring_executor_replay_diverges_in_both_packages(tmp_path):
    """Recovery re-executes the logged suffix; a ``ForaExecutor`` measures
    its queries' wall time again, so a replayed arrival's preprocessing
    ends at another virtual time than the logged one and the replay
    check refuses it — in the JAX package (its executor on its small
    graph) and in the port alike. Logged measured times would be needed;
    neither package has them (ROADMAP queue 3, F8)."""
    import repro.ppr as jppr
    import repro_torch.ppr as tppr

    def factory(pkg_ppr, graph, **kw):
        return lambda job_id, nq, sd: pkg_ppr.ForaExecutor(
            workload=pkg_ppr.PprWorkload(graph=graph, num_queries=nq,
                                         seed=sd),
            params=pkg_ppr.ForaParams(alpha=0.2, epsilon=0.5), **kw)

    cases = [(JAX, factory(jppr, jppr.small_test_graph(n=120, avg_deg=4,
                                                        seed=0))),
             (TORCH, factory(tppr, tppr.small_test_graph(n=120, avg_deg=4,
                                                          seed=0),
                             device="cpu"))]
    for pkg, fac in cases:
        for engine in (False, True):
            d = tmp_path / f"{pkg.name}_{engine}"
            s = pkg.serving
            rt = s.ServingRuntime(s.CorePool.of(8), fac,
                                  s.ServingConfig(engine=engine))
            rt.attach_wal(s.WriteAheadLog(d, fsync=False), snapshot_every=5)
            rt.submit_poisson(3, 2.0, queries=16, deadline=2.0, seed=1)
            # event 1 is the first arrival, which measures its sample;
            # event 2 or 3 is then timed from that measurement
            with pytest.raises(RuntimeError, match="replay diverged"):
                pkg.chaos.drive_with_crashes(rt, d, fac, [3], fsync=False)
