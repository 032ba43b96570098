"""Port parity: the kernel tuning cache (``repro_torch.kernels.autotune``)
against ``repro.kernels.autotune`` — shape buckets, the cache file, cost
model seeding — and the tuned residency: a cold cache leaves it
bit-identical, a warm one refines only what the caller left unpinned, at
build time only, and ``Graph.device``'s mirror follows a changed cache."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.kernels.autotune as jtune
import repro.ppr.graph as jgraph
from repro.core.estimator import CacheAwareCostModel as JCostModel
from repro_torch.core.estimator import CacheAwareCostModel
from repro_torch.kernels import autotune, ref
from repro_torch.kernels.autotune import (TunedConfig, TuningCache,
                                          measure_compiled, shape_bucket,
                                          sweep_sliced, sweep_walk)
from repro_torch.ppr.fora import ForaParams, fora_fused
from repro_torch.ppr.graph import DeviceGraph, Graph

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cold_cache():
    """Every test starts and ends with no active tuning cache in either
    package."""
    autotune.clear_cache()
    jtune.clear_cache()
    yield
    autotune.clear_cache()
    jtune.clear_cache()


def _powerlaw_graph(n: int, seed: int, hub_fanin: int | None = None):
    rng = np.random.default_rng(seed)
    hub_fanin = n - 1 if hub_fanin is None else hub_fanin
    src = np.concatenate([rng.choice(n, size=hub_fanin, replace=False),
                          rng.integers(0, n, 3 * n)])
    dst = np.concatenate([np.zeros(hub_fanin, np.int64),
                          rng.integers(0, n, 3 * n)])
    return Graph.from_edges(n, src, dst, name=f"pl{n}s{seed}")


def _tuned(g: Graph, **cfg) -> TuningCache:
    cache = TuningCache()
    cache.record("cpu", "sliced", shape_bucket(g.n, g.m), TunedConfig(**cfg))
    return cache


# ---------------------------------------------------------------------------
# the cache and its keys


@pytest.mark.parametrize("n", [1, 2, 3, 511, 512, 513, 4000, 4096, 281_903])
@pytest.mark.parametrize("deg", [0.0, 0.4, 1.0, 2.5, 4.0, 6.48, 19.0, 64.0])
def test_shape_bucket_equals_jax(n, deg):
    m = int(round(n * deg))
    assert shape_bucket(n, m) == jtune.shape_bucket(n, m)


def test_current_backend_from_the_device():
    assert autotune.current_backend("cpu") == "cpu"
    assert autotune.current_backend(torch.device("cuda", 0)) == "cuda"
    assert autotune.current_backend() == (
        "cuda" if torch.cuda.is_available() else "cpu")
    with pytest.raises(ValueError, match="unsupported"):
        autotune.current_backend("meta")


def test_cache_round_trip_and_atomicity(tmp_path):
    path = tmp_path / "tune.json"
    cache = TuningCache(path=path)
    cfg = TunedConfig(block_n=256, pad_multiple=16, width=32,
                      device_us=42.5, compile_us=1000.0)
    cache.record("cuda", "sliced", "n512_d4", cfg)
    cache.record("cuda", "walk", "n512_d4", TunedConfig(device_us=7.0))
    cache.save()
    loaded = TuningCache.load(path)
    assert loaded.entries == cache.entries
    assert loaded.lookup("cuda", "sliced", "n512_d4") == cfg
    assert loaded.lookup("cpu", "sliced", "n512_d4") is None
    assert [p.name for p in tmp_path.iterdir()] == ["tune.json"]
    with pytest.raises(ValueError, match="no path"):
        TuningCache().save()


def test_cache_file_reads_the_same_in_both_packages(tmp_path):
    """One schema: a file the port writes loads in the JAX package with
    the same entries, and the reverse, byte for byte."""
    cfgs = {("cuda", "sliced", "n512_d4"): dict(pad_multiple=16, width=32,
                                                device_us=77.24,
                                                compile_us=3.5e6),
            ("cuda", "walk", "n512_d4"): dict(device_us=120.5),
            ("cpu", "dense", "n1024_d8"): dict(block_n=128, pad_multiple=8)}
    port, jax_ = TuningCache(path=tmp_path / "p.json"), \
        jtune.TuningCache(path=tmp_path / "j.json")
    for (be, lay, bkt), kw in cfgs.items():
        port.record(be, lay, bkt, TunedConfig(**kw))
        jax_.record(be, lay, bkt, jtune.TunedConfig(**kw))
    port.save()
    jax_.save()
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    back = jtune.TuningCache.load(tmp_path / "p.json")
    assert {k: vars(v) for k, v in back.entries.items()} == \
        {k: vars(v) for k, v in port.entries.items()}


def test_cache_schema_mismatch_raises(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({"schema": 999, "entries": {}}))
    with pytest.raises(ValueError, match="schema"):
        TuningCache.load(path)


def test_cache_env_activation(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    cache = TuningCache(path=path)
    cache.record("cpu", "sliced", "n64_d2", TunedConfig(width=16))
    cache.save()
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    autotune.clear_cache()
    active = autotune.get_cache()
    assert active is not None
    assert active.lookup("cpu", "sliced", "n64_d2").width == 16
    autotune.set_cache(None)
    assert autotune.get_cache() is None


# ---------------------------------------------------------------------------
# residency: cold bit-identity, tuned refinement, build-time-only lookup


@pytest.mark.parametrize("layout", ["auto", "sliced", "dense"])
def test_cold_cache_residency_is_bit_identical(layout):
    """No active cache, or one without this graph's key, gives the same
    residency as the JAX package's cold build (array-equal)."""
    g = _powerlaw_graph(120, 3)
    jg = jgraph.Graph.from_edges(g.n, g.edge_src, g.edge_dst, name=g.name)
    want = jgraph.DeviceGraph.from_graph(jg, layout=layout)
    for cache in (None, TuningCache()):
        autotune.set_cache(cache)
        dg = DeviceGraph.from_graph(g, layout=layout, device=CPU)
        assert dg.ell_width == want.ell_width
        for f in ("in_neighbors", "in_mask", "in_weights", "in_row_map"):
            a, b = getattr(dg, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert g.sliced_ell_width() == jg.sliced_ell_width()


def test_tuned_residency_refines_only_unpinned_params():
    g = _powerlaw_graph(120, 3)
    cold = DeviceGraph.from_graph(g, layout="sliced", device=CPU)
    tuned_w = cold.ell_width * 2
    cache = _tuned(g, pad_multiple=16, width=tuned_w, device_us=1.0)
    autotune.set_cache(cache)
    dg = DeviceGraph.from_graph(g, layout="sliced", device=CPU)
    assert dg.ell_width == tuned_w
    assert g.sliced_ell_width() == tuned_w
    # the JAX package refines the same way (its block_n aside)
    jtune.set_cache(jtune.TuningCache(entries={
        k: jtune.TunedConfig(**vars(v)) for k, v in cache.entries.items()}))
    jg = jgraph.Graph.from_edges(g.n, g.edge_src, g.edge_dst, name=g.name)
    want = jgraph.DeviceGraph.from_graph(jg, layout="sliced")
    assert want.ell_width == tuned_w
    np.testing.assert_array_equal(dg.in_neighbors.numpy(),
                                  np.asarray(want.in_neighbors))
    # pinned values always beat the cache
    pinned = DeviceGraph.from_graph(g, layout="sliced", width=8,
                                    pad_multiple=1, device=CPU)
    assert pinned.ell_width == 8
    assert DeviceGraph.from_graph(g, layout="sliced", pad_multiple=8,
                                  device=CPU).ell_width == cold.ell_width
    assert g.sliced_ell_width(8) == cold.ell_width
    # a dense table has nothing to refine
    dense = DeviceGraph.from_graph(g, layout="dense", device=CPU)
    autotune.set_cache(None)
    assert dense.ell_width == DeviceGraph.from_graph(
        g, layout="dense", device=CPU).ell_width

    # tuned vs cold answers: same query, within the sliced tolerance
    x = torch.from_numpy(np.random.default_rng(3).random(
        (3, g.n), dtype=np.float32))
    y_t = ref.ell_spmm_sliced_ref(dg.in_neighbors, dg.in_mask, x,
                                  dg.in_weights, None, dg.in_row_map)
    y_c = ref.ell_spmm_sliced_ref(cold.in_neighbors, cold.in_mask, x,
                                  cold.in_weights, None, cold.in_row_map)
    np.testing.assert_allclose(y_t.numpy(), y_c.numpy(), rtol=1e-4,
                               atol=1e-6 * float(y_c.abs().max()))
    params = ForaParams(alpha=0.2, epsilon=0.5)
    res_t = fora_fused(dg, np.array([0, 5]), params, 0, num_walks=1024,
                       device=CPU)
    res_c = fora_fused(cold, np.array([0, 5]), params, 0, num_walks=1024,
                       device=CPU)
    np.testing.assert_allclose(res_t.pi.numpy(), res_c.pi.numpy(), atol=1e-4)


def test_cache_for_another_backend_is_cold():
    g = _powerlaw_graph(120, 3)
    cold = DeviceGraph.from_graph(g, layout="sliced", device=CPU)
    cache = TuningCache()
    cache.record("cuda", "sliced", shape_bucket(g.n, g.m),
                 TunedConfig(pad_multiple=16, width=cold.ell_width * 2))
    autotune.set_cache(cache)
    dg = DeviceGraph.from_graph(g, layout="sliced", device=CPU)
    assert dg.ell_width == cold.ell_width


def test_tuned_lookup_happens_at_build_time_only(monkeypatch):
    """The cache is read when the residency is built; the query itself
    never looks it up, and clearing the cache leaves a built residency as
    it is."""
    g = _powerlaw_graph(120, 5)
    autotune.set_cache(_tuned(g, pad_multiple=8, width=8, device_us=1.0))
    dg = DeviceGraph.from_graph(g, layout="sliced", device=CPU)
    assert dg.ell_width == 8

    def no_lookup():
        raise AssertionError("tuning cache read during a query")

    monkeypatch.setattr(autotune, "get_cache", no_lookup)
    params = ForaParams(alpha=0.2, epsilon=0.5)
    res = fora_fused(dg, np.array([3, 9]), params, 1, num_walks=1024,
                     device=CPU)
    assert np.allclose(res.pi.sum(dim=1).numpy(), 1.0, atol=1e-3)
    monkeypatch.undo()
    autotune.clear_cache()
    assert dg.ell_width == 8


def test_device_mirror_follows_the_cache_set_before_upload():
    """A cache set before the first upload shapes ``Graph.device``'s
    mirror; one set afterwards that changes this graph's entry makes the
    next call build a new mirror and leaves the old object as it was."""
    g = _powerlaw_graph(120, 7)
    cold_w = DeviceGraph.from_graph(g, layout="auto", device=CPU).ell_width
    tuned_w = cold_w * 2
    autotune.set_cache(_tuned(g, pad_multiple=8, width=tuned_w))
    g2 = _powerlaw_graph(120, 7)
    assert g2.device(CPU).ell_width == tuned_w

    before = DeviceGraph.uploads
    first = g.device(CPU)
    assert first.ell_width == tuned_w
    assert g.device(CPU) is first and DeviceGraph.uploads == before + 1
    autotune.set_cache(None)
    rebuilt = g.device(CPU)
    assert rebuilt is not first and DeviceGraph.uploads == before + 2
    assert rebuilt.ell_width == cold_w and first.ell_width == tuned_w
    assert g.device(CPU) is rebuilt
    autotune.set_cache(_tuned(g, pad_multiple=8, width=tuned_w))
    assert g.device(CPU).ell_width == tuned_w


# ---------------------------------------------------------------------------
# measurement harness + sweeps


def test_measure_compiled_splits_first_call_from_steady_state():
    calls = []

    def f(a, b):
        calls.append(1)
        return torch.tanh(a) @ b

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.random((64, 64), dtype=np.float32))
    b = torch.from_numpy(rng.random((64, 64), dtype=np.float32))
    out, dev_us, comp_us = measure_compiled(f, a, b, repeats=3)
    assert len(calls) == 4                       # one first call + 3 timed
    torch.testing.assert_close(out, torch.tanh(a) @ b)
    assert dev_us > 0.0 and np.isfinite(dev_us)
    assert comp_us > 0.0
    with pytest.raises(ValueError, match="repeats"):
        measure_compiled(f, a, b, repeats=0)


def test_sweep_sliced_records_winner(tmp_path):
    g = _powerlaw_graph(96, 9)
    cache = TuningCache(path=tmp_path / "tune.json")
    trials: list = []
    best = sweep_sliced(g, B=2, pad_multiples=(8, 16), repeats=1,
                        device="cpu", cache=cache, trials=trials)
    assert [t.pad_multiple for t in trials] == [8, 16]
    assert [t.width for t in trials] == [g.sliced_ell_width(8),
                                         g.sliced_ell_width(16)]
    assert best == min(trials, key=lambda t: t.device_us)
    assert best.block_n == TunedConfig().block_n and best.device_us > 0.0
    assert cache.lookup("cpu", "sliced", shape_bucket(g.n, g.m)) == best
    cache.save()
    assert TuningCache.load(cache.path).entries == cache.entries
    with pytest.raises(ValueError, match="at least one"):
        sweep_sliced(g, pad_multiples=(), device="cpu")


def test_sweep_walk_records_and_seeds_the_cost_model():
    g = _powerlaw_graph(96, 9)
    cache = TuningCache()
    push = sweep_sliced(g, B=2, pad_multiples=(8,), repeats=1, device="cpu",
                        cache=cache)
    walk = sweep_walk(g, num_walks=256, num_steps=4, repeats=1,
                      device="cpu", cache=cache)
    assert walk.device_us > 0.0 and walk.pad_multiple is None
    bucket = shape_bucket(g.n, g.m)
    assert cache.lookup("cpu", "walk", bucket) == walk
    model = CacheAwareCostModel.seeded_from_tuning(cache, backend="cpu")
    assert model.walk_share == pytest.approx(
        walk.device_us / (walk.device_us + push.device_us))


def test_cli_smoke_then_expect_hit(tmp_path, capsys):
    path = str(tmp_path / "tune.json")
    assert autotune.main(["--cache", path, "--expect-hit",
                          "--device", "cpu", "--smoke"]) == 1
    assert "MISS" in capsys.readouterr().out
    assert autotune.main(["--cache", path, "--smoke", "--device",
                          "cpu"]) == 0
    out = capsys.readouterr().out
    assert "autotune: cpu|sliced|" in out and "wrote 2 entries" in out
    assert autotune.main(["--cache", path, "--smoke", "--expect-hit",
                          "--device", "cpu"]) == 0
    assert "HIT cpu|sliced|" in capsys.readouterr().out
    # the smoke graph is the JAX CLI's graph
    g = autotune.smoke_graph(512, 0)
    rng = np.random.default_rng(0)
    srcs, dsts = [], []
    for d in range(1, 512):
        deg = int(min(511, rng.zipf(1.8)))
        srcs.extend(rng.choice(512, size=deg, replace=False))
        dsts.extend([d] * deg)
    jg = jgraph.Graph.from_edges(512, np.asarray(srcs), np.asarray(dsts))
    np.testing.assert_array_equal(g.edge_src, jg.edge_src)
    np.testing.assert_array_equal(g.edge_dst, jg.edge_dst)


def test_cli_and_sweeps_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a box without a card, where the default device "
                    "must raise")
    g = _powerlaw_graph(64, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.main(["--cache", str(tmp_path / "t.json"), "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_sliced(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_walk(g)


# ---------------------------------------------------------------------------
# cost-model seeding


def _both(entries):
    port, jax_ = TuningCache(), jtune.TuningCache()
    for (be, lay, bkt), kw in entries.items():
        port.record(be, lay, bkt, TunedConfig(**kw))
        jax_.record(be, lay, bkt, jtune.TunedConfig(**kw))
    return port, jax_


@pytest.mark.parametrize("entries,kwargs", [
    ({("cpu", "sliced", "n512_d4"): dict(device_us=300.0, compile_us=9e6),
      ("cpu", "walk", "n512_d4"): dict(device_us=100.0, compile_us=9e6)},
     {}),
    ({("cpu", "sliced", "n512_d4"): dict(device_us=300.0),
      ("cpu", "dense", "n512_d4"): dict(device_us=200.0),
      ("cpu", "walk", "n512_d4"): dict(device_us=100.0),
      ("cpu", "sliced", "n4096_d8"): dict(device_us=77.24),
      ("cpu", "walk", "n4096_d8"): dict(device_us=512.0),
      ("cuda", "walk", "n512_d4"): dict(device_us=5.0)},
     {}),
    ({("cpu", "sliced", "n512_d4"): dict(device_us=300.0),
      ("cpu", "walk", "n512_d4"): dict(device_us=100.0),
      ("cpu", "sliced", "n4096_d8"): dict(device_us=77.24),
      ("cpu", "walk", "n4096_d8"): dict(device_us=512.0)},
     {"bucket": "n4096_d8"}),
    ({("cpu", "sliced", "n512_d4"): dict(device_us=300.0),
      ("cpu", "walk", "n512_d4"): dict(device_us=0.0)}, {}),
    ({("cpu", "sliced", "n512_d4"): dict(device_us=300.0)}, {}),
    ({("cpu", "sliced", "n512_d4"): dict(device_us=300.0),
      ("cpu", "walk", "n512_d4"): dict(device_us=100.0)},
     {"walk_share": 0.9}),
    ({("cpu", "sliced", "n512_d4"): dict(device_us=300.0),
      ("cpu", "walk", "n512_d4"): dict(device_us=100.0)},
     {"index_coverage": 0.25, "decay": 0.5}),
])
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_seeded_from_tuning_equals_jax(entries, kwargs, backend):
    port, jax_ = _both(entries)
    got = CacheAwareCostModel.seeded_from_tuning(port, backend=backend,
                                                 **kwargs)
    want = JCostModel.seeded_from_tuning(jax_, backend=backend, **kwargs)
    assert got.walk_share == want.walk_share
    assert (got.decay, got.max_trust, got.index_coverage) == \
        (want.decay, want.max_trust, want.index_coverage)


def test_seeded_from_tuning_prices_walk_share_and_cold():
    port, _ = _both({("cuda", "sliced", "n512_d4"): dict(device_us=300.0),
                     ("cuda", "walk", "n512_d4"): dict(device_us=100.0)})
    assert CacheAwareCostModel.seeded_from_tuning(
        port, backend="cuda").walk_share == pytest.approx(0.25)
    default = CacheAwareCostModel()
    assert CacheAwareCostModel.seeded_from_tuning(
        None).walk_share == default.walk_share
    assert CacheAwareCostModel.seeded_from_tuning(
        TuningCache(), backend="cuda").walk_share == default.walk_share
    assert CacheAwareCostModel.seeded_from_tuning(
        port, backend="cpu").walk_share == default.walk_share
