"""Port parity of the D&A core: the port's copy of Algorithms 1 and 2, the
sample sizes and the bounds give what ``repro.core`` gives on the same
seeded inputs; and the port's quickstart loop runs end to end on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import SimulatedTimeSource
from repro_torch import quickstart


def _executor():
    """A fresh seeded executor; each package gets its own instance."""
    source = SimulatedTimeSource(mean=0.5, cv=0.5, seed=7)
    return lambda ids: source.measure(ids)


def _same_result(t, j):
    for field in ("cores", "accepted", "deadline", "num_queries",
                  "preprocess_time", "ell", "scaling_factor", "attempts",
                  "log", "completion_time", "reduction_vs_lemma2_pct"):
        assert getattr(t, field) == getattr(j, field), field
    np.testing.assert_array_equal(t.sample_stats.times, j.sample_stats.times)
    assert t.plan.slots == j.plan.slots and t.plan.k == j.plan.k
    np.testing.assert_array_equal(t.execution.core_totals,
                                  j.execution.core_totals)
    assert t.execution.per_query_times == j.execution.per_query_times
    assert vars(t.bounds) == vars(j.bounds)


@pytest.mark.parametrize("X,T,s,d,cmax", [(200, 40.0, 20, 1.0, 64),
                                          (500, 60.0, 25, 0.8, 64),
                                          (64, 30.0, 16, 0.9, 8)])
def test_dna_real_same_result(X, T, s, d, cmax):
    kw = dict(sample_size=s, scaling_factor=d, seed=3)
    j = jcore.dna_real(X, T, _executor(), cmax, **kw)
    t = tcore.dna_real(X, T, _executor(), cmax, **kw)
    _same_result(t, j)


@pytest.mark.parametrize("X,T", [(300, 50.0), (40, 30.0)])
def test_dna_same_result(X, T):
    j = jcore.dna(X, T, _executor(), seed=1)
    t = tcore.dna(X, T, _executor(), seed=1)
    _same_result(t, j)
    assert vars(t.sample) == vars(j.sample)


def test_infeasible_deadline_raises_alike():
    for pkg in (jcore, tcore):
        with pytest.raises(pkg.InfeasibleDeadline, match="admission failed"):
            pkg.dna_real(400, 2.0, _executor(), 4, sample_size=10)


@pytest.mark.parametrize("ci", sorted(jcore.Z_TABLE) + [0.97])
def test_sample_sizes_and_bounds_same(ci):
    for pop in (None, 50, 10_000):
        assert vars(tcore.cochran_sample_size(ci, population=pop)) == \
            vars(jcore.cochran_sample_size(ci, population=pop))
    assert tcore.fraction_sample_size(333, 0.05) == \
        jcore.fraction_sample_size(333, 0.05)
    times = np.random.default_rng(int(ci * 1000)).lognormal(size=30)
    ts, js = tcore.RuntimeStats(times), jcore.RuntimeStats(times)
    assert (ts.t_max, ts.t_avg, ts.t_pre, ts.t_pre_on(4)) == \
        (js.t_max, js.t_avg, js.t_pre, js.t_pre_on(4))
    assert tcore.lemma2_hoeffding_bound(1000, 100.0, ts) == \
        jcore.lemma2_hoeffding_bound(1000, 100.0, js)


@pytest.mark.parametrize("t,n", [(0.22421063920637035, 3),
                                 (2.66749253410175, 47), (1.5, 8)])
def test_lemma2_equal_samples_mean_not_above_max(t, n):
    """Equal samples whose float mean rounds one ulp above them still give
    the Lemma 2 bound t_bar + slack with t_bar == t_hat == t."""
    stats = tcore.RuntimeStats(np.full(n, t))
    assert stats.t_avg == stats.t_max == t
    slack = np.sqrt(t * t * np.log(2 / 0.125) / (2 * n))
    assert tcore.lemma2_hoeffding_bound(10, 10 * t, stats, p_f=0.125) == \
        pytest.approx((10 / (10 * t)) * (t + slack), rel=1e-12)


def test_quickstart_runs_on_cpu():
    lines = []
    out = quickstart.run(scale=512, num_queries=16, device="cpu",
                         log=lines.append)
    assert out["accepted"] and out["cores"] >= 1
    assert out["layout"] == "sliced" and out["device"] == "cpu"
    assert out["fora_max_rel_err"] < 0.5
    assert out["per_query_ms_mean"] > 0
    assert any(line.startswith("D&A_REAL cores") for line in lines)


def test_quickstart_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.run(scale=512, num_queries=8)
