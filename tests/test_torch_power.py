"""Port parity of K4 and exact PPR: the plain one-vector SpMV against the
JAX package's Pallas kernel (interpret mode) over its sweep, the push
relaxation it computes, the dispatch on the CPU, and the power iteration
and single-pair query against the JAX package's, on a dense graph (whose
steps reach ``ops.ell_spmv``) and a sliced one (whose steps stay on the COO
loop)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ppr as jppr
import repro_torch.ppr as tppr
from repro.kernels.ell_spmv import ell_spmv_pallas
from repro_torch.kernels import ops, ref
from repro_torch.ppr import power_iteration as tpi

# test_kernels.py::test_ell_spmv_sweep's shapes
SWEEP = [(64, 4, 32), (100, 7, 64), (512, 16, 256), (300, 130, 128),
         (1000, 33, 512)]
SOURCES = np.array([0, 7, 42])


def _close(got, want, rtol=1e-5):
    """|got - want| <= rtol |want| + 1e-6 max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * float(np.abs(want).max()))


def _sweep_inputs(n, K, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, (n, K)).astype(np.int32),
            rng.random((n, K)) < 0.7,
            rng.standard_normal((n, K)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("n,K,block_n", SWEEP)
def test_ell_spmv_ref_matches_pallas(n, K, block_n):
    nbr, msk, w, x = _sweep_inputs(n, K, seed=n + K)
    want = ell_spmv_pallas(jnp.asarray(nbr), jnp.asarray(msk),
                           jnp.asarray(w), jnp.asarray(x), block_n=block_n)
    got = ref.ell_spmv_ref(torch.from_numpy(nbr), torch.from_numpy(msk),
                           torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (n,) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want))


def test_ell_spmv_is_push_relaxation():
    """Over the in-neighbour table with w = 1/deg_out(src), the SpMV is
    P^T x (test_kernels.py::test_ell_spmv_is_push_relaxation), on the
    port's own table and the JAX package's kernel alike."""
    g = tppr.small_test_graph(n=48, avg_deg=4, seed=2)
    nbr, msk, w = g.ell_in()
    x = np.random.default_rng(0).random(g.n).astype(np.float32)
    contrib = x[g.edge_src] / np.maximum(g.out_degree, 1)[g.edge_src]
    expect = np.zeros(g.n, np.float32)
    np.add.at(expect, g.edge_dst, contrib)
    got = ops.ell_spmv(*(torch.from_numpy(a) for a in (nbr, msk, w)),
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-5)
    jax_got = ell_spmv_pallas(jnp.asarray(nbr), jnp.asarray(msk),
                              jnp.asarray(w), jnp.asarray(x))
    _close(got.numpy(), np.asarray(jax_got))


def test_ops_ell_spmv_on_cpu_is_the_plain_version():
    nbr, msk, w, x = _sweep_inputs(100, 7, seed=3)
    t = [torch.from_numpy(a) for a in (nbr, msk, w, x)]
    got = ops.ell_spmv(*t)
    assert torch.equal(got, ref.ell_spmv_ref(t[0], t[1], t[3], t[2]))
    # weights and x are cast to float32, as the JAX package casts them
    got64 = ops.ell_spmv(t[0], t[1], t[2].double(), t[3].double())
    assert got64.dtype == torch.float32 and torch.equal(got64, got)
    # a row whose mask is all false gives 0, whatever its weights
    t[1][5] = False
    assert float(ops.ell_spmv(*t)[5]) == 0.0


@pytest.fixture
def k4_calls(monkeypatch):
    """Counts the calls that reach ``ops.ell_spmv``, with x's shape and
    the row plan each passes."""
    calls = []
    plain = ops.ell_spmv

    def counting(*args, **kwargs):
        calls.append((args[3].shape, kwargs.get("plan")))
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "ell_spmv", counting)
    return calls


def test_power_iteration_dense_runs_through_ell_spmv(k4_calls):
    jg = jppr.small_test_graph(n=300)
    tg = tppr.small_test_graph(n=300)
    assert tg.device("cpu").layout == "dense"
    want = jppr.ppr_power_iteration(jg, SOURCES, alpha=0.2)
    got = tppr.ppr_power_iteration(tg, SOURCES, alpha=0.2, device="cpu")
    iters = tpi.default_iters(0.2)
    assert len(k4_calls) == iters * SOURCES.size
    assert {shape for shape, _ in k4_calls} == {(tg.n,)}
    # every step passes the residency's row plan, built once
    assert all(plan is tg.device("cpu").in_plan for _, plan in k4_calls)
    assert got.shape == (SOURCES.size, tg.n) and got.dtype == np.float32
    _close(got, want)
    # the COO loop computes the same rows
    coo = tpi.power_iteration_coo(tg, SOURCES, 0.2, iters,
                                  torch.device("cpu")).numpy()
    _close(got, coo)


def test_power_iteration_sliced_stays_on_coo(k4_calls):
    jg = jppr.load("web-stanford", scale=512)
    tg = tppr.load("web-stanford", scale=512)
    assert tg.device("cpu").layout == "sliced"
    want = jppr.ppr_power_iteration(jg, SOURCES, alpha=0.2)
    got = tppr.ppr_power_iteration(tg, SOURCES, alpha=0.2, device="cpu")
    assert k4_calls == []
    _close(got, want, rtol=1e-4)


@pytest.mark.parametrize("s,t", [(0, 0), (7, 42), (42, 299)])
def test_ppr_single_pair_matches_jax(s, t):
    jg = jppr.small_test_graph(n=300)
    tg = tppr.small_test_graph(n=300)
    want = jppr.ppr_single_pair(jg, s, t)
    row = jppr.ppr_power_iteration(jg, np.array([s]))[0]
    got = tppr.ppr_single_pair(tg, s, t, device="cpu")
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-5 * abs(want) + 1e-6 * float(row.max())


@pytest.mark.parametrize("alpha,tol", [(0.2, 1e-9), (0.15, 1e-6),
                                       (0.5, 1e-12)])
def test_default_iters_is_the_step_rule(alpha, tol):
    # one more than the least k with (1 - alpha)^k <= tol
    k = tpi.default_iters(alpha, tol) - 1
    assert (1 - alpha) ** k <= tol < (1 - alpha) ** (k - 1)
    if (alpha, tol) == (0.2, 1e-9):
        assert tpi.default_iters() == 94
    with pytest.raises(ValueError, match="alpha"):
        tpi.default_iters(0.0, tol)


def test_power_iteration_checks_alpha_and_device():
    g = tppr.small_test_graph(n=64)
    with pytest.raises(ValueError, match="alpha"):
        tppr.ppr_power_iteration(g, [0], alpha=1.0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tppr.ppr_single_pair(g, 0, 1)
