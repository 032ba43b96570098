"""Port parity of pure Monte Carlo PPR and the batched residual walks on
the CPU: ``source_walks`` on the JAX package's draws (a stop uniform and a
next draw a step) reaches the same endpoints, ``monte_carlo_ppr`` and
``residual_walks_batched`` give the same rows, and the live endpoint
fold's plain version is the JAX package's ``segment_sum``."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ppr as jppr
import repro.ppr.random_walk as jrw
import repro_torch.ppr as tppr
import repro_torch.ppr.random_walk as trw
from repro_torch.kernels import endpoint_fold, ops, ref

SOURCES = np.array([0, 7, 42])


@pytest.fixture(scope="module")
def graphs():
    return (jppr.small_test_graph(n=200, avg_deg=8, seed=1),
            tppr.small_test_graph(n=200, avg_deg=8, seed=1))


def _source_draws(keys, W: int, L: int) -> trw.TableSourceDraws:
    """The draws the JAX package's ``source_walks`` makes from each of
    ``keys`` (one a source): split into L step keys, each split into a stop
    and a next key."""
    stops, nexts = [], []
    for key in keys:
        s, x = [], []
        for k in jax.random.split(key, L):
            k_stop, k_next = jax.random.split(k)
            s.append(np.asarray(jax.random.uniform(k_stop, (W,))))
            x.append(np.asarray(jax.random.randint(k_next, (W,), 0, 1 << 30)))
        stops.append(np.stack(s))
        nexts.append(np.stack(x))
    return trw.TableSourceDraws(torch.from_numpy(np.stack(stops, axis=1)),
                                torch.from_numpy(np.stack(nexts, axis=1)))


def _jax_source_endpoints(g, source: int, key, *, alpha: float, W: int,
                          L: int) -> np.ndarray:
    """The endpoints of ``repro.ppr.random_walk.source_walks``: its step
    loop, with the JAX package's own transition and draws."""
    edge_dst = jnp.asarray(g.edge_dst)
    offsets = jnp.asarray(g.out_offsets)
    deg = jnp.maximum(jnp.asarray(g.out_degree), 1).astype(jnp.int32)

    def step(carry, step_key):
        pos, alive = carry
        k_stop, k_next = jax.random.split(step_key)
        stop = jax.random.uniform(k_stop, (W,)) < alpha
        u_next = jax.random.randint(k_next, (W,), 0, 1 << 30)
        nxt = edge_dst[offsets[pos] + (u_next % deg[pos])]
        alive = jnp.logical_and(alive, jnp.logical_not(stop))
        return (jnp.where(alive, nxt, pos), alive), None

    init = (jnp.full((W,), source, jnp.int32), jnp.ones(W, bool))
    (pos, _), _ = jax.lax.scan(step, init, jax.random.split(key, L))
    return np.asarray(pos)


@pytest.mark.parametrize("W", [256, 4096])
def test_source_walk_endpoints_equal_jax_on_its_draws(graphs, W):
    jg, tg = graphs
    alpha, L = 0.2, jrw.walk_length_for_tail(0.2)
    keys = jax.random.split(jax.random.PRNGKey(4), SOURCES.size)
    dg = tg.device("cpu")
    draws = _source_draws(keys, W, L)
    pos = trw.source_walk_endpoints(
        dg.edge_dst, dg.out_offsets, dg.out_degree,
        torch.from_numpy(SOURCES), draws, alpha=alpha, num_walks=W,
        num_steps=L)
    mass = trw.source_walks(dg.edge_dst, dg.out_offsets, dg.out_degree,
                            torch.from_numpy(SOURCES), draws, alpha=alpha,
                            n=tg.n, num_walks=W, num_steps=L)
    for b, (s, k) in enumerate(zip(SOURCES, keys)):
        want = _jax_source_endpoints(jg, int(s), k, alpha=alpha, W=W, L=L)
        np.testing.assert_array_equal(pos[b].numpy(), want)
        # W a power of two: the shares k / W add exactly, in any order
        jmass = jrw.source_walks(
            jnp.asarray(jg.edge_dst), jnp.asarray(jg.out_offsets),
            jnp.asarray(jg.out_degree), int(s), k, alpha=alpha, n=jg.n,
            num_walks=W, num_steps=L)
        np.testing.assert_array_equal(mass[b].numpy(), np.asarray(jmass))


@pytest.mark.parametrize("num_walks", [None, 2048])
def test_monte_carlo_ppr_matches_jax_on_its_draws(graphs, num_walks):
    jg, tg = graphs
    params = jppr.ForaParams(epsilon=0.5)
    rp = params.resolve(jg)
    W = num_walks or int(min(rp.max_walks, math.ceil(rp.omega)))
    key = jax.random.PRNGKey(2)
    want = jppr.monte_carlo_ppr(jg, SOURCES, params, key,
                                num_walks=num_walks)
    L = jrw.walk_length_for_tail(rp.alpha, rp.walk_tail)
    draws = _source_draws(jax.random.split(key, SOURCES.size), W, L)
    got = tppr.monte_carlo_ppr(tg, SOURCES, tppr.ForaParams(epsilon=0.5),
                               num_walks=num_walks, draws=draws,
                               device="cpu")
    assert got.shape == want.shape == (SOURCES.size, tg.n)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def test_monte_carlo_ppr_on_its_own_generators(graphs):
    _, tg = graphs
    params = tppr.ForaParams(epsilon=0.5)
    a = tppr.monte_carlo_ppr(tg, SOURCES, params, seed=3, device="cpu")
    b = tppr.monte_carlo_ppr(tg, SOURCES, params, seed=3, device="cpu")
    c = tppr.monte_carlo_ppr(tg, SOURCES, params, seed=4, device="cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    np.testing.assert_allclose(a.sum(axis=1), 1.0, atol=1e-4)
    exact = jppr.ppr_power_iteration(jppr.small_test_graph(
        n=200, avg_deg=8, seed=1), SOURCES, alpha=0.2)
    big = exact >= 1.0 / tg.n
    assert float((np.abs(a - exact)[big] / exact[big]).max()) < 0.5


def test_residual_walks_batched_matches_jax_on_its_draws(graphs):
    jg, tg = graphs
    rp = jppr.ForaParams(epsilon=0.5).resolve(jg)
    push = jppr.forward_push_np(jg, SOURCES, alpha=rp.alpha, rmax=rp.rmax)
    residual = np.array(push.r)
    W, L = 1024, jrw.walk_length_for_tail(0.2)
    key = jax.random.PRNGKey(6)
    want = jrw.residual_walks_batched(jg, residual, key, alpha=0.2,
                                      num_walks=W)
    u, us = [], []
    for k in jax.random.split(key, SOURCES.size):
        k_start, k_walk = jax.random.split(k)
        u.append(np.asarray(jax.random.uniform(k_start, (W,))))
        us.append(np.asarray(jax.random.randint(k_walk, (L, W), 0, 1 << 30)))
    draws = trw.TableDraws(torch.from_numpy(np.stack(u)),
                           torch.from_numpy(np.stack(us, axis=1)))
    got = tppr.residual_walks_batched(tg, torch.from_numpy(residual), draws,
                                      alpha=0.2, num_walks=W, device="cpu")
    assert got.walks == want.walks == W
    np.testing.assert_allclose(got.endpoint_mass.numpy(),
                               np.asarray(want.endpoint_mass), rtol=1e-5,
                               atol=1e-7)
    one = tppr.residual_walks_batched(tg, torch.from_numpy(residual[0]),
                                      alpha=0.2, num_walks=W, device="cpu")
    assert one.endpoint_mass.shape == (1, tg.n)
    np.testing.assert_allclose(float(one.endpoint_mass.sum()),
                               float(residual[0].sum()), rtol=1e-5)


@pytest.mark.parametrize("B,W,n", [(1, 1, 5), (3, 100, 10), (2, 5000, 300)])
def test_endpoint_fold_plain_is_jax_segment_sum(B, W, n):
    rng = np.random.default_rng(B + W)
    pos = rng.integers(0, n, (B, W), dtype=np.int32)
    w = rng.random((B, W), dtype=np.float32)
    w[:, W // 2:] = 0.0                       # lanes past the active walks
    want = np.stack([np.asarray(jax.ops.segment_sum(
        jnp.asarray(w[b]), jnp.asarray(pos[b]), num_segments=n))
        for b in range(B)])
    got = ops.endpoint_fold(torch.from_numpy(pos), torch.from_numpy(w), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # the plain version adds a row's lanes in lane order
    loop = np.zeros((B, n), np.float32)
    for b in range(B):
        for i in range(W):
            loop[b, pos[b, i]] += w[b, i]
    np.testing.assert_array_equal(
        ref.endpoint_fold_ref(torch.from_numpy(pos), torch.from_numpy(w),
                              n).numpy(), loop)


def test_endpoint_fold_shape_and_wrapper_checks():
    # (scale_rows blocks a row, ceil(log2 W))
    assert endpoint_fold.fold_scratch(281_903, 1 << 20) == (256, 20)
    assert endpoint_fold.fold_scratch(281_903, 1 << 22) == (256, 22)
    assert endpoint_fold.fold_scratch(5, 1) == (1, 0)
    assert endpoint_fold.fold_scratch(2000, 9000) == (3, 14)
    with pytest.raises(ValueError):
        endpoint_fold.fold_scratch(0, 4)
    pos = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        endpoint_fold.endpoint_fold_cuda(pos, torch.ones(1, 4), 3)


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (3, 300), (2, 4097)])
def test_start_cdf_scan_adds_in_a_fixed_order(shape):
    """The card's start CDF (a Hillis-Steele scan) is a cumulative sum; on
    the CPU the walks keep ``torch.cumsum``, which adds in order."""
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(rng.random(shape, dtype=np.float32) ** 3)
    got = trw.scan_prefix_sums(x)
    want = torch.cumsum(x.double(), dim=-1)
    torch.testing.assert_close(got.double(), want, rtol=1e-6,
                               atol=1e-7 * float(want.abs().max()))
    assert torch.equal(trw.cumulative_residual(x), torch.cumsum(x, dim=-1))
    # a strided view scans as its contiguous copy does
    assert torch.equal(trw.scan_prefix_sums(x.t().contiguous().t()), got)
