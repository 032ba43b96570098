"""The dense table's row plan (K1 and K4 read each row's cells up to its
live extent, with lanes a row chosen from the extents), K1's frontier
route rule, and the plan's path through the residency, the push and the
power iteration. The extent builder is held against a numpy reference; on
the CPU the plain versions ignore the plan, so the push and the power
iteration give the same bits with or without it, and the plain version
with a plan equals the JAX package's Pallas kernel in interpret mode on
non-left-packed masks. The CUDA kernels are held to the plan on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ell_spmv import ell_spmm_pallas, ell_spmv_pallas
from repro.ppr.datasets import small_test_graph as jax_small_test_graph
from repro_torch.kernels import ell_spmv, ops
from repro_torch.ppr import (forward_push, ppr_power_iteration,
                             small_test_graph)
from repro_torch.ppr import graph as tgraph
from repro_torch.ppr.forward_push import one_hot_seeds


def _extent_np(mask: np.ndarray) -> np.ndarray:
    """1 + the last live column of each row, 0 for a row with none."""
    K = mask.shape[1]
    last = K - 1 - np.argmax(mask[:, ::-1], axis=1)
    return np.where(mask.any(axis=1), last + 1, 0).astype(np.int32)


def _lanes_np(extent: np.ndarray, K: int) -> int:
    vec = ell_spmv.DENSE_VEC if K % ell_spmv.DENSE_VEC == 0 else 1
    units = -(-extent // vec)
    mean = units[units > 0].mean() if (units > 0).any() else 1.0
    lanes = 1
    while lanes < min(mean, 32):
        lanes *= 2
    return lanes


def _mask(case: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if case == "random":                  # not left-packed
        m = rng.random((97, 13)) < 0.4
        m[3] = False
        m[5] = False
        m[5, 12] = True                   # only the last column live
        return m
    if case == "graph":
        return small_test_graph(n=300, seed=4).ell_in()[1]
    if case == "empty rows":
        m = rng.random((64, 16)) < 0.3
        m[::3] = False
        return m
    if case == "all false":
        return np.zeros((40, 8), bool)
    if case == "K=1":
        return rng.random((50, 1)) < 0.5
    if case == "wide":
        return rng.random((30, 130)) < 0.9
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "graph", "empty rows",
                                  "all false", "K=1", "wide"])
def test_dense_plan_extents_match_numpy(case):
    mask = _mask(case)
    plan = ell_spmv.dense_plan(torch.from_numpy(mask))
    want = _extent_np(mask)
    assert plan.extent.dtype == torch.int32 and plan.extent.is_contiguous()
    np.testing.assert_array_equal(plan.extent.numpy(), want)
    assert plan.width == mask.shape[1]
    assert plan.lanes == _lanes_np(want, mask.shape[1])
    assert plan.lanes & (plan.lanes - 1) == 0 and 1 <= plan.lanes <= 32
    if case == "graph":                   # ell_in is left-packed
        np.testing.assert_array_equal(want, mask.sum(axis=1))
    # no live cell lies at or past a row's extent
    cols = np.arange(mask.shape[1])[None]
    assert not (mask & (cols >= want[:, None])).any()


def test_dense_plan_rejects_what_is_not_a_mask():
    with pytest.raises(ValueError, match="bool"):
        ell_spmv.dense_plan(torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="bool"):
        ell_spmv.dense_plan(torch.zeros((4, 0), dtype=torch.bool))


@pytest.mark.parametrize("n,B,group", [
    (2000, 1, 0), (2000, 3, 0),
    (ell_spmv.FRONTIER_MIN_N - 1, 1, 0), (ell_spmv.FRONTIER_MIN_N, 1, 1),
    (ell_spmv.FRONTIER_MIN_N, 2, 0),
    (524_288, 1, 1), (524_289, 1, 2),
    (1_632_803, 1, 4), (1_632_803, 4, 0),
    (2_097_152, 1, 4), (2_097_153, 1, 0)])
def test_frontier_route_is_picked_from_n_and_B(n, B, group):
    got = ell_spmv.frontier_group(n, B)
    assert got == group
    if got:
        assert got == ell_spmv.bitmap_group(n)
        assert -(-n // got) <= ell_spmv.FRONTIER_BYTES * 8


@pytest.mark.parametrize("n,group", [(1, 1), (2000, 1), (524_288, 1),
                                     (524_289, 2), (1_048_577, 4),
                                     (2_097_152, 4), (2_097_153, 0)])
def test_bitmap_group_is_the_least_that_fits(n, group):
    got = ell_spmv.bitmap_group(n)
    assert got == group
    if got:
        assert -(-n // got) <= ell_spmv.FRONTIER_BYTES * 8
        assert got == 1 or -(-n // (got // 2)) > ell_spmv.FRONTIER_BYTES * 8


def test_device_graph_builds_the_plan_once_for_dense_tables():
    g = small_test_graph(n=500, seed=5)
    before = tgraph.DeviceGraph.uploads
    dg = g.device("cpu")
    assert tgraph.DeviceGraph.uploads == before + 1
    assert dg.layout == "dense" and dg.in_fold is None
    np.testing.assert_array_equal(dg.in_plan.extent.numpy(),
                                  _extent_np(dg.in_mask.numpy()))
    assert dg.in_plan.width == dg.ell_width
    # the same residency, and plan, on the next call
    assert g.device("cpu").in_plan is dg.in_plan
    assert tgraph.DeviceGraph.uploads == before + 1
    sliced = tgraph.DeviceGraph.from_graph(g, layout="sliced", device="cpu")
    assert sliced.in_plan is None and sliced.in_fold is not None


def test_from_arrays_builds_the_plan_from_the_mask():
    jg = jax_small_test_graph(n=400, seed=6)
    from repro.ppr import graph as jgraph

    jdg = jgraph.DeviceGraph.from_graph(jg, layout="dense")
    arrays = {f: np.asarray(getattr(jdg, f))
              for f in tgraph.DeviceGraph.ARRAY_FIELDS
              if getattr(jdg, f) is not None}
    carried = tgraph.DeviceGraph.from_arrays(arrays, device="cpu")
    own = small_test_graph(n=400, seed=6).device("cpu")
    assert torch.equal(carried.in_plan.extent, own.in_plan.extent)
    assert carried.in_plan.lanes == own.in_plan.lanes


def test_push_and_power_iteration_give_the_same_bits_with_the_plan():
    g = small_test_graph(n=600, seed=8)
    dg = g.device("cpu")
    seeds = one_hot_seeds([0, 11, 99], g.n, dg.device)
    args = (dg.in_neighbors, dg.in_mask, dg.in_weights, dg.out_degree, seeds)
    kw = dict(alpha=0.2, rmax=1e-4)
    with_plan = forward_push(*args, plan=dg.in_plan, **kw)
    without = forward_push(*args, **kw)
    for a, b in zip(with_plan, without):
        assert torch.equal(a, b)
    x = torch.rand(g.n, generator=torch.Generator().manual_seed(1))
    assert torch.equal(
        ops.ell_spmv(dg.in_neighbors, dg.in_mask, dg.in_weights, x,
                     plan=dg.in_plan),
        ops.ell_spmv(dg.in_neighbors, dg.in_mask, dg.in_weights, x))
    rows = ppr_power_iteration(g, np.array([0, 11]), device="cpu", iters=20)
    assert rows.shape == (2, g.n) and np.isfinite(rows).all()


@pytest.mark.parametrize("B,fused", [(1, True), (3, False), (4, True)])
def test_plain_version_with_a_plan_matches_pallas_on_unpacked_masks(B, fused):
    """The plain version given a plan is the same function as the JAX
    package's Pallas kernels (interpret mode) on a mask that is not
    left-packed; the plan only tells the CUDA kernels where rows end."""
    rng = np.random.default_rng(B)
    n, K = 90, 12
    nbr = rng.integers(0, n, (n, K)).astype(np.int32)
    mask = rng.random((n, K)) < 0.5
    mask[4] = False
    w = rng.random((n, K)).astype(np.float32)
    x = (rng.random((B, n)) ** 3).astype(np.float32)
    thr = np.full(n, np.quantile(x, 0.5), np.float32)
    tn, tm, tw, tx, tthr = (torch.from_numpy(a) for a in
                            (nbr, mask, w, x, thr))
    plan = ell_spmv.dense_plan(tm)
    got = ops.ell_spmm(tn, tm, tw, tx, threshold=tthr if fused else None,
                       plan=plan).numpy()
    want = np.asarray(ell_spmm_pallas(
        jnp.asarray(nbr), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(x),
        jnp.asarray(thr) if fused else None, block_n=32, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    got4 = ops.ell_spmv(tn, tm, tw, tx[0], plan=plan).numpy()
    want4 = np.asarray(ell_spmv_pallas(
        jnp.asarray(nbr), jnp.asarray(mask), jnp.asarray(w),
        jnp.asarray(x[0]), block_n=32, interpret=True))
    np.testing.assert_allclose(got4, want4, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want4).max()))


def test_wrappers_check_the_plan_against_the_table():
    mask = torch.from_numpy(_mask("random"))
    plan = ell_spmv.dense_plan(mask)
    assert ell_spmv._check_plan(None, mask).lanes == plan.lanes
    assert ell_spmv._check_plan(plan, mask) is plan
    with pytest.raises(ValueError, match="plan is for width"):
        ell_spmv._check_plan(plan, mask[:, :5])
    with pytest.raises(ValueError, match="plan is for width"):
        ell_spmv._check_plan(plan._replace(extent=plan.extent.long()), mask)
    with pytest.raises(ValueError, match="power of two"):
        ell_spmv._check_plan(plan._replace(lanes=3), mask)
