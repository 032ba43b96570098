"""The port's CUDA kernels on a card: each against its plain version, and
the fused query on the card against the same query on the CPU, with and
without the walk index. Every test
here needs an NVIDIA card and ``nvcc`` and skips without them; this file
imports neither JAX nor ``repro``, so it runs where only torch is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.index import WalkIndex
from repro_torch.kernels import ell_spmv, ref, walk_gather
from repro_torch.ppr import (ForaExecutor, ForaParams, LaneStreams,
                             PprWorkload, TableDraws, fora_fused, load,
                             small_test_graph, walk_length_for_tail)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", torch.cuda.current_device())


def _x(n: int, B: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = (rng.random((B, n)) ** 3).astype(np.float32)
    return torch.from_numpy(x / x.sum(axis=1, keepdims=True)).to(device)


@pytest.mark.parametrize("B", [1, 5, 33, 64])
def test_kernels_match_plain_and_repeat_bitwise(card, B):
    dense_g = small_test_graph(n=300, seed=2)
    dense = [torch.from_numpy(a).to(card) for a in dense_g.ell_in()]
    web = load("web-stanford", scale=64)
    sl = web.ell_in_sliced()
    pad = 4                                   # padding rows: row_map == n
    nbr = torch.from_numpy(np.concatenate(
        [sl.neighbors, np.zeros((pad, sl.width), np.int32)])).to(card)
    mask = torch.from_numpy(np.concatenate(
        [sl.mask, np.ones((pad, sl.width), bool)])).to(card)
    w = torch.from_numpy(np.concatenate(
        [sl.weights, np.ones((pad, sl.width), np.float32)])).to(card)
    rm = torch.from_numpy(np.concatenate(
        [sl.row_map, np.full(pad, web.n, np.int32)])).to(card)
    for g, tables in ((dense_g, dense), (web, (nbr, mask, w, rm))):
        x = _x(g.n, B, seed=B, device=card)
        for thr in (None, torch.quantile(x, 0.5).expand(g.n).contiguous()):
            # the plain version in float64 on the same inputs; both kernels
            # sum nonnegative terms in chains of at most ~100 float32 adds
            x64 = x.double()
            thr64 = None if thr is None else thr.double()
            if len(tables) == 3:
                got = ell_spmv.ell_spmm_cuda(*tables, x, thr)
                again = ell_spmv.ell_spmm_cuda(*tables, x, thr)
                want = ref.ell_spmm_ref(tables[0], tables[1], x64,
                                        tables[2].double(), thr64)
            else:
                got = ell_spmv.ell_spmm_sliced_cuda(*tables, x, thr)
                again = ell_spmv.ell_spmm_sliced_cuda(*tables, x, thr)
                want = ref.ell_spmm_sliced_ref(nbr, mask, x64, w.double(),
                                               thr64, rm)
            torch.testing.assert_close(
                got.double(), want, rtol=1e-5,
                atol=1e-6 * float(want.abs().max()))
            assert torch.equal(got, again)      # one summation order


def test_fora_fused_on_card_matches_cpu(card):
    g = load("web-stanford", scale=256)
    params = ForaParams(epsilon=0.5)
    W, B = 4096, 3
    L = walk_length_for_tail(params.alpha, params.walk_tail)
    rng = np.random.default_rng(0)
    starts = torch.from_numpy(rng.random((B, W), dtype=np.float32))
    steps = torch.from_numpy(rng.integers(0, 1 << 30, (L, B, W),
                                          dtype=np.int32))
    sources = [0, 17, 99]
    cpu = fora_fused(g.device("cpu"), sources, params, num_walks=W,
                     draws=TableDraws(starts, steps), device="cpu")
    ell_spmv.reset_launches()
    gpu = fora_fused(g.device(card), sources, params, num_walks=W,
                     draws=TableDraws(starts.to(card), steps.to(card)),
                     device=card)
    assert ell_spmv.LAUNCHES["ell_spmm_sliced"] >= int(gpu.push_iters) > 0
    assert int(gpu.push_iters) == int(cpu.push_iters)
    torch.testing.assert_close(gpu.walks_effective.cpu(), cpu.walks_effective)
    torch.testing.assert_close(gpu.residual_mass.cpu(), cpu.residual_mass,
                               rtol=1e-5, atol=1e-7)
    # the two cumsums of the residual differ in the last bits, so a walk
    # start can move at a CDF boundary: each moved walker shifts
    # r_sum / walks_effective (about 1e-5 here) between two entries
    diff = (gpu.pi.cpu() - cpu.pi).abs()
    assert float(diff.max()) < 1e-4 and float(diff.sum(dim=1).max()) < 1e-3


def test_executor_times_queries_on_card(card):
    ex = ForaExecutor(PprWorkload(load("web-stanford", scale=512), 8),
                      ForaParams(epsilon=0.5), block_size=2, device=card)
    stats = ex(list(range(8)))
    assert stats.n == 8 and (stats.times > 0).all()
    assert ex.device_graph.layout == "sliced"


@pytest.mark.parametrize("B,L", [(1, 1), (3, 130), (8, 4096), (1, 16384)])
@pytest.mark.parametrize("case", ["full", "retired", "hub"])
def test_walk_gather_matches_plain_and_repeats_bitwise(card, B, L, case):
    rng = np.random.default_rng(B * 7 + L)
    n, W = 2000, 16384
    table = rng.integers(0, n, (n, W), dtype=np.int32)
    if case == "hub":
        table[:] = 17                 # every lane ends at one node
    budget = np.full(n, W, np.int32)
    if case == "retired":
        rows = rng.choice(n, size=n // 3, replace=False)
        budget[rows] = rng.integers(0, W + 1, rows.size)
    starts = rng.integers(0, n, (B, L), dtype=np.int32)
    weights = rng.random((B, L), dtype=np.float32)
    args = [torch.from_numpy(a).to(card)
            for a in (table, budget, starts, weights)]
    got = walk_gather.walk_endpoint_gather_cuda(*args)
    again = walk_gather.walk_endpoint_gather_cuda(*args)
    # float64 plain version; the kernel sums each cell as a pairwise tree
    # (at most 11 levels) and adds at most L / 2048 tiles in order
    want = ref.walk_endpoint_gather_ref(*args[:3], args[3].double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, again)


def test_fora_fused_with_index_on_card_matches_cpu(card):
    g = load("web-stanford", scale=256)
    params = ForaParams(epsilon=0.5)
    W, B = 4096, 3
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.random((B, W), dtype=np.float32))
    steps = torch.zeros((1, B, W), dtype=torch.int32)
    kw = dict(width=1024, alpha=params.alpha, walk_tail=params.walk_tail,
              streams=LaneStreams(2))
    cpu_idx = WalkIndex.build(g.device("cpu"), **kw)
    gpu_idx = WalkIndex.build(g.device(card), **kw)
    assert torch.equal(gpu_idx.endpoints.cpu(), cpu_idx.endpoints)
    sources = [0, 17, 99]
    for retire in (False, True):
        if retire:                      # the partial branch
            for idx in (cpu_idx, gpu_idx):
                idx.retire(np.arange(0, g.n, 3), budget=300)
        cpu = fora_fused(g.device("cpu"), sources, params, num_walks=W,
                         draws=TableDraws(u, steps), index=cpu_idx,
                         device="cpu")
        walk_gather.reset_launches()
        gpu = fora_fused(g.device(card), sources, params, num_walks=W,
                         draws=TableDraws(u.to(card), steps.to(card)),
                         index=gpu_idx, device=card)
        assert walk_gather.LAUNCHES["walk_endpoint_gather"] == 1
        torch.testing.assert_close(gpu.walks_effective.cpu(),
                                   cpu.walks_effective)
        # as in test_fora_fused_on_card_matches_cpu: a start can move at a
        # CDF boundary, shifting r_sum / walks_effective between two cells
        diff = (gpu.pi.cpu() - cpu.pi).abs()
        assert float(diff.max()) < 1e-4
        assert float(diff.sum(dim=1).max()) < 1e-3


def test_executor_with_walk_index_on_card(card):
    ex = ForaExecutor(PprWorkload(small_test_graph(n=500), 8),
                      ForaParams(epsilon=0.5), index_budget=1 << 13,
                      device=card)
    walk_gather.reset_launches()
    stats = ex(list(range(8)))
    assert stats.n == 8 and (stats.times > 0).all()
    assert ex.index_coverage == 1.0
    assert ex.walk_index.device == card
    assert walk_gather.LAUNCHES["walk_endpoint_gather"] >= 8
