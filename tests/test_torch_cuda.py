"""The port's CUDA kernels on a card: each against its plain version, and
the fused query on the card against the same query on the CPU. Every test
here needs an NVIDIA card and ``nvcc`` and skips without them; this file
imports neither JAX nor ``repro``, so it runs where only torch is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ell_spmv, ref
from repro_torch.ppr import (ForaExecutor, ForaParams, PprWorkload,
                             TableDraws, fora_fused, load, small_test_graph,
                             walk_length_for_tail)

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
