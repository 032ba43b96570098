"""The port's CUDA kernels on a card: each against its plain version, the
fused query on the card against the same query on the CPU, with and
without the walk index, exact PPR through K4 against the COO loop, the
model serving paths (K5, K6; the five LMs, two of them mixture-of-experts,
and DIN) on the card against the same paths on the CPU, the MoE
feed-forward (no host sync, bits repeating), the live endpoint fold, the continuous-batching engine, Monte Carlo
PPR, a dynamic graph's residency on the card, and the node-sharded
residency's kernels and queries on one card, the GNNs' segment
reduction against its float64 plain version and the four GNNs' forward
on the card against the CPU, and K5's backward against its float64 plain
version with DIN's train step on the card against the CPU. Every test
here needs an NVIDIA card and ``nvcc`` and skips without them; this file
imports neither JAX nor ``repro``, so it runs where only torch is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.index import WalkIndex
from repro_torch.dyn import DynamicGraph, MutationLog
from repro_torch.kernels import (embedding_bag, ell_spmv, endpoint_fold,
                                 flash_attention, ops, ref, segment_reduce,
                                 walk_gather)
from repro_torch.models import moe
from repro_torch.ppr import (DeviceMesh, ForaExecutor, ForaParams,
                             LaneStreams, PprWorkload, ShardedDeviceGraph,
                             TableDraws, fora_fused, load,
                             monte_carlo_ppr, ppr_power_iteration,
                             ppr_single_pair, small_test_graph,
                             walk_length_for_tail)
from repro_torch.serving import QueryEngine
from repro_torch.ppr.graph import Graph
from repro_torch.ppr.power_iteration import (default_iters,
                                             power_iteration_coo)

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
    # float64 plain version; the kernel sums each cell in lane order within
    # 32-lane chunks, chunks within groups of 32, groups in order: at most
    # 31 roundings a level
    want = ref.walk_endpoint_gather_ref(*args[:3], args[3].double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, again)


def _edge_rows_graph() -> Graph:
    """A graph whose width-8 sliced table has every kind of row K2 folds:
    rows without a slice, rows of 1 to 32 slices (rows 100..355 take 1 to
    256 in-edges), and a hub of 3,000 slices, far past a warp item's 32."""
    rng = np.random.default_rng(11)
    n = 30_000
    hub_src = rng.choice(n, size=24_000, replace=False)
    rows = np.arange(100, 356)
    ramp_src = np.concatenate([rng.choice(n, size=r - 99, replace=False)
                               for r in rows])
    ramp_dst = np.repeat(rows, rows - 99)
    tail_src = rng.integers(0, n, 40_000)
    tail_dst = rng.integers(20_000, n, 40_000)     # rows below stay bare
    return Graph.from_edges(
        n, np.concatenate([hub_src, ramp_src, tail_src]),
        np.concatenate([np.full(hub_src.size, 7), ramp_dst, tail_dst]))


@pytest.mark.parametrize("B", [1, 3, 5, 33, 64])
def test_sliced_spmm_edge_rows_match_plain_and_repeat_bitwise(card, B):
    g = _edge_rows_graph()
    sl = g.ell_in_sliced(width=8)
    pad = 5                                   # padding rows: row_map == n
    nbr = torch.from_numpy(np.concatenate(
        [sl.neighbors, np.zeros((pad, 8), np.int32)])).to(card)
    mask = torch.from_numpy(np.concatenate(
        [sl.mask, np.ones((pad, 8), bool)])).to(card)
    w = torch.from_numpy(np.concatenate(
        [sl.weights, np.ones((pad, 8), np.float32)])).to(card)
    rm = torch.from_numpy(np.concatenate(
        [sl.row_map, np.full(pad, g.n, np.int32)])).to(card)
    fold = ell_spmv.sliced_fold(rm, g.n, 8)
    slices = np.diff(fold.row_ptr.cpu().numpy())
    assert slices.min() == 0 and slices.max() == 3000
    assert fold.hubs.tolist() == [7] and fold.hub_items == 94
    assert set(range(1, 33)) <= set(slices.tolist())
    xT = _x(g.n, B, seed=B, device=card).t().contiguous()
    thr = torch.quantile(xT, 0.5).expand(g.n).contiguous()
    # x as the push passes it (an (n, B) tensor's transpose), and as a
    # (B, n) tensor, which the kernel's first pass lays out
    for x in (xT.t(), xT.t().contiguous()):
        for th in (None, thr):
            got = ell_spmv.ell_spmm_sliced_cuda(nbr, mask, w, rm, x, th, fold)
            again = ell_spmv.ell_spmm_sliced_cuda(nbr, mask, w, rm, x, th)
            want = ref.ell_spmm_sliced_ref(
                nbr, mask, x.double(), w.double(),
                None if th is None else th.double(), rm)
            torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                       atol=1e-6 * float(want.abs().max()))
            assert torch.equal(got, again)


@pytest.mark.parametrize("shape", ["dense", "paper"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("case", ["full", "retired", "hub", "range edges"])
def test_walk_gather_at_index_path_shapes(card, shape, B, case):
    """K3 at the index paths' shapes: the dense path's (n = 2,000, L =
    32,768) and the paper path's (n = 281,903, L = 4,096)."""
    n, W = (2000, 1 << 15) if shape == "dense" else (281_903, 1 << 12)
    gen = torch.Generator(device=card).manual_seed(B * 31 + len(case))
    table = torch.randint(0, n, (n, W), generator=gen, device=card,
                          dtype=torch.int32)
    budget = torch.full((n,), W, dtype=torch.int32, device=card)
    if case == "retired":
        rows = torch.randperm(n, generator=gen, device=card)[:n // 3]
        budget[rows] = torch.randint(0, W + 1, (rows.numel(),), generator=gen,
                                     device=card, dtype=torch.int32)
    elif case == "hub":
        table.fill_(n // 2)                   # every lane ends at one node
    elif case == "range edges":
        # endpoints on the first and last cells of the fold blocks' ranges
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        cells, blocks = walk_gather.fold_plan(n, B, sms)
        edges = torch.tensor(sorted({0, n - 1} | {
            e for k in range(blocks) for e in (k * cells, k * cells - 1,
                                               (k + 1) * cells - 1)
            if 0 <= e < n}), dtype=torch.int32, device=card)
        pick = torch.randint(0, edges.numel(), (n, W), generator=gen,
                             device=card)
        table = edges[pick]
        del pick
    starts = torch.randint(0, n, (B, W), generator=gen, device=card,
                           dtype=torch.int32)
    weights = torch.rand((B, W), generator=gen, device=card)
    args = (table, budget, starts, weights)
    got = walk_gather.walk_endpoint_gather_cuda(*args)
    again = walk_gather.walk_endpoint_gather_cuda(*args)
    want = ref.walk_endpoint_gather_ref(table, budget, starts,
                                        weights.double())
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


# K6: tests/test_kernels.py's sweep, gemma-2b's MQA at Dh 256, Dh 8, and
# more of route A's edges (GQA chunked prefill with Skv off the key tile,
# MHA non-causal at Dh 16, 72 rows at an offset) and route B's (56 rows in
# bf16). Beside each shape, the route its bf16 call takes; float32 always
# takes route B ("split"). Route A ("mma") cases: rows (Sq * Hq / Hkv) off
# the 64-row tile (200, 74, 560, 72), Skv off the key tile (100, 53, 300,
# 77, 130), chunked prefill (Sq > 1, q_offset > 0), non-causal, GQA and
# MHA, Dh 16 and 256.
ATTN_SHAPES = [(1, 128, 128, 2, 2, 64, True, 0, "mma"),
               (2, 100, 100, 4, 2, 32, True, 0, "mma"),
               (1, 1, 256, 4, 1, 64, True, 255, "split"),
               (2, 64, 192, 8, 8, 128, False, 0, "mma"),
               (1, 37, 53, 2, 1, 16, True, 16, "mma"),
               (2, 70, 300, 8, 1, 256, True, 230, "mma"),
               (1, 1, 1100, 8, 1, 256, True, 1050, "split"),
               (2, 33, 33, 8, 8, 8, True, 0, "split"),
               (3, 24, 77, 8, 2, 128, True, 53, "mma"),
               (2, 64, 130, 4, 4, 16, False, 0, "mma"),
               (2, 9, 300, 8, 1, 32, True, 291, "mma"),
               (1, 7, 40, 8, 1, 64, True, 33, "split")]


def _attn_limit(q, k, v, want, causal, off):
    """As ``chip_smoke.py`` holds K6: the output's last rounding (2^-20 of
    |want| in float32, one bf16 ulp, 2^-7, in bfloat16) plus float32 sums
    along keys and head dim, (Skv + Dh + 8) * 2^-24 of sum_j p_j |v_j|."""
    mag = ref.flash_attention_ref(q.double(), k.double(), v.double().abs(),
                                  causal=causal, q_offset=off)
    rtol = 2.0**-20 if q.dtype == torch.float32 else 2.0**-7
    return rtol * want.abs() + (k.shape[1] + k.shape[3] + 8) * 2.0**-24 * mag


def _within(got, want, limit) -> None:
    excess = ((got.double() - want).abs() - limit).max()
    assert float(excess) <= 0.0, float(excess)


def _routes_taken(call):
    """The K6 routes whose launch count ``call()`` raised, and its result."""
    before = dict(flash_attention.LAUNCHES)
    out = call()
    return [name[len("flash_attention_"):] for name, n
            in flash_attention.LAUNCHES.items()
            if n != before[name] and name != "flash_attention"], out


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal,off,bf16_route",
                         ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_and_repeats_bitwise(
        card, B, Sq, Skv, Hq, Hkv, Dh, causal, off, bf16_route, dtype):
    g = torch.Generator(device=card).manual_seed(Sq * 1000 + Skv)
    q = torch.randn((B, Sq, Hq, Dh), generator=g, device=card, dtype=dtype)
    k, v = (torch.randn((B, Skv, Hkv, Dh), generator=g, device=card,
                        dtype=dtype) for _ in range(2))
    taken, got = _routes_taken(lambda: flash_attention.flash_attention_cuda(
        q, k, v, causal=causal, q_offset=off))
    assert taken == [bf16_route if dtype == torch.bfloat16 else "split"]
    again = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                                 q_offset=off)
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                   causal=causal, q_offset=off)
    _within(got, want, _attn_limit(q, k, v, want, causal, off))
    assert torch.equal(got, again)


def test_flash_attention_reads_strided_keys_and_values(card):
    g = torch.Generator(device=card).manual_seed(3)
    cache = torch.randn((3, 2, 2, 96, 2, 64), generator=g, device=card,
                        dtype=torch.bfloat16)       # (L, 2, B, Smax, H, Dh)
    q = torch.randn((2, 1, 4, 64), generator=g, device=card,
                    dtype=torch.bfloat16)
    k, v = cache[1, 0], cache[1, 1]
    # decode against a view of the cache: route B over more than one split
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert flash_attention.split_plan(2, 2, 2, 71, sms) > 1
    taken, got = _routes_taken(lambda: flash_attention.flash_attention_cuda(
        q, k, v, q_offset=70))
    assert taken == ["split"]
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                   q_offset=70)
    _within(got, want, _attn_limit(q, k, v, want, True, 70))
    assert torch.equal(got, flash_attention.flash_attention_cuda(
        q, k.contiguous(), v.contiguous(), q_offset=70))
    for dtype, Sq, route in ((torch.float32, 9, "split"),
                             (torch.bfloat16, 40, "mma")):
        packed = torch.randn((2, 50, 2, 2, 32), generator=g,
                             device=card, dtype=dtype)
        q = torch.randn((2, Sq, 4, 32), generator=g, device=card,
                        dtype=dtype)
        k, v = packed[:, :, 0], packed[:, :, 1]
        assert not k.is_contiguous()
        taken, got = _routes_taken(
            lambda: flash_attention.flash_attention_cuda(q, k, v,
                                                         q_offset=41))
        assert taken == [route]
        want = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                       q_offset=41)
        _within(got, want, _attn_limit(q, k, v, want, True, 41))


def _bag_route(call):
    """The K5 routes whose launch count ``call()`` raised, and its
    result."""
    before = dict(embedding_bag.LAUNCHES)
    out = call()
    return [name[len("embedding_bag_"):] for name, n
            in embedding_bag.LAUNCHES.items()
            if n != before[name] and name != "embedding_bag"], out


def _bag_check(table, ids, w, route) -> torch.Tensor:
    """K5 on the given route against its float64 plain version, and a
    second launch's bits."""
    taken, got = _bag_route(
        lambda: embedding_bag.embedding_bag_cuda(table, ids, w))
    assert taken == [route]
    want = ref.embedding_bag_ref(table.double(), ids, w.double())
    # each of at most L float32 roundings on a term's way into the sum is
    # at most 2^-24 of sum_l |w| |row|
    limit = ids.shape[1] * 2.0**-24 * ref.embedding_bag_ref(
        table.double().abs(), ids, w.double().abs())
    _within(got, want, limit)
    assert torch.equal(got, embedding_bag.embedding_bag_cuda(table, ids, w))
    return got


# the sweep of test_kernels.py, DIN's widths, odd d (7, 33), d > 32 (64),
# L = 1, B below the SM count, B = 8,192, a history above a staged pass
@pytest.mark.parametrize("V,d,B,L", [(100, 8, 16, 5), (1000, 18, 64, 100),
                                     (64, 32, 300, 7), (50_000, 16, 128, 64),
                                     (100_000, 18, 512, 100),
                                     (1000, 7, 64, 100), (1000, 33, 64, 100),
                                     (1000, 64, 64, 100), (1000, 18, 64, 1),
                                     (1000, 18, 5, 100),
                                     (100_000, 18, 8192, 100),
                                     (1000, 18, 40, 600)])
def test_embedding_bag_matches_plain_and_repeats_bitwise(card, V, d, B, L):
    g = torch.Generator(device=card).manual_seed(V + L)
    table = torch.randn((V, d), generator=g, device=card)
    ids = torch.randint(0, V, (B, L), generator=g, device=card,
                        dtype=torch.int32)
    w = torch.rand((B, L), generator=g, device=card)
    _bag_check(table, ids, w, "gather")                   # own histories
    _bag_check(table, ids[:1].expand(B, L), w, "shared")  # one history


@pytest.mark.parametrize("d,offset", [(18, 0), (18, 18), (18, 1), (7, 3)])
def test_embedding_bag_on_strided_weights_and_table_views(card, d, offset):
    """Weights with row stride 0 (one weight row for every bag) and tables
    that are views of a larger buffer, ``offset`` floats in: 72 bytes
    (8-byte aligned, not 16: float2 loads) and 4 or 12 bytes (one float a
    load), on both routes."""
    V, B, L = 5000, 300, 100
    g = torch.Generator(device=card).manual_seed(d + offset)
    buf = torch.randn(V * d + offset, generator=g, device=card)
    table = buf[offset:].view(V, d)
    assert table.data_ptr() % 16 != 0 or offset == 0
    assert embedding_bag.unit_width(table) == (
        2 if d % 2 == 0 and offset % 2 == 0 else 1)
    ids = torch.randint(-V, V, (B, L), generator=g, device=card,
                        dtype=torch.int32)
    w = torch.rand((B, L), generator=g, device=card)
    w_one = w[:1].expand(B, L)
    for bag_ids, route in ((ids, "gather"),
                           (ids[:1].expand(B, L), "shared")):
        for weights in (w, w_one):
            _bag_check(table, bag_ids, weights, route)


@pytest.mark.parametrize("n,K", [(64, 4), (100, 7), (512, 16), (300, 130),
                                 (1000, 33), ("graph", 0)])
def test_ell_spmv_matches_plain_and_repeats_bitwise(card, n, K):
    """K4 over test_kernels.py's sweep shapes (nonnegative weights, also
    under a false mask, so no sum cancels) and over a graph's dense push
    table, against the float64 plain version at rtol 1e-5 + 1e-6 max."""
    if n == "graph":
        tables = [torch.from_numpy(a).to(card)
                  for a in small_test_graph(n=2000).ell_in()]
        n = tables[0].shape[0]
    else:
        g = torch.Generator(device=card).manual_seed(n + K)
        tables = [torch.randint(0, n, (n, K), generator=g, device=card,
                                dtype=torch.int32),
                  torch.rand((n, K), generator=g, device=card) < 0.7,
                  torch.rand((n, K), generator=g, device=card)]
        tables[1][0] = False                 # a row with no live cell
    x = _x(n, 1, seed=n, device=card)[0]
    got = ell_spmv.ell_spmv_cuda(*tables, x)
    want = ref.ell_spmv_ref(tables[0], tables[1], x.double(),
                            tables[2].double())
    assert got.shape == (n,) and got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, ell_spmv.ell_spmv_cuda(*tables, x))
    if not bool(tables[1][0].any()):
        assert float(got[0]) == 0.0


def _edge_table(n: int, K: int, seed: int, device):
    """A dense (n, K) table with a random mask that is not left-packed
    (nonnegative weights, non-zero under a false mask too), row 0 with no
    live cell, row 1 with only its last column live, and the last row
    with none."""
    g = torch.Generator(device=device).manual_seed(seed)
    nbr = torch.randint(0, n, (n, K), generator=g, device=device,
                        dtype=torch.int32)
    mask = torch.rand((n, K), generator=g, device=device) < 0.6
    mask[0] = False
    mask[1] = False
    mask[1, K - 1] = True
    mask[n - 1] = False
    w = torch.rand((n, K), generator=g, device=device)
    return nbr, mask, w


def _close_to_plain(got, want):
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("K", [1, 7, 33, 48, 130])
def test_dense_kernels_follow_the_row_plan(card, K, monkeypatch):
    """K1 and K4 over tables with non-left-packed masks, a row whose only
    live cell is its last column and rows with none, n not a multiple of
    the rows a warp takes: each against the float64 plain version at rtol
    1e-5 + 1e-6 max, bits repeating, K1 at B in {1, 3, 4, 33, 64} with and
    without the threshold, and at B = 1 on both routes (the frontier route
    forced, as the rule gives it only larger tables). The plan a wrapper
    derives equals the one it is given, and a plan one cell short on every
    row gives the plain version of the table cut there: no cell at or past
    a row's extent is read."""
    n = 1003
    nbr, mask, w = _edge_table(n, K, seed=K, device=card)
    plan = ell_spmv.dense_plan(mask)           # the plan passed below
    cols = torch.arange(K, device=card)
    want_ext = torch.where(mask, cols + 1, 0).amax(dim=1)
    assert torch.equal(plan.extent.long(), want_ext)
    assert int(plan.extent[1]) == K and int(plan.extent[0]) == 0
    short = plan._replace(extent=(plan.extent - 1).clamp_min(0).to(
        torch.int32))
    cut = mask & (cols[None] < short.extent[:, None])
    x1 = _x(n, 1, seed=K, device=card)[0]
    for p in (None, plan):
        got = ell_spmv.ell_spmv_cuda(nbr, mask, w, x1, p)
        _close_to_plain(got, ref.ell_spmv_ref(nbr, mask, x1.double(),
                                              w.double()))
        assert torch.equal(got, ell_spmv.ell_spmv_cuda(nbr, mask, w, x1,
                                                       plan))
        assert float(got[0]) == 0.0 and float(got[n - 1]) == 0.0
    _close_to_plain(ell_spmv.ell_spmv_cuda(nbr, mask, w, x1, short),
                    ref.ell_spmv_ref(nbr, cut, x1.double(), w.double()))
    for B in (1, 3, 4, 33, 64):
        x = _x(n, B, seed=B, device=card)
        for thr in (None, torch.quantile(x, 0.5).expand(n).contiguous()):
            thr64 = None if thr is None else thr.double()
            want = ref.ell_spmm_ref(nbr, mask, x.double(), w.double(), thr64)
            got = ell_spmv.ell_spmm_cuda(nbr, mask, w, x, thr, plan)
            _close_to_plain(got, want)
            assert torch.equal(got, ell_spmv.ell_spmm_cuda(nbr, mask, w, x,
                                                           thr))
            _close_to_plain(
                ell_spmv.ell_spmm_cuda(nbr, mask, w, x, thr, short),
                ref.ell_spmm_ref(nbr, cut, x.double(), w.double(), thr64))
    monkeypatch.setattr(ell_spmv, "FRONTIER_MIN_N", 0)
    assert ell_spmv.frontier_group(n, 1) == 1
    x = _x(n, 1, seed=1, device=card)
    for thr in (None, torch.quantile(x, 0.5).expand(n).contiguous()):
        thr64 = None if thr is None else thr.double()
        before = ell_spmv.ROUTES["ell_spmm_frontier"]
        got = ell_spmv.ell_spmm_cuda(nbr, mask, w, x, thr, plan)
        assert ell_spmv.ROUTES["ell_spmm_frontier"] == before + 1
        _close_to_plain(got, ref.ell_spmm_ref(nbr, mask, x.double(),
                                              w.double(), thr64))
        assert torch.equal(got, ell_spmv.ell_spmm_cuda(nbr, mask, w, x, thr))
        _close_to_plain(
            ell_spmv.ell_spmm_cuda(nbr, mask, w, x, thr, short),
            ref.ell_spmm_ref(nbr, cut, x.double(), w.double(), thr64))


def test_dense_plan_on_a_graph_table_is_its_live_count(card):
    """On a graph's left-packed ``ell_in`` table the extent is the live
    count, and the residency carries the plan it derives."""
    g = small_test_graph(n=2000)
    dg = g.device(card)
    assert dg.layout == "dense" and dg.in_plan is not None
    assert torch.equal(dg.in_plan.extent.long(),
                       dg.in_mask.sum(dim=1))
    fresh = ell_spmv.dense_plan(dg.in_mask)
    assert torch.equal(fresh.extent, dg.in_plan.extent)
    assert fresh.lanes == dg.in_plan.lanes


@pytest.mark.parametrize("ids", [[[0, -1]], [[0, 5]], [[-4, 3], [1, -5]]])
def test_embedding_bag_reads_ids_as_the_plain_version(card, ids):
    """K5 on ids outside [0, V): [-V, 0) wraps to id + V, a bag with an id
    outside [-V, V) is NaN in every column, as in the plain version; on
    route G as given, and on route S with each row as every bag's
    history."""
    table = torch.randn((4, 3), generator=torch.Generator(
        device=card).manual_seed(1), device=card)
    ids = torch.tensor(ids, dtype=torch.int32, device=card)
    cases = [(ids, "gather")] + [(row[None].expand(3, -1), "shared")
                                 for row in ids]
    for bag_ids, route in cases:
        w = torch.rand(bag_ids.shape, device=card)
        taken, got = _bag_route(
            lambda: embedding_bag.embedding_bag_cuda(table, bag_ids, w))
        assert taken == [route]
        want = ref.embedding_bag_ref(table.double(), bag_ids, w.double())
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-7,
                                   equal_nan=True)
        bad = ((bag_ids < -4) | (bag_ids >= 4)).any(dim=1)
        assert torch.equal(torch.isnan(got).all(dim=1), bad)
        assert not bool(torch.isnan(got[~bad]).any())


def test_power_iteration_through_k4_equals_coo(card):
    g = small_test_graph(n=2000)
    assert g.device(card).layout == "dense"
    sources = np.array([0, 7, 42])
    ell_spmv.reset_launches()
    got = ppr_power_iteration(g, sources, device=card)
    iters = default_iters(0.2)
    assert ell_spmv.LAUNCHES["ell_spmv"] == iters * sources.size
    want = power_iteration_coo(g, sources, 0.2, iters, card).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    assert ppr_single_pair(g, 7, 42, device=card) == pytest.approx(
        float(got[1, 42]), rel=1e-6)


def test_cuda_tensors_reach_the_kernels(card, monkeypatch):
    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "flash_attention_ref", no_plain)
    monkeypatch.setattr(ref, "embedding_bag_ref", no_plain)
    monkeypatch.setattr(ref, "ell_spmv_ref", no_plain)
    monkeypatch.setattr(ref, "endpoint_fold_ref", no_plain)
    endpoint_fold.reset_launches()
    ops.endpoint_fold(torch.zeros((2, 9), dtype=torch.int64, device=card),
                      torch.ones((2, 9), device=card)[:, ::1], 4)
    assert endpoint_fold.LAUNCHES["endpoint_fold"] == 1
    flash_attention.reset_launches()
    embedding_bag.reset_launches()
    ell_spmv.reset_launches()
    nbr = torch.zeros((5, 3), dtype=torch.int32, device=card)
    ops.ell_spmv(nbr, nbr > -1, torch.ones((5, 3), device=card),
                 torch.ones(5, device=card))
    assert ell_spmv.LAUNCHES["ell_spmv"] == 1
    q = torch.randn((1, 4, 2, 16), device=card)
    ops.flash_attention(q, q, q)
    ops.embedding_bag(torch.randn((10, 4), device=card),
                      torch.zeros((2, 3), dtype=torch.int32, device=card),
                      torch.ones((2, 3), device=card))
    assert flash_attention.LAUNCHES["flash_attention"] == 1
    assert embedding_bag.LAUNCHES["embedding_bag"] == 1


@pytest.mark.parametrize("arch_id", ["gemma-2b", "qwen2-moe-a2.7b",
                                     "moonshot-v1-16b-a3b", "stablelm-1.6b",
                                     "qwen1.5-32b", "din"])
def test_infer_run_on_card_matches_cpu(card, arch_id):
    """The smoke configuration's serving steps on the card, through K5 or
    K6, against the same steps on the CPU from the same seeded draws."""
    arch = get_arch(arch_id)
    flash_attention.reset_launches()
    embedding_bag.reset_launches()
    on_card = arch.infer_run(torch.Generator().manual_seed(0), card)
    launched = (embedding_bag.LAUNCHES["embedding_bag"] if arch_id == "din"
                else flash_attention.LAUNCHES["flash_attention"])
    assert launched > 0
    on_cpu = arch.infer_run(torch.Generator().manual_seed(0), "cpu")
    assert on_card.keys() == on_cpu.keys()
    for key, value in on_card.items():
        assert value == pytest.approx(on_cpu[key], rel=1e-4, abs=1e-5), key


@pytest.mark.parametrize("B,S", [(4, 96), (4, 1)])      # prefill, decode
@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
def test_moe_apply_on_card_matches_cpu_repeats_and_never_syncs(
        card, B, S, capacity_factor, monkeypatch):
    """``moe_apply`` on the card, in float32 at a small width, against the
    port's CPU ``moe_apply`` on the same parameters (the same top-k ids,
    y within rtol 1e-5 + 1e-5 max|y|); a second call gives the same bits,
    and neither syncs with the host (``set_sync_debug_mode("error")``
    raises on a sync)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = moe.MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                        num_shared=1, capacity_factor=capacity_factor)
    cpu = moe.moe_init(torch.Generator().manual_seed(0), 64, cfg,
                       device="cpu")
    on_card = {k: v.to(card) if isinstance(v, torch.Tensor)
               else {kk: vv.to(card) for kk, vv in v.items()}
               for k, v in cpu.items()}
    x = torch.randn((B, S, 64), generator=torch.Generator().manual_seed(1))
    want_y, want_aux = moe.moe_apply(cpu, cfg, x)
    xc = x.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_apply(on_card, cfg, xc)
        again, aux_again = moe.moe_apply(on_card, cfg, xc)
        gate_i = moe.route(on_card, cfg, xc.reshape(B * S, 64))[3]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(y, again) and torch.equal(aux, aux_again)
    assert torch.equal(gate_i.cpu(), moe.route(cpu, cfg, x.reshape(-1, 64))[3])
    np.testing.assert_allclose(y.cpu().numpy(), want_y.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want_y.abs().max()))
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.parametrize("B,W,n", [(1, 1, 5), (3, 9000, 2000),
                                   (1, 1 << 20, 281_903),
                                   (8, 1 << 20, 281_903)])
@pytest.mark.parametrize("case", ["uniform", "active", "hub", "skew"])
def test_endpoint_fold_matches_plain_and_repeats_bitwise(card, B, W, n,
                                                         case):
    g = torch.Generator(device=card).manual_seed(B * 31 + W)
    pos = torch.randint(0, n, (B, W), generator=g, device=card,
                        dtype=torch.int32)
    w = torch.rand((B, W), generator=g, device=card)
    if case == "active":                  # lanes past a row's count weigh 0
        act = torch.randint(1, W + 1, (B, 1), generator=g, device=card)
        w = torch.where(torch.arange(W, device=card)[None] < act, w, 0.0)
    elif case == "hub":
        pos.fill_(n // 2)
    elif case == "skew":                  # a fifth of the lanes at node 7
        at = torch.rand((B, W), generator=g, device=card) < 0.2
        pos = torch.where(at, min(7, n - 1), pos).to(torch.int32)
    pos, w = pos.contiguous(), w.contiguous()
    got = endpoint_fold.endpoint_fold_cuda(pos, w, n)
    want = ref.endpoint_fold_ref(pos, w.double(), n)
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, endpoint_fold.endpoint_fold_cuda(pos, w, n))


@pytest.mark.parametrize("B", [1, 8])
def test_start_cdf_on_card_repeats_bitwise(card, B):
    from repro_torch.ppr.random_walk import cumulative_residual

    x = _x(281_903, B, seed=B, device=card)
    got = cumulative_residual(x)
    assert torch.equal(got, cumulative_residual(x.clone()))
    want = torch.cumsum(x.double(), dim=-1)
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


def test_endpoint_fold_drops_lanes_outside_the_graph(card):
    pos = torch.tensor([[0, 4, -1, 2, 9, 4]], dtype=torch.int32, device=card)
    w = torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0, 32.0]], device=card)
    got = endpoint_fold.endpoint_fold_cuda(pos, w, 5)
    assert got.cpu().tolist() == [[1.0, 0.0, 8.0, 0.0, 34.0]]


def _fold_case(card, B, W, n, case):
    """The inputs of ``test_endpoint_fold_matches_plain_and_repeats_bitwise``
    for one shape and case."""
    g = torch.Generator(device=card).manual_seed(B * 31 + W)
    pos = torch.randint(0, n, (B, W), generator=g, device=card,
                        dtype=torch.int32)
    w = torch.rand((B, W), generator=g, device=card)
    if case == "active":
        act = torch.randint(1, W + 1, (B, 1), generator=g, device=card)
        w = torch.where(torch.arange(W, device=card)[None] < act, w, 0.0)
    elif case == "hub":
        pos.fill_(n // 2)
    elif case == "skew":
        at = torch.rand((B, W), generator=g, device=card) < 0.2
        pos = torch.where(at, min(7, n - 1), pos).to(torch.int32)
    return pos.contiguous(), w.contiguous()


@pytest.mark.parametrize("B,W,n", [(1, 1, 5), (3, 9000, 2000),
                                   (1, 1 << 20, 281_903),
                                   (8, 1 << 20, 281_903)])
@pytest.mark.parametrize("case", ["uniform", "active", "hub", "skew"])
def test_endpoint_fold_is_its_emulation_bitwise(card, B, W, n, case):
    pos, w = _fold_case(card, B, W, n, case)
    got = endpoint_fold.endpoint_fold_cuda(pos, w, n)
    assert torch.equal(got, ref.endpoint_fold_fixed_ref(pos, w, n))


@pytest.mark.parametrize("case", ["uniform", "active", "hub", "skew"])
def test_endpoint_fold_bits_ignore_lane_order_and_batch(card, case):
    B, W, n = 8, 1 << 20, 281_903
    pos, w = _fold_case(card, B, W, n, case)
    got = endpoint_fold.endpoint_fold_cuda(pos, w, n)
    g = torch.Generator(device=card).manual_seed(1)
    perm = torch.argsort(torch.rand((B, W), generator=g, device=card), dim=1)
    moved = endpoint_fold.endpoint_fold_cuda(
        torch.gather(pos, 1, perm).contiguous(),
        torch.gather(w, 1, perm).contiguous(), n)
    assert torch.equal(moved, got)
    for b in range(B):
        alone = endpoint_fold.endpoint_fold_cuda(pos[b:b + 1].contiguous(),
                                                 w[b:b + 1].contiguous(), n)
        assert torch.equal(alone[0], got[b])


@pytest.mark.parametrize("case", ["hub", "equal", "uniform"])
def test_endpoint_fold_at_the_lane_cap(card, case):
    """W = 2^22 lanes at the Pokec order: the lanes' integers of a hub sum
    to at most 2^62, and the rows agree with float64 and the emulation."""
    B, W, n = 2, 1 << 22, 1_632_803
    pos, w = _fold_case(card, B, W, n, "hub" if case == "hub" else "uniform")
    if case == "equal":
        w = torch.where(w < 0.5, torch.tensor(0.0, device=card),
                        torch.tensor(1 / 3, device=card)).contiguous()
    got = endpoint_fold.endpoint_fold_cuda(pos, w, n)
    assert torch.equal(got, ref.endpoint_fold_fixed_ref(pos, w, n))
    want = ref.endpoint_fold_ref(pos, w.double(), n)
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


def test_endpoint_fold_has_no_float_atomics_and_no_sort(card):
    import re
    import subprocess
    from pathlib import Path

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import _build

    lib = _build.build(["endpoint_fold"])["endpoint_fold"]
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    atomics = re.findall(r"\b(?:ATOMS|ATOMG|ATOM|RED)\.[A-Z0-9_.]+", sass)
    assert atomics, "no atomic found in the fold's SASS"
    assert not [a for a in atomics if re.search(r"\.(?:F16|BF16|F32|F64)", a)]
    code = re.sub(r"//[^\n]*", "",
                  (_build.CSRC / _build.SOURCES["endpoint_fold"]).read_text())
    assert "sort" not in code.lower()

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    pos, w = _fold_case(card, 3, 9000, 2000, "skew")
    with Ops() as ops:
        endpoint_fold.endpoint_fold_cuda(pos, w, 2000)
    assert ops.names and all(name.startswith("aten.empty")
                             for name in ops.names), ops.names


def test_engine_on_card_repeats_bitwise_and_meets_the_guarantee(card):
    g = load("web-stanford", scale=64)
    ex = ForaExecutor(PprWorkload(g, 24, seed=0), ForaParams(epsilon=0.5),
                      device=card)
    runs = []
    for _ in range(2):
        eng = QueryEngine(ex, 8)
        pending, got = list(range(24)), {}
        endpoint_fold.reset_launches()
        while pending or eng.busy:
            while pending and eng.free:
                eng.insert(pending.pop(0))
            eng.step()
            got.update({h.qid: h for h in eng.harvest()})
        assert endpoint_fold.LAUNCHES["endpoint_fold"] > 0
        runs.append(got)
    for q in range(24):
        assert np.array_equal(runs[0][q].pi, runs[1][q].pi)
    exact = ppr_power_iteration(g, ex.workload.sources[:3], device=card)
    pi = np.stack([runs[0][q].pi for q in range(3)])
    mask = exact >= 1.0 / g.n
    assert float((np.abs(pi - exact)[mask] / exact[mask]).max()) < 0.5
    chunk = ex.answer_chunk(list(range(8)))
    for q in range(8):
        np.testing.assert_allclose(runs[0][q].pi.sum(), chunk[q].sum(),
                                   rtol=1e-4)


def test_monte_carlo_ppr_on_card(card):
    g = small_test_graph(n=2000)
    sources = np.array([0, 7, 42])
    endpoint_fold.reset_launches()
    mc = monte_carlo_ppr(g, sources, ForaParams(epsilon=0.5), device=card)
    assert endpoint_fold.LAUNCHES["endpoint_fold"] == sources.size
    exact = ppr_power_iteration(g, sources, device=card)
    mask = exact >= 1.0 / g.n
    np.testing.assert_allclose(mc.sum(axis=1), 1.0, atol=1e-4)
    assert float((np.abs(mc - exact)[mask] / exact[mask]).max()) < 0.5


def test_dynamic_graph_on_card_equals_cpu_and_k2_skips_spare_rows(card):
    g = load("web-stanford", scale=64)
    log = MutationLog.seeded(g, 4, seed=1, batch_edges=64)
    on_card, on_cpu = DynamicGraph(g, device=card), DynamicGraph(g,
                                                                device="cpu")
    for batch in log:
        on_card.apply(batch)
        on_cpu.apply(batch)
    for f in ("edge_src", "edge_dst", "out_offsets", "out_degree",
              "in_neighbors", "in_mask", "in_weights", "in_row_map"):
        assert torch.equal(getattr(on_card.dg, f).cpu(),
                           getattr(on_cpu.dg, f)), f
    dg = on_card.dg
    x = _x(g.n, 3, seed=4, device=card)
    ell_spmv.reset_launches()
    clean = ell_spmv.ell_spmm_sliced_cuda(dg.in_neighbors, dg.in_mask,
                                          dg.in_weights, dg.in_row_map, x,
                                          None, dg.in_fold)
    assert ell_spmv.LAUNCHES["ell_spmm_sliced"] == 1
    want = ref.ell_spmm_sliced_ref(dg.in_neighbors, dg.in_mask, x.double(),
                                   dg.in_weights.double(), None,
                                   dg.in_row_map)
    torch.testing.assert_close(clean.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    spare = (dg.in_row_map == g.n)[:, None]
    assert bool(spare.any())
    poisoned = ell_spmv.ell_spmm_sliced_cuda(
        torch.where(spare, g.n - 1, dg.in_neighbors), dg.in_mask | spare,
        torch.where(spare, 1.0, dg.in_weights), dg.in_row_map, x, None,
        dg.in_fold)
    assert torch.equal(clean, poisoned)


def test_autotune_sweeps_time_k2_and_the_walk_on_card(card):
    """The autotune sweep launches K2 on every swept table and records a
    ``cuda`` key; a residency built under the cache on the card takes the
    tuned table and pushes as the default one does, within the sliced
    tolerance."""
    from repro_torch.kernels import autotune
    from repro_torch.ppr.graph import DeviceGraph

    web = load("web-stanford", scale=64)
    cache = autotune.TuningCache()
    trials: list = []
    ell_spmv.reset_launches()
    best = autotune.sweep_sliced(web, B=8, pad_multiples=(8, 32), repeats=2,
                                 device=card, cache=cache, trials=trials)
    walk = autotune.sweep_walk(web, num_walks=1024, repeats=2, device=card,
                               cache=cache)
    assert ell_spmv.LAUNCHES["ell_spmm_sliced"] == 2 * 3
    bucket = autotune.shape_bucket(web.n, web.m)
    assert cache.lookup("cuda", "sliced", bucket) == best
    assert cache.lookup("cuda", "walk", bucket) == walk
    assert all(t.device_us > 0.0 for t in trials) and walk.device_us > 0.0
    wide = trials[-1]
    tuned = autotune.TuningCache()
    tuned.record("cuda", "sliced", bucket, wide)
    try:
        autotune.set_cache(tuned)
        dg = DeviceGraph.from_graph(web, device=card)
    finally:
        autotune.clear_cache()
    cold = DeviceGraph.from_graph(web, device=card)
    assert dg.ell_width == wide.width != cold.ell_width
    x = _x(web.n, 3, 5, card)
    got = ops.ell_spmm_sliced(dg.in_neighbors, dg.in_mask, dg.in_weights,
                              dg.in_row_map, x, fold=dg.in_fold)
    want = ops.ell_spmm_sliced(cold.in_neighbors, cold.in_mask,
                               cold.in_weights, cold.in_row_map, x,
                               fold=cold.in_fold)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-6 * float(want.abs().max()))


def test_serving_daemon_on_card_runs_its_queries_through_the_kernels(card,
                                                                     tmp_path):
    """A small PPR daemon as ``serve --daemon`` builds it, on the card:
    every job completes, its queries launch K2 and the fold, and recovery
    from its WAL gives the same records."""
    from repro_torch.launch import serve
    from repro_torch.serving import ServingRuntime

    args = serve.build_parser().parse_args([
        "--daemon", "--workload", "ppr", "--scale", "64", "--num-jobs", "3",
        "--queries", "16", "--deadline", "0.5", "--arrival-rate", "4",
        "--max-cores", "8", "--cache-size", "64", "--wal-dir",
        str(tmp_path), "--snapshot-every", "5", "--device", "cuda"])
    serve.prepare(args)
    rt, factory, _ = serve._build_daemon_runtime(args)
    rt.submit_poisson(args.num_jobs, args.arrival_rate, queries=args.queries,
                      deadline=args.deadline, seed=args.seed)
    ell_spmv.reset_launches()
    endpoint_fold.reset_launches()
    report = rt.run()
    assert report.completed == 3
    assert ell_spmv.LAUNCHES["ell_spmm_sliced"] > 0
    assert endpoint_fold.LAUNCHES["endpoint_fold"] > 0
    rt2, _ = ServingRuntime.recover(tmp_path, factory, fsync=False)
    assert rt2.run().records == report.records


# ---------------------------------------------------------------------------
# the node-sharded residency on one card


@pytest.mark.parametrize("route", ["plain", "frontier"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_k1_on_a_row_block_matches_plain(card, route, k, monkeypatch):
    """K1 on each row block of a k-way cut of a dense table (global gather
    ids, rows != n, the last block padded with empty rows) against the
    float64 plain version of the block, bits repeating, at B = 1 on the
    route asked for (the frontier route's bitmap covers x's n nodes) and
    at B = 3 on the plain route; the blocks put together give the whole
    table's product."""
    monkeypatch.setattr(ell_spmv, "FRONTIER_MIN_N",
                        0 if route == "frontier" else 1 << 30)
    g = small_test_graph(n=3001, avg_deg=12, seed=k)
    dense_mesh = DeviceMesh((card,) * k)
    sg = ShardedDeviceGraph.from_graph(g, dense_mesh)
    dg = g.device(card)
    assert sg.layout == "dense" and sg.rows_per_shard * k > g.n
    for B in (1, 3):
        x = _x(g.n, B, seed=B, device=card)
        thr = torch.quantile(x, 0.6).expand(g.n).contiguous()
        blocks = []
        for nbr, mask, w, plan in zip(sg.in_neighbors, sg.in_mask,
                                      sg.in_weights, sg.in_plan):
            before = ell_spmv.ROUTES["ell_spmm_frontier"]
            got = ell_spmv.ell_spmm_cuda(nbr, mask, w, x, thr, plan)
            took = ell_spmv.ROUTES["ell_spmm_frontier"] - before
            assert took == (1 if route == "frontier" and B == 1 else 0)
            assert got.shape == (B, sg.rows_per_shard)
            _close_to_plain(got, ref.ell_spmm_ref(nbr, mask, x.double(),
                                                  w.double(), thr.double()))
            assert torch.equal(got, ell_spmv.ell_spmm_cuda(nbr, mask, w, x,
                                                           thr, plan))
            blocks.append(got)
        whole = ell_spmv.ell_spmm_cuda(dg.in_neighbors, dg.in_mask,
                                       dg.in_weights, x, thr, dg.in_plan)
        # a row's sum has one order whatever block holds it
        assert torch.equal(torch.cat(blocks, dim=1)[:, :g.n], whole)


@pytest.mark.parametrize("B", [1, 8])
def test_k2_on_a_block_that_continues_a_hub(card, B):
    """K2 on a block of virtual rows that starts inside a hub's slices (the
    hub split between two shards) and ends inside another row's: its own
    fold from the block's row_map, against the float64 plain version of
    the block, bits repeating; the two blocks' frames add up to the whole
    table's product."""
    web = load("web-stanford", scale=64)
    sl = web.ell_in_sliced()
    W = sl.width
    counts = np.bincount(sl.row_map, minlength=web.n)
    hub = int(np.argmax(counts))
    chunk = max(1, ell_spmv.WARP_CELLS // W)
    assert counts[hub] > 4 * chunk, "need a hub of several chunks"
    first = int(np.searchsorted(sl.row_map, hub))
    cut = first + counts[hub] // 2 + 1          # inside the hub, off a chunk
    tables = [torch.from_numpy(a).to(card) for a in
              (sl.neighbors, sl.mask, sl.weights, sl.row_map)]
    x = _x(web.n, B, seed=B, device=card)
    thr = torch.quantile(x, 0.5).expand(web.n).contiguous()
    frames = []
    for lo, hi in ((0, cut), (cut, sl.n_virtual)):
        nbr, mask, w, rm = (t[lo:hi].contiguous() for t in tables)
        fold = ell_spmv.sliced_fold(rm, web.n, W)
        assert int(rm[0] if lo else rm[-1]) == hub
        got = ell_spmv.ell_spmm_sliced_cuda(nbr, mask, w, rm, x, thr, fold)
        _close_to_plain(got, ref.ell_spmm_sliced_ref(
            nbr, mask, x.double(), w.double(), thr.double(), rm))
        assert torch.equal(got, ell_spmv.ell_spmm_sliced_cuda(
            nbr, mask, w, rm, x, thr, fold))
        frames.append(got)
    want = ref.ell_spmm_sliced_ref(tables[0], tables[1], x.double(),
                                   tables[2].double(), thr.double(),
                                   tables[3])
    _close_to_plain(frames[0] + frames[1], want)


@pytest.mark.parametrize("layout", ["dense", "sliced"])
def test_four_shard_mesh_on_one_card_matches_device_graph(card, layout):
    """fora_fused on a 4-shard mesh of the one card against the same query
    on the card's DeviceGraph, with the same draws: the push's sweeps, the
    residual mass and the budgets equal, pi within the sharded tolerance,
    a repeated call bit for bit, a 1-shard mesh bit for bit with the
    DeviceGraph; every shard launches its K1 or K2."""
    g = (small_test_graph(n=3001, avg_deg=12, seed=2) if layout == "dense"
         else load("web-stanford", scale=64))
    params = ForaParams(epsilon=0.5)
    W, B = 4096, 3
    L = walk_length_for_tail(params.alpha, params.walk_tail)
    rng = np.random.default_rng(0)
    draws = TableDraws(
        torch.from_numpy(rng.random((B, W), dtype=np.float32)).to(card),
        torch.from_numpy(rng.integers(0, 1 << 30, (L, B, W),
                                      dtype=np.int32)).to(card))
    sources = [0, 17, 99]
    dg = g.device(card)
    assert dg.layout == layout
    want = fora_fused(dg, sources, params, num_walks=W, draws=draws,
                      device=card)
    one = fora_fused(g.device(mesh=DeviceMesh((card,))), sources, params,
                     num_walks=W, draws=draws, device=card)
    assert torch.equal(one.pi, want.pi)
    sg = g.device(mesh=DeviceMesh((card,) * 4))
    ell_spmv.reset_launches()
    got = fora_fused(sg, sources, params, num_walks=W, draws=draws,
                     device=card)
    key = "ell_spmm" if layout == "dense" else "ell_spmm_sliced"
    # each sweep launches one kernel a shard, sweeps past convergence too
    launched = ell_spmv.LAUNCHES[key]
    assert launched % 4 == 0 and launched >= 4 * int(got.push_iters) > 0
    again = fora_fused(sg, sources, params, num_walks=W, draws=draws,
                       device=card)
    assert torch.equal(got.pi, again.pi)
    assert int(got.push_iters) == int(want.push_iters)
    torch.testing.assert_close(got.residual_mass, want.residual_mass,
                               rtol=1e-5, atol=0.0)
    assert torch.equal(got.walks_effective, want.walks_effective)
    torch.testing.assert_close(got.pi, want.pi, rtol=1e-4,
                               atol=1e-6 * float(want.pi.abs().max()))


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.parametrize("layout", ["dense", "sliced"])
def test_mesh_over_several_cards_matches_one_card(cards, layout):
    """A mesh of distinct cards, one whose first card is not the current
    card among them: each shard's K1/K2, walks and fold launch on the
    shard's own card, and the query has the bits of the same mesh cut on
    one card (the same kernels in the same orders), within the sharded
    tolerance of the DeviceGraph; an executor of devices=2 on card 1
    builds its mesh from card 1 and answers there."""
    assert torch.cuda.current_device() == 0
    g = (small_test_graph(n=3001, avg_deg=12, seed=2) if layout == "dense"
         else load("web-stanford", scale=64))
    params = ForaParams(epsilon=0.5)
    W, B = 4096, 3
    L = walk_length_for_tail(params.alpha, params.walk_tail)
    rng = np.random.default_rng(0)
    u = rng.random((B, W), dtype=np.float32)
    us = rng.integers(0, 1 << 30, (L, B, W), dtype=np.int32)
    sources = [0, 17, 99]
    k = 4 if len(cards) >= 4 else 2
    for mesh in ((cards[1], cards[0]), tuple(cards[:k])):
        first = mesh[0]
        draws = TableDraws(torch.from_numpy(u).to(first),
                           torch.from_numpy(us).to(first))
        sg = g.device(mesh=DeviceMesh(mesh))
        assert sg.device == first
        assert [t.device for t in sg.in_neighbors] == list(mesh)
        ell_spmv.reset_launches()
        got = fora_fused(sg, sources, params, num_walks=W, draws=draws,
                         device=first)
        torch.cuda.synchronize()
        key = "ell_spmm" if layout == "dense" else "ell_spmm_sliced"
        assert ell_spmv.LAUNCHES[key] >= len(mesh) * int(got.push_iters) > 0
        assert got.pi.device == first
        again = fora_fused(sg, sources, params, num_walks=W, draws=draws,
                           device=first)
        assert torch.equal(got.pi, again.pi)
        one_card = fora_fused(ShardedDeviceGraph.from_graph(
            g, DeviceMesh((first,) * len(mesh))), sources, params,
            num_walks=W, draws=draws, device=first)
        assert torch.equal(got.pi, one_card.pi)
        want = fora_fused(g.device(first), sources, params, num_walks=W,
                          draws=draws, device=first)
        assert int(got.push_iters) == int(want.push_iters)
        assert torch.equal(got.walks_effective, want.walks_effective)
        torch.testing.assert_close(got.pi, want.pi, rtol=1e-4,
                                   atol=1e-6 * float(want.pi.abs().max()))
    assert torch.cuda.current_device() == 0
    start = 1 if len(cards) > 2 else 0
    ex = ForaExecutor(PprWorkload(g, num_queries=8, seed=0),
                      ForaParams(epsilon=0.5), block_size=4, devices=2,
                      device=cards[start])
    rows = ex.answer_chunk([0, 1, 2])
    assert ex.device_graph.mesh.devices == tuple(cards[start:start + 2])
    np.testing.assert_allclose(rows.sum(axis=1), 1.0, atol=1e-3)


def _segment_case(E: int, S: int, d: int, seed: int, device):
    """Values (E, d) and an index with empty segments, single-edge
    segments, one long segment (over many runs of the kernels' fold) and
    indices outside [0, S), unsorted."""
    rng = np.random.default_rng(seed)
    index = rng.integers(0, S // 2, E)
    index[: E // 3] = 1                     # the long segment: many runs
    index[-4:] = [-1, S, S + 3, S - 1]                  # dropped, and one
    index[-8:-4] = S // 2 + np.arange(4) * 2            # single edges
    rng.shuffle(index)
    values = rng.standard_normal((E, d)).astype(np.float32)
    return (torch.from_numpy(values).to(device),
            torch.from_numpy(index.astype(np.int32)).to(device))


def _route(values, plan, route):
    """The values and plan of one route: the plan's order (gathered), or
    the values laid out in plan order over its contiguous view."""
    if route == "gathered":
        return values, plan
    return values[plan.order.long()].contiguous(), plan.contiguous()


@pytest.mark.parametrize("route", ["gathered", "contiguous"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("d", [1, 16, 47, 75, 512])
def test_segment_reduce_matches_float64_plain_and_repeats(card, d, op,
                                                          route):
    from repro_torch.kernels import segment_reduce

    values, index = _segment_case(3000, 64, d, seed=d, device=card)
    plan = ops.segment_plan(index, 64)
    R1, _ = segment_reduce.run_lengths(3000, d, segment_reduce.unit_width(d))
    assert int(plan.counts.max()) > 2 * R1        # the long one: many runs
    vals, rplan = _route(values, plan, route)
    segment_reduce.reset_launches()
    got = ops.segment_reduce(vals, rplan, op)
    again = ops.segment_reduce(vals, rplan, op)
    torch.cuda.synchronize()
    assert segment_reduce.LAUNCHES["segment_reduce"] == 2
    assert torch.equal(got, again)
    # the card's order, written in torch on the CPU: the same bits
    assert torch.equal(got.cpu(), segment_reduce.card_order_reduce(
        values.cpu(), plan.order.cpu(), plan.keys.cpu(), 64, op))
    want = ref.segment_reduce_ref(values.double(), plan.order, plan.offsets,
                                  op)
    if op == "sum":
        # any order of deg float32 adds errs by at most deg 2^-24 sum|v|
        deg = plan.counts.double()[:, None]
        mag = ref.segment_reduce_ref(values.double().abs(), plan.order,
                                     plan.offsets, "sum")
        limit = deg * 2.0**-24 * mag + 1e-30
        assert bool(((got.double() - want).abs() <= limit).all())
    else:
        assert torch.equal(got.double(), want)
    empty = plan.counts == 0
    assert bool(empty.any())
    ident = {"sum": 0.0, "max": -np.inf, "min": np.inf}[op]
    assert bool((got[empty] == ident).all())
    # the 1-D form
    flat = ops.segment_reduce(vals[:, 0].contiguous(), rplan, op)
    assert torch.equal(flat, ops.segment_reduce(vals[:, :1].contiguous(),
                                                rplan, op)[:, 0])


def test_segment_reduce_refuses_bad_arguments(card):
    from repro_torch.kernels.segment_reduce import segment_reduce_cuda

    values, index = _segment_case(500, 16, 8, seed=1, device=card)
    plan = ops.segment_plan(index, 16)
    args = (plan.order, plan.keys, plan.offsets)
    with pytest.raises(ValueError, match="float32"):
        segment_reduce_cuda(values.double(), *args, "sum")
    with pytest.raises(ValueError, match="contiguous"):
        segment_reduce_cuda(values.t(), *args, "sum")
    with pytest.raises(ValueError, match="order"):
        segment_reduce_cuda(values, plan.order.cpu(), *args[1:], "sum")
    with pytest.raises(ValueError, match="keys"):
        segment_reduce_cuda(values, plan.order, plan.keys[1:], plan.offsets,
                            "sum")
    with pytest.raises(ValueError, match="offsets"):
        segment_reduce_cuda(values, plan.order, plan.keys,
                            plan.offsets.long(), "sum")
    with pytest.raises(ValueError, match="op"):
        segment_reduce_cuda(values, *args, "mean")


@pytest.mark.parametrize("arch_id", ["gcn-cora", "pna", "graphcast",
                                     "dimenet"])
def test_gnn_forward_on_card_matches_cpu_and_repeats(card, arch_id):
    from repro_torch.kernels import segment_reduce

    arch = get_arch(arch_id)
    params, inputs = arch.smoke_case(torch.Generator().manual_seed(0), "cpu")
    fwd = arch.forward_step(smoke=True)
    want, want_loss = fwd(params, inputs)
    params_c = params.to(card)
    inputs_c = {k: v.to(card) for k, v in inputs.items()}
    segment_reduce.reset_launches()
    got, loss = fwd(params_c, inputs_c)
    again, _ = fwd(params_c, inputs_c)
    torch.cuda.synchronize()
    assert segment_reduce.LAUNCHES["segment_reduce"] > 0
    assert torch.equal(got, again)
    rtol = 1e-5 if arch_id == "gcn-cora" else 1e-4
    torch.testing.assert_close(got.cpu(), want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))
    assert float(loss) == pytest.approx(float(want_loss), rel=rtol)


@pytest.mark.parametrize("route", ["gathered", "contiguous"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("d", [1, 16, 47, 75, 512])
def test_segment_reduce_grad_matches_float64_plain_and_repeats(card, d, op,
                                                               route):
    """The backward kernel on both routes on the segment cases (one long
    segment over many runs, whose max and min tie across them; empty and
    single-edge segments; edges in no segment), values on a few levels so
    that max and min tie: within rtol 1e-5 of float64, the same nonzero
    entries, bits repeating, through autograd too."""
    from repro_torch.kernels import segment_reduce

    values, index = _segment_case(3000, 64, d, seed=d + 1, device=card)
    values = torch.round(values * 2.0).clamp(-3.0, 3.0)   # ties
    plan = ops.segment_plan(index, 64)
    R1, _ = segment_reduce.run_lengths(3000, d, segment_reduce.unit_width(d))
    assert int(plan.counts.max()) > 2 * R1
    vals, rplan = _route(values, plan, route)
    out = ops.segment_reduce(vals, rplan, op)
    g_out = torch.randn(out.shape, generator=torch.Generator(card)
                        .manual_seed(d), device=card)
    segment_reduce.reset_launches()
    got = ops.segment_reduce_grad(g_out, vals, out, rplan, op)
    again = ops.segment_reduce_grad(g_out, vals, out, rplan, op)
    torch.cuda.synchronize()
    assert segment_reduce.LAUNCHES["segment_reduce_grad"] == 2
    assert torch.equal(got, again)
    want = ref.segment_reduce_grad_ref(g_out.double(), vals.double(),
                                       out.double(), rplan.rows(),
                                       plan.offsets, op)
    assert torch.equal(got != 0, want != 0)
    assert bool(((got.double() - want).abs()
                 <= 1e-5 * want.abs()).all())
    if op != "sum":
        ties = (vals[plan.offsets[1]:plan.offsets[2]] if route ==
                "contiguous" else vals[plan.order[plan.offsets[1]:
                                                  plan.offsets[2]].long()])
        assert int((ties == out[1]).sum(0).max()) > 1   # ties over runs
    leaf = vals.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(ops.segment_reduce(leaf, rplan, op), leaf,
                                  g_out)
    assert torch.equal(auto, got)
    assert segment_reduce.LAUNCHES["segment_reduce_grad"] == 3


@pytest.mark.parametrize("d", [1, 16, 47, 75])
def test_gather_rows_backward_on_card_is_the_segment_sum(card, d):
    from repro_torch.kernels import segment_reduce

    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((300, d)).astype(np.float32))
    index = torch.from_numpy(rng.integers(0, 300, 5000).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((5000, d)).astype(np.float32))
    leaf = x.to(card).requires_grad_(True)
    plan = ops.segment_plan(index.to(card), 300)
    segment_reduce.reset_launches()
    (grad,) = torch.autograd.grad(
        ops.gather_rows(leaf, index.to(card), plan), leaf, g.to(card))
    (again,) = torch.autograd.grad(
        ops.gather_rows(leaf, index.to(card), plan), leaf, g.to(card))
    torch.cuda.synchronize()
    assert segment_reduce.LAUNCHES["segment_reduce"] == 2
    assert torch.equal(grad, again)
    want = ref.segment_reduce_ref(g.double(), plan.order.cpu(),
                                  plan.offsets.cpu(), "sum")[:300]
    mag = ref.segment_reduce_ref(g.double().abs(), plan.order.cpu(),
                                 plan.offsets.cpu(), "sum")[:300]
    deg = plan.counts.cpu().double()[:300, None]
    assert bool(((grad.cpu().double() - want).abs()
                 <= deg * 2.0**-24 * mag + 1e-30).all())


@pytest.mark.parametrize("arch_id", ["gcn-cora", "pna", "graphcast",
                                     "dimenet"])
def test_gnn_train_step_on_card_matches_cpu_and_repeats(card, arch_id):
    """One smoke train step on the card against the CPU's (loss at the
    model's rtol; parameters within rtol |p| + rtol max|p|, and 2 lr more
    where the CPU gradient is at rounding level, whose Adam sign may
    flip), and a second step from the same start with the same bits."""
    import copy

    from repro_torch.kernels import segment_reduce
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw_init

    arch = get_arch(arch_id)
    rtol = 1e-5 if arch_id == "gcn-cora" else 1e-4
    params, inputs = arch.smoke_case(torch.Generator().manual_seed(0), "cpu")
    start = copy.deepcopy(params)
    _, grads = arch.grad_step(smoke=True)(copy.deepcopy(params), inputs)
    tiny = [g.abs() <= rtol * g.abs() + rtol * float(g.abs().max())
            for g in grads]
    step = arch.build_step(smoke=True)
    want, _, want_loss = step(params, adamw_init(params), inputs)
    inputs_c = {k: v.to(card) for k, v in inputs.items()}
    segment_reduce.reset_launches()
    runs = []
    for _ in range(2):
        p = copy.deepcopy(start).to(card)
        p, s, loss = step(p, adamw_init(p), inputs_c)
        runs.append((p, s, loss))
    torch.cuda.synchronize()
    assert segment_reduce.LAUNCHES["segment_reduce_grad"] > 0
    (p1, s1, l1), (p2, s2, l2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert all(torch.equal(a, b) for a, b in zip(s1.m + s1.v, s2.m + s2.v))
    assert float(l1) == pytest.approx(float(want_loss), rel=rtol)
    lr = 3e-4 / 100                       # the first step's warm-up rate
    for a, b, t in zip(tree_leaves(p1), tree_leaves(want), tiny):
        b = b.detach().double()
        limit = rtol * b.abs() + rtol * float(b.abs().max())
        limit = torch.where(t, limit + 2 * lr, limit)
        assert bool(((a.detach().cpu().double() - b).abs() <= limit).all())


# ---------------------------------------------------------------------------
# K5's backward (csrc/embedding_bag_grad.cu) and DIN training


def _bag_grad_inputs(V, d, B, L, hot, seed, device):
    """table, ids (one id at a quarter of the positions where ``hot``; the
    ids of the upper half of the table never drawn), weights, g."""
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn((V, d), generator=gen)
    ids = torch.randint(0, max(1, V // 2), (B, L), generator=gen,
                        dtype=torch.int32)
    if hot:
        ids[torch.rand((B, L), generator=gen) < 0.25] = 1
    w = torch.randn((B, L), generator=gen)
    g = torch.randn((B, d), generator=gen)
    return [t.to(device) for t in (table, ids, w, g)]


def _bag_grad_limits(table, ids, w, g):
    """Float64 dT and dw with their limits: a table row's cell within
    cnt 2^-24 sum |w| |g| (cnt the row's positions), a dw within d 2^-24
    sum_c |T| |g|."""
    want_t, want_w = ref.embedding_bag_grad_ref(table.double(), ids,
                                                w.double(), g.double())
    abs_t, abs_w = ref.embedding_bag_grad_ref(table.double().abs(), ids,
                                              w.double().abs(),
                                              g.double().abs())
    cnt = torch.bincount(ids.reshape(-1).long(),
                         minlength=table.shape[0]).double()[:, None]
    return (want_t, cnt * 2.0**-24 * abs_t,
            want_w, table.shape[1] * 2.0**-24 * abs_w)


@pytest.mark.parametrize("V,d,B,L,hot", [(1000, 18, 64, 100, False),
                                         (10_000, 18, 4096, 100, True),
                                         (50_000, 16, 256, 100, True),
                                         (300, 7, 33, 10, False),
                                         (100, 64, 8, 5, True),
                                         (7, 18, 3, 1, False)])
def test_bag_grad_matches_float64_plain_and_repeats(card, V, d, B, L, hot):
    table, ids, w, g = _bag_grad_inputs(V, d, B, L, hot, V + d, card)
    plan = ops.segment_plan(ids.reshape(-1), V, keep_index=False)
    embedding_bag.reset_launches()
    call = lambda: embedding_bag.embedding_bag_grad_cuda(  # noqa: E731
        table, ids, w, g, plan.order, plan.keys, plan.offsets)
    d_t, d_w = call()
    again_t, again_w = call()
    torch.cuda.synchronize()
    assert embedding_bag.LAUNCHES["embedding_bag_grad_table"] == 2
    assert embedding_bag.LAUNCHES["embedding_bag_grad_weights"] == 2
    assert torch.equal(d_t, again_t) and torch.equal(d_w, again_w)
    want_t, lim_t, want_w, lim_w = _bag_grad_limits(table, ids, w, g)
    _within(d_t, want_t, lim_t)
    _within(d_w, want_w, lim_w)
    assert not d_t[max(1, V // 2):].any()            # rows no id names
    # the bits of segment_reduce over the float32 products on the plan
    terms = (w[..., None] * g[:, None, :]).reshape(B * L, d)
    bits = segment_reduce.segment_reduce_cuda(terms, plan.order, plan.keys,
                                              plan.offsets, "sum")
    assert torch.equal(d_t.view(torch.int32), bits.view(torch.int32))


def test_bag_grad_reads_ids_as_the_forward(card):
    table, ids, w, g = _bag_grad_inputs(40, 18, 4, 6, False, 3, card)
    ids[0, 2], ids[1, 0], ids[2, 5] = -1, 40, -41     # row 39, bad, bad
    _, d_w = embedding_bag.embedding_bag_grad_cuda(table, ids, w, g,
                                                   table_grad=False)
    want = ref.embedding_bag_grad_ref(table.double(), ids, w.double(),
                                      g.double())[1]
    assert torch.equal(torch.isnan(d_w), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert float((d_w.double()[fin] - want[fin]).abs().max()) < 1e-5


def test_bag_autograd_on_card_is_the_kernels(card):
    table, ids, w, g = _bag_grad_inputs(500, 18, 16, 100, True, 5, card)
    plan = ops.segment_plan(ids.reshape(-1), 500, keep_index=False)
    lt, lw = table.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="plan"):
        torch.autograd.grad(ops.embedding_bag(lt, ids, lw), (lt, lw), g)
    a_t, a_w = torch.autograd.grad(ops.embedding_bag(lt, ids, lw, plan=plan),
                                   (lt, lw), g)
    d_t, d_w = embedding_bag.embedding_bag_grad_cuda(
        table, ids, w, g, plan.order, plan.keys, plan.offsets)
    assert torch.equal(a_t, d_t) and torch.equal(a_w, d_w)


def test_bag_grad_table_reads_negative_ids_as_the_forward(card):
    """An id in [-V, 0) is row id + V in the table's gradient too, through
    ``ops.bag_plan``, as in the forward and the plain version."""
    table, ids, w, g = _bag_grad_inputs(300, 18, 32, 20, True, 11, card)
    ids[0, :5] = -1
    ids[3, 7], ids[9, 0] = -300, -150
    plan = ops.bag_plan(ids, 300)
    lt, lw = table.clone().requires_grad_(True), w.clone().requires_grad_(True)
    a_t, a_w = torch.autograd.grad(ops.embedding_bag(lt, ids, lw, plan=plan),
                                   (lt, lw), g)
    want_t, lim_t, want_w, lim_w = _bag_grad_limits(table, ids % 300, w, g)
    _within(a_t, want_t, lim_t)
    _within(a_w, want_w, lim_w)
    assert bool(a_t[299].any()) and bool(a_t[150].any())


def test_din_train_step_on_card_matches_cpu_and_repeats(card):
    """The DIN smoke config's train step on the card against the CPU's
    (loss rtol 1e-5; parameters rtol 1e-4 of |p| + 1e-6 max|p|, 2 lr more
    where the CPU gradient is at rounding level), a second step from the
    same start with the same bits, and the launches of its structure."""
    import copy

    from repro_torch.kernels import segment_reduce
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw_init

    arch = get_arch("din")
    params = arch.init_params(torch.Generator().manual_seed(0), "cpu",
                              smoke=True)
    batch = arch.make_inputs("train_batch", torch.Generator(), "cpu",
                             smoke=True, seed=1, batch=256)
    start = copy.deepcopy(params)
    _, grads = arch.grad_step(smoke=True)(copy.deepcopy(params), batch)
    tiny = [g.abs() <= 1e-4 * g.abs() + 1e-4 * float(g.abs().max())
            for g in grads]
    step = arch.build_step("train_batch", smoke=True)
    want, _, want_loss = step(params, adamw_init(params), batch)
    batch_c = {k: v.to(card) for k, v in batch.items()}
    runs = []
    for _ in range(2):
        embedding_bag.reset_launches()
        segment_reduce.reset_launches()
        p = copy.deepcopy(start).to(card)
        p, s, loss = step(p, adamw_init(p), batch_c)
        runs.append((p, s, loss))
    torch.cuda.synchronize()
    assert embedding_bag.LAUNCHES["embedding_bag_grad_table"] == 2
    assert embedding_bag.LAUNCHES["embedding_bag_grad_weights"] == 2
    assert segment_reduce.LAUNCHES["segment_reduce"] == 4
    (p1, s1, l1), (p2, s2, l2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert all(torch.equal(a, b) for a, b in zip(s1.m + s1.v, s2.m + s2.v))
    assert float(l1) == pytest.approx(float(want_loss), rel=1e-5)
    lr = 3e-4 / 100
    for a, b, t in zip(tree_leaves(p1), tree_leaves(want), tiny):
        b = b.detach().double()
        limit = 1e-4 * b.abs() + 1e-6 * float(b.abs().max())
        limit = torch.where(t, limit + 2 * lr, limit)
        assert bool(((a.detach().cpu().double() - b).abs() <= limit).all())
