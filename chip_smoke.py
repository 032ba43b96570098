#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # one card, no arguments

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main path, in phases:

1. every kernel against its plain PyTorch version on the card. K1 and K2
   on the push tables of the paths (K1: ``small_test_graph(n=2000)`` and
   phase 8's Pokec-order table with its threshold, K2: the full-size
   Web-Stanford stand-in) at the batch widths the paths launch them with
   (and K1 and K2 at 8 and 64), with and without the fused threshold, and
   on the sliced table's edge cases; K1 also on real push residuals at
   Pokec's order (its frontier route at B = 1), on a dense table past 2^19
   nodes, and with K4 on tables whose masks are not left-packed (K in
   {1, 7, 33, 48, 130}, n = 1,003, K1 at B in {1, 3, 4, 33, 64} and on
   its frontier route forced at B = 1);
   K3 on endpoint tables
   of both index paths' shapes at B in {1, 3, 8} and L in {1, 130, 4096}
   and the dense path's L, with full and retired budgets and a hub that
   every lane ends at; K4 over the JAX package's sweep shapes, the dense
   path's table and the Pokec-order table of phase 8; K5 on ids outside
   [0, V) on both its routes. The plain version runs in float64 on the same inputs; an output
   passes where ``|out - want| <= RTOL * |want| + ATOL_FRAC * max|want|``,
   and the printed ratio is the largest ``|out - want|`` over that limit.
   The check must also refuse broken versions (folds that drop slices or
   rows, one for each path of K2's fold: a short row's in-warp fold, a
   warp-item row, a hub's last slice and its last chunk; a gather that
   ignores the budget, drops a lane per cell or the last lane of each K3
   fold block's range; an SpMV that ignores the mask or drops each row's
   last cell; K1 and K4 reading each row one cell short of its extent, K1
   reading the threshold at the row instead of the source, K1's frontier
   route losing one word of its bitmap, and, in phase 9, a live endpoint
   fold that drops each cell's last lane, ignores the weights, drops
   each 8,192-lane block's last 32 lanes or sums on a scale 2^32 too
   coarse), and a second launch must give the same bits. Then the lane
   streams drawn on the card must equal those drawn on the CPU;
2. the dense path: ``fora_fused`` on ``small_test_graph(n=2000)``, against
   exact PPR whose every step is one K4 launch a source;
3. the paper path at real size: 256 FORA queries on the full-size
   Web-Stanford stand-in through ``ForaExecutor`` into ``dna_real``, with
   FORA checked against power iteration on three sources (the sliced
   table's COO loop, a ``segment_reduce`` a step: K4 launches no time; run
   twice, it must give the same bits; its last step's reduction held
   against float64 plain and timed as phase 14 holds the GNNs');
4. the index paths (FORA+): rows of each walk index rebuilt on the CPU
   must equal the card's; the dense path through
   ``ForaExecutor(index_budget=DENSE_INDEX_WIDTH)`` at coverage 1.0; the
   paper path as in phase 3, served from one index of width
   ``PAPER_INDEX_WIDTH`` built once; and a run with retired rows (the
   partial branch), each within FORA's eps and each launching its push
   kernel as well as K3;
5. kernel times at the paths' shapes beside their bound, their plain
   version's time and one PyTorch library call's. Each time is device
   time: the card's kernel durations under ``torch.profiler``, summed and
   divided by the calls, and printed by kernel for K2 and K3. The host's
   pace (CUDA events around back-to-back calls) is printed beside it. K1
   is timed at the dense path's shape, on a uniform table and on phase 8's
   Pokec-order table at B = 1; K3 beside ``index_add_`` of the gathered
   pairs and beside the gather, the budget mask and ``index_add_``. At
   Pokec's order the two floors of K1 and K4 (``tools/ell_floors.cu``:
   the rows' live cells read with no gather, and x gathered at the live
   neighbours with nothing else read) are printed beside K4, and K1's
   frontier route on real push residuals (sweeps 4, 6 and 27 of one
   source's push) beside its plain route and ``torch.sparse.mm`` on the
   same thresholded x; then K1's two routes over every launch of one
   push, from the dense path's n = 2,000 to Pokec's order, the measure of
   the rule that picks the route;
6. gemma-2b serving at full width and depth (18 layers, d 2048, 8 query
   heads on 1 KV head, Dh 256, vocab 256,000, bf16, 2,506,172,416 random
   parameters from a seed), cut in batch and sequence only: 4 prompts of
   4,096 tokens prefilled into a cache of 4,128, then 32 greedy decode
   steps, all attention through K6: the 18 prefill calls through its
   tensor-core route (A), the 576 decode calls through its CUDA-core route
   split over keys (B), each route's launches counted. K6 is held against
   its float64 plain version at layer 0's prefill q/k/v, at a decode
   step's q against a view of the cache, at GQA and MHA shapes and over
   the JAX package's sweep (float32 and bfloat16), each check printing its
   route; the limit must refuse a kernel that ignores q_offset, one that
   maps query head h to KV head h % Hkv, a route A that leaves its
   diagonal tile unmasked and a route B whose merge drops the last split.
   Decode's logits at position S must equal a prefill's over S + 1
   tokens. Then K6's times at the prefill and decode shapes (each call the
   sum of every kernel it launches) beside its bound, the float32 plain
   version's and ``F.scaled_dot_product_attention``'s, and a profile of
   each path;
7. DIN serving with its full-size tables (10M x 18 items, 100k x 18
   categories): serve_p99 (B = 512, L = 100) through ``score`` and
   1,000,000 candidates in blocks of 8,192 through ``score_candidates``,
   unfactored and factored, the history pooling through K5 (route G for
   serve_p99's own histories, route S for retrieval's shared one; the
   launches are counted by route). K5 is held against its float64 plain
   version at the path's inputs, at a shared history longer than one
   staged pass and over the JAX package's sweep on both routes, each
   check asserting its route, and the limit must refuse a kernel that
   drops the last history item, one that ignores the weights, route G
   dropping one warp's share of a bag's items, route S staging only the
   first pass, and either route dropping the last column unit; factored
   must equal unfactored, and 256 candidates must equal ``score`` on the
   same pairs. Then the times of every K5 launch of the path (items,
   categories, retrieval block) beside its bound, the plain version's and
   ``F.embedding_bag``'s, and a profile of each path;
8. the dense graph at Pokec's order (paper Table I: n = 1,632,803, m =
   30,622,564; ``small_test_graph`` with uniform endpoints, so its
   1,632,803 x 48 push table is dense): exact PPR for 4 sources through
   K4 must equal the COO ``index_add_`` loop on the card and
   ``ppr_single_pair`` the row's entry; 256 FORA queries through
   ``ForaExecutor`` into ``dna_real`` (the quickstart's deadline rule),
   FORA within eps of the K4 oracle and no row short of the walks its
   guarantee asks for; then ``deadline_serving``'s loop on a second
   D&A_REAL run, at a deadline set for 4 cores at d = 0.9: 64 devices,
   8 of them lost and half the queries readmitted in half the deadline
   (Lemma 1's core count), and the straggler re-issue over the measured
   per-query times of the slot with the longest lane, one lane stalled by
   20 t_hat: the lanes over t_hat (2 - d) must be re-issued and the slot
   cut to its first finishers;
9. the continuous-batching engine on the paper path at full size: the live
   endpoint fold (``csrc/endpoint_fold.cu``) against its float64 plain
   version (rtol 1e-5 + 1e-6 * max, the check of phase 1) on real walk
   endpoints of the paper path's queries at its calibrated 2^20 lanes and
   B in {1, 3, 8}, on random weights, and with every lane at one hub;
   each case must also equal its emulation (``ref.endpoint_fold_fixed_ref``)
   bit for bit and give the same bits on a second launch, under a lane
   permutation, and for each row folded alone (B = 1 and 3 the first rows
   of B = 8); the limit must refuse the four broken folds above.
   Then 256 queries through an 8-lane ``QueryEngine`` (K2 at B = 8, the
   fold on each walking group), launches by kernel counted; a second run
   with the same insertion schedule must give the same bits; each row
   must lie within the sliced push's rtol 1e-4 of its ``answer_chunk``
   row but for at most ``2 * MOVED_MAX`` entries, each within MOVED_MAX
   walkers' weight r_sum / w_eff (a walk start that a push at another
   batch width put across a CDF boundary); within eps of power iteration
   on 3 sources; no row short of its walks without ``walks_short``. Per
   query ms, the insert-to-harvest latency, a profile of 16 queries with
   its idle share, the fold's time at B = 1 and 8 (by kernel and by
   events) beside its bound, its plain version and ``index_add_``; and
   Monte Carlo PPR on the dense path within eps of K4's oracle. The fold's
   launches are counted on phases 3, 9, 11 and 12 and go into its row of
   the kernels line (``launches_by_path``);
10. dynamic graphs on the same graph: 8 seeded ``MutationLog`` batches of
   256 edges applied by ``DynamicGraph`` on the card, each timed; after
   each, the walk view's live prefix must equal a fresh build's arrays and
   the push on the mutated residency (K2 with the fold rebuilt from the
   new ``row_map``) a fresh build's within rtol 1e-4 + 1e-6 * max; K2 must
   give the same bits with the spare rows (``row_map == n``) filled with
   live cells; ``compact()`` must equal a fresh build, every array and the
   fold;
11. the serving daemon (``repro_torch.launch.serve``) on the same graph:
   the autotune sweep (K2 at B = 8 on the sliced tables of pad multiples
   8, 16 and 32, each also held against its float64 plain version, and
   the live walk) into a tuning cache that must load back equal; a
   residency built under it must take the tuned width and push within
   rtol 1e-4 of the default table; ``seeded_from_tuning`` must give walk
   / (walk + push); the autotune CLI twice (``--smoke``, then
   ``--expect-hit``, which must exit 0). Then a PPR daemon built as
   ``serve --daemon`` builds it: 8 Poisson jobs of 64 queries, the
   deadline X t_avg / 6 from measured queries, the engine, a result cache
   of 256, a WAL with a snapshot every 20 events and the tuning cache;
   every job must complete with consistent accounting, K2 and the fold
   must launch and K1 and K4 not, and ``ServingRuntime.recover`` from the
   WAL must give the live run's trace and job records. A second run under
   seeded failures and slowdowns applies 4 ``DynamicGraph`` batches of 256
   edges through the mutation hook; no job may be lost, and the push on
   the mutated residency must equal a fresh build's. Last, a crash leg on
   the simulated workload: ``drive_with_crashes`` at 2 crash points must
   give the uncrashed run's records;
12. the node-sharded residency on the one card (a mesh may repeat a
   device, so four shards run one after another on it): the paper path at
   full size on a 4-shard mesh (4 x 97,024 virtual rows) and a 1-shard
   mesh, 64 queries one at a time at 2^20 lanes against the DeviceGraph's
   answers on the same per-query draws (sweeps, walk budgets and flags
   equal, residual mass within rtol 1e-5, pi within rtol 1e-4 + 1e-6 *
   max), the 1-shard mesh and a repeated 4-shard run bit for bit; every
   shard's K2 (a block may start inside a row another shard holds) and
   the combined sweep against float64 plain at B = 1 and 8; a 3-shard
   mesh (lanes rounded up to a multiple of 3) within eps of phase 4's
   power iteration on phase 3's sources. Then phase 8's Pokec-order table
   in 4 row blocks of 408,201: each shard's K1 against float64 plain with
   the route it took, 8 queries at phase 8's threshold against the
   DeviceGraph's, no row short of its walks. Then ``ForaExecutor(devices=1)``
   takes the DeviceGraph, and on one card ``ForaExecutor(devices=2)`` and
   ``serve --devices 2`` are refused as over capacity. Printed, not gated:
   ms a query by mesh, device us of K1 and K2 on a shard's block and on the
   whole table, and of the combine a sweep;
13. the rest of the LM family at full width, in bf16 from a seed, each
   freed before the next loads: qwen2-moe-a2.7b (24 layers, 60 experts
   top 4 and 4 shared) with 32 decode steps, moonshot-v1-16b-a3b cut to 12
   of 48 layers, stablelm-1.6b and qwen1.5-32b cut to 16 of 64, 8 steps
   each, all prefilling 4 x 4,096 into a cache of 4,128 through
   ``build_step``. Each must have its config's parameter count, finite
   logits, n_layers x (1 + steps) K6 launches (route A on prefill, route
   B on decode) and decode logits equal to a longer prefill's (where that
   prefill dropped none of the last position's MoE entries); qwen2-moe's
   prefill must repeat its bits. K6 against float64 plain at qwen2-moe's,
   stablelm's and qwen1.5-32b's layer-0 prefill and a decode step. MoE
   layer 0 of qwen2-moe and moonshot on the prefill's 16,384 tokens: the
   float32 router logits within rtol 1e-5 of float64's, the top-k sets
   float64's wherever the margin is clear, and y within 2^-8 (4 |y| + 2
   max|y|) of a float64 plain version on the card's routing with the same
   drops, at the published capacity factor and at 0.5; the limit must
   refuse a version that drops each token's last expert and one that
   keeps the entries past capacity. Printed: tokens/s and ms a step
   beside ``model_flops``/``model_bytes``' least time, peak device
   memory, a profile of a qwen2-moe prefill and decode step split into
   GEMMs, the experts, K6, the MoE dispatch and combine, and idle share,
   and K6's times at the new shapes beside its bound and SDPA;
14. the GNN family forward at published widths, float32 (TF32 off), on 13
   cells through ``get_arch(id).forward_step`` on ``make_inputs``: GCN on
   full_graph_sm, minibatch_lg, ogb_products and molecule; PNA, GraphCast
   (16 blocks, d 512) and DimeNet (6 blocks, d 128) on the three cells
   other than ogb_products (which they do not fit as written).
   minibatch_lg samples the full-size web-stanford stand-in (batch 1,024,
   fanout 15-10, padded to 180,224 nodes and 179,200 edges). Each cell
   must give a finite output and loss of the right shapes, the same bits
   from a second forward, and the segment_reduce launches of the model's
   structure. ``csrc/segment_reduce.cu`` is held against its float64
   plain version at real aggregations: GCN's two layers on ogb_products
   (d 16 and 47, the contiguous route) and its gathers' backward sums
   (the gathered route), PNA's four aggregators and GraphCast's layer 0
   on minibatch_lg, DimeNet's triplet sum on molecule: a sum within deg
   2^-24 sum|v| + 1e-30 a cell, max and min equal, bits repeating; the
   limit must refuse a version that drops each segment's last edge, one
   that reads each segment's end one edge late and one that drops a
   segment's part before its first run boundary (the carry). Where the
   kernel is slower than one of its library calls, the floor of
   ``tools/segment_floors.cu`` at that shape is printed beside it. Each
   smoke configuration runs on the card
   and on the CPU within the CPU parity tolerance. Printed: ms a forward
   by CUDA events beside ``forward_flops``/``forward_bytes``' least time,
   peak memory, profiles of GCN on ogb_products and GraphCast on
   minibatch_lg split into the plans, GEMMs, gathers, segment_reduce and
   the rest with the idle share (not gated), and the kernel's device time
   at those aggregations (queued behind a sleep kernel, CUDA events)
   beside its bound, its plain version and ``index_add_``,
   ``scatter_reduce`` (amax) and ``torch.segment_reduce``;
15. GNN training on the same 13 cells through ``get_arch(id).build_step``
   on ``make_inputs`` (the loss's gradient under autograd, then AdamW),
   from ``init_params`` and ``adamw_init``: a finite loss and gradient
   norm, parameters that moved, a second step from the same start with
   the same bits (parameters, moments, loss), no float ``index_add``,
   ``scatter_add``, ``scatter_reduce`` or accumulating ``index_put_``
   recorded by a ``TorchDispatchMode`` (which must see index_select's
   backward ``index_add`` first), and the launches of ``segment_reduce``
   and ``segment_reduce_grad`` that the model's structure gives.
   ``csrc/segment_grad.cu`` is held against its float64 plain version at
   five real aggregations (GCN's two layers on ogb_products, the
   contiguous route; PNA's max and min on minibatch_lg with their ties
   and trash segment, GraphCast's sum on minibatch_lg, DimeNet's triplet
   sum on molecule, the gathered route) with a seeded output gradient:
   rtol 1e-5, the tied entries exactly the plain version's, the rows of
   edges in no segment 0, bits repeating; the limit must refuse a
   backward that gives the whole gradient to the first tied edge, one
   that leaves each segment's last edge unwritten and one that gives
   each segment's first edge the row before it. Each smoke configuration's
   three train steps run on the card against the CPU's. Printed: ms a
   step by CUDA events beside ``model_flops``/``model_bytes``' least
   time, peak memory, profiles of GCN on ogb_products and GraphCast on
   minibatch_lg, and the backward's time beside its bound, its plain
   version and PyTorch's own backward of the same function
   (``index_select``; ``scatter_reduce``'s autograd for max and min);
16. DIN training at ``train_batch`` through ``get_arch("din").build_step``:
   B = 65,536 users of L = 100, the 10M x 18 item and 100k x 18 category
   tables in float32, not cut, on ``RecsysStream`` batches (Zipf(1.3)
   item ids, seed 0). One step's kernel calls are recorded: K5's forward
   at the train shape against float64 plain (L 2^-24 sum|w||row|); K5's
   backward (``csrc/embedding_bag_grad.cu``: ``bag_grad_table`` over the
   plan of the ids, ``bag_grad_weights``) on the item and category
   tables and on uniform item ids with the same weights and gradient,
   dT within cnt 2^-24 sum|w||g| a cell (cnt the row's positions) and 0
   on rows no id names, dw within d 2^-24 sum_c |T||g|, each limit
   refusing a dT without a short segment's last position, a dT and a dw
   with two bags' g rows swapped and a dw without the table's last
   column; ``segment_reduce`` on the item table's gather backward as
   phase 14 holds it. A second step from the same start must give the
   same bits, and a ``TorchDispatchMode`` must record no float scatter.
   Then 8 steps, one batch each: losses, ms a step by CUDA events beside
   ``model_flops``/``model_bytes``' least time, peak memory, the launches
   a step (``din_train_launches``), and a profile split into K5's
   forward and backward, the plans, gathers, ``segment_reduce``, GEMMs,
   AdamW and the rest with the idle share; both backward kernels timed
   beside their bound, the plain version and ``F.embedding_bag``'s
   backward with ``per_sample_weights``. Last, ``python -m
   repro_torch.launch.train --arch din`` on the card (30 smoke steps,
   int8 gradient compression, a failure injected at step 15): its loss
   must improve.

The launch counts of each path are zeroed just before it and read just
after. Any failed phase exits non-zero; without a card, or without the
port's sources next to this script, it exits non-zero before any result.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FLOORS_SRC = ROOT / "tools" / "ell_floors.cu"
SEGMENT_FLOORS_SRC = ROOT / "tools" / "segment_floors.cu"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
# kernel against its float64 plain version: every output within RTOL of
# the exact value, plus ATOL_FRAC of the output's largest entry. The
# kernels sum nonnegative terms along chains of at most ~100 float32 adds
# (K2: at most 64 units a lane, 4 cells a unit, a butterfly of 5 and a
# hub's fold of 733 chunks over 32 lanes; K3: at most 31 a level of its
# four), so their relative error stays under 100 * 2**-24 = 6e-6. The
# endpoint fold sums in fixed point (csrc/endpoint_fold.cu's header): a
# cell of k lanes is off by at most k * 2**(e + l - 63) before its float32
# rounding (max weight < 2**e, W <= 2**l lanes), within ATOL_FRAC of the
# largest output for any weights up to 2**21 lanes, and at most 2**(l - 62)
# + 2**-24 of the cell for the walks' rows of equal weights.
RTOL = 1e-5
ATOL_FRAC = 1e-6
LIBRARY_RTOL = 1e-3      # torch.sparse.mm's summation order is its own
DENSE_SOURCES = (0, 7, 42)     # phase 2's fora_fused sources
CHECK_SOURCES = 3              # phase 3's FORA check (a B=3 push)
# walk index widths: the dense path's calibrated walk budget is 2^15, so
# its index is that wide to cover it; the paper graph's full coverage would
# be 1.18 TB, so its index is partial (2^12 of 2^20 lanes, 4.6 GB)
DENSE_INDEX_WIDTH = 1 << 15
PAPER_INDEX_WIDTH = 1 << 12
# phase 6: gemma-2b at full width and depth, cut in batch and sequence only
LM_BATCH = 4
LM_PROMPT = 4096
LM_CACHE_SLACK = 32            # cache Smax = LM_PROMPT + LM_CACHE_SLACK
LM_DECODE_STEPS = 32
GEMMA_PARAMS = 2_506_172_416
LM_LOGIT_TOL = 2e-2            # bf16: decode vs prefill, of max|logit|
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
# K6 against its float64 plain version, by q's dtype, the output's last
# rounding: float32, a few ulp of the final division (2^-20); bfloat16, one
# ulp (2^-7): the rounding's half ulp is up to 2^-8 of the value, and the
# float32 sum before it differs from the exact one as well
ATTN_RTOL = {"torch.float32": 2.0**-20, "torch.bfloat16": 2.0**-7}
# tests/test_kernels.py::test_flash_attention_sweep's shapes
ATTN_SWEEP = [(1, 128, 128, 2, 2, 64, True, 0),
              (2, 100, 100, 4, 2, 32, True, 0),
              (1, 1, 256, 4, 1, 64, True, 255),
              (2, 64, 192, 8, 8, 128, False, 0),
              (1, 37, 53, 2, 1, 16, True, 16)]
# K6's float64 plain version runs over slices of KV heads whose (B, group,
# Sq, Skv) float64 scores stay under this (gemma-2b's layer 0, 4.3 GB, in
# one slice); each such tensor is made about three times
PLAIN_SLICE_BYTES = 5 << 30
# K6's kernels, whose device times sum to a call's: route A's, route B's
# and route B's merge of its key splits
K6_KERNELS = ("flash_mma", "flash_fwd", "flash_merge")
# route A's keys a tile at Dh 256 (TileA<256>::kKeys in the source): the
# broken version that leaves the diagonal tile unmasked sees its whole tile
MMA_KEY_TILE = 32
FLUSH_BYTES = 64 << 20         # overwritten between timed calls: > 50 MB L2
FLUSH_KERNEL = "FillFunctor<unsigned char>"   # the kernel of its zero_()
PROFILE_TRIES = 5
# phase 13: the rest of the LM family at full width, depth cut where one
# card's 80 GB asks: (arch id, layers kept or None for all, decode steps)
LM_FAMILY = (("qwen2-moe-a2.7b", None, LM_DECODE_STEPS),
             ("moonshot-v1-16b-a3b", 12, 8),
             ("stablelm-1.6b", None, 8),
             ("qwen1.5-32b", 16, 8))
LEAD_MODEL = "qwen2-moe-a2.7b"  # prefilled twice for its bits; profiled
# K6 checked and timed at these models' shapes (moonshot's are qwen2-moe's)
K6_FAMILY = ("qwen2-moe-a2.7b", "stablelm-1.6b", "qwen1.5-32b")
MOE_LOGIT_RTOL = 1e-5
MOE_TOPK_MARGIN = 1e-4         # p_k - p_k+1 above this share of p_k: held
MOE_DROP_FACTOR = 0.5          # a capacity factor that forces drops
MOE_Y_REL, MOE_Y_MAX = 4.0, 2.0    # y's limit 2^-8 (4 |y| + 2 max|y|)
# the MoE stages of models/moe.py and their part of phase 13's split
MOE_STAGES = {"route": "dispatch", "bucket": "dispatch",
              "dispatch": "dispatch", "experts": "experts",
              "combine": "combine"}
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::matmul",
            "aten::linear")
# phase 7: DIN with its full-size tables
DIN_TABLE_BYTES = 727_200_000
DIN_SERVE_REQUESTS = 20
DIN_BLOCK = 8192               # retrieval candidates a block
DIN_ATOL = 1e-5                # tests/test_models.py's factored-retrieval atol
LIBRARY_BAG_RTOL = 1e-5        # F.embedding_bag, of sum_l |w| |row|
BAG_LONG_B = 1024              # bags of the shared history above one pass
# tests/test_kernels.py::test_embedding_bag_sweep's shapes (V, d, B, L)
BAG_SWEEP = [(100, 8, 16, 5), (1000, 18, 64, 100), (64, 32, 300, 7),
             (50_000, 16, 128, 64)]
REPLACES = {"ell_spmm": "src/repro/kernels/ell_spmv.py:141",
            "ell_spmm_sliced": "src/repro/kernels/ell_spmv.py:234",
            "ell_spmv": "src/repro/kernels/ell_spmv.py:71",
            "walk_endpoint_gather": "src/repro/kernels/walk_gather.py:57",
            "flash_attention": "src/repro/kernels/flash_attention.py:83",
            "embedding_bag": "src/repro/kernels/embedding_bag.py:40",
            # XLA's segment_sum of the live walks, not a Pallas kernel
            "endpoint_fold": "src/repro/ppr/random_walk.py:213",
            # XLA's segment_sum/max/min of the GNNs, not a Pallas kernel
            "segment_reduce": "src/repro/models/gnn/common.py:44",
            # their autodiff (jax.grad of the same ops): no Pallas backward
            "segment_reduce_grad": "src/repro/models/gnn/common.py:44",
    # XLA's autodiff of DIN's jnp.take and einsum pooling (the function
    # K5 computes forward): no Pallas backward
    "embedding_bag_grad_table": "src/repro/models/recsys/din.py:80",
    "embedding_bag_grad_weights": "src/repro/models/recsys/din.py:80"}
SOURCES = {"ell_spmm": "src/repro_torch/kernels/csrc/ell_spmm.cu",
           "ell_spmm_sliced":
               "src/repro_torch/kernels/csrc/ell_spmm_sliced.cu",
           "ell_spmv": "src/repro_torch/kernels/csrc/ell_spmv.cu",
           "walk_endpoint_gather":
               "src/repro_torch/kernels/csrc/walk_gather.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "embedding_bag": "src/repro_torch/kernels/csrc/embedding_bag.cu",
           "endpoint_fold": "src/repro_torch/kernels/csrc/endpoint_fold.cu",
           "segment_reduce":
               "src/repro_torch/kernels/csrc/segment_reduce.cu",
           "segment_reduce_grad":
               "src/repro_torch/kernels/csrc/segment_grad.cu",
           "embedding_bag_grad_table":
               "src/repro_torch/kernels/csrc/embedding_bag_grad.cu",
           "embedding_bag_grad_weights":
               "src/repro_torch/kernels/csrc/embedding_bag_grad.cu"}
# every TPU kernel of the JAX package has its counterpart
NOT_PORTED: list[dict] = []
# phase 14: the GNN family (configs/gcn_cora.py, pna_arch.py,
# graphcast_arch.py, dimenet_arch.py) at full width; ogb_products runs
# GCN alone (the other three do not fit one card as written)
GNN_CELLS = (("gcn-cora", ("full_graph_sm", "minibatch_lg", "ogb_products",
                           "molecule")),
             ("pna", ("full_graph_sm", "minibatch_lg", "molecule")),
             ("graphcast", ("full_graph_sm", "minibatch_lg", "molecule")),
             ("dimenet", ("full_graph_sm", "minibatch_lg", "molecule")))
# the aggregations held against float64 plain and timed: the first n
# segment_reduce calls of the cell's forward (GCN's: layers 0 and 1)
GNN_CHECKS = {("gcn-cora", "ogb_products"): 2, ("pna", "minibatch_lg"): 4,
              ("graphcast", "minibatch_lg"): 1, ("dimenet", "molecule"): 1}
GNN_PROFILES = {("gcn-cora", "ogb_products"), ("graphcast", "minibatch_lg")}
# the cells whose gathers' backward sums (segment_reduce over the plan of
# the gather's index) are held against float64 plain and timed
GATHER_CHECKS = {("gcn-cora", "ogb_products")}
SEGMENT_FLOORS_LIB = None      # tools/segment_floors.cu's library, once built
GNN_REPS = {("gcn-cora", "ogb_products"): 5, ("graphcast", "minibatch_lg"): 3,
            ("dimenet", "minibatch_lg"): 3}
GNN_REPS_DEFAULT = 10
# the CPU parity tests' tolerances (tests/test_torch_gnn.py)
GNN_RTOL = {"gcn-cora": 1e-5, "pna": 1e-4, "graphcast": 1e-4,
            "dimenet": 1e-4}
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SEGMENT_KERNELS = ("reduce_level",)
GRAD_KERNELS = ("ties_first", "ties_level", "grad_flat")
GATHER_OPS = ("aten::index_select", "aten::index", "aten::gather")
SEGMENT_REPS = 20
# phase 15: GNN training at the same 13 cells
GNN_TRAIN_REPS = {("gcn-cora", "ogb_products"): 3,
                  ("graphcast", "minibatch_lg"): 2,
                  ("dimenet", "minibatch_lg"): 2}
GNN_TRAIN_REPS_DEFAULT = 5
# the aggregations whose backward is held against float64 plain and timed:
# indices into the cell's forward segment_reduce calls (PNA's layer 0: #2
# max, #3 min)
GRAD_CHECKS = {("gcn-cora", "ogb_products"): (0, 1),
               ("pna", "minibatch_lg"): (2, 3),
               ("graphcast", "minibatch_lg"): (0,),
               ("dimenet", "molecule"): (0,)}
GRAD_RTOL = 1e-5               # the backward against its float64 plain
GNN_TRAIN_PROFILES = {("gcn-cora", "ogb_products"),
                      ("graphcast", "minibatch_lg")}
TRAIN_SMOKE_STEPS = 3
QUEUE_CYCLES_PER_CALL = 200_000   # a sleep that outlasts the host's queueing
# phase 16: DIN training at train_batch (B 65,536, the full tables)
DIN_TRAIN_STEPS = 8
DIN_TRAIN_SEED = 0             # RecsysStream's seed for the checked batch
BAG_KERNELS = ("bag_gather", "bag_shared")
BAG_GRAD_KERNELS = ("bag_grad_weights", "bag_table_first", "bag_table_level")
BAG_GRAD_REPS = 10
BAG_SHORT_SEGMENT = (2, 64)    # a segment whose last position a broken
                               # backward drops: its length in this range
# the README's command, at the entry point's defaults (batch 8, lr 3e-4)
DIN_CLI = ("--arch", "din", "--preset", "smoke", "--steps", "30",
           "--compress-grads", "--fail-at", "15:0", "--ckpt-every", "10",
           "--log-every", "5")
# phase 11: the serving daemon on the paper path (launch/serve.py)
TUNE_PAD_MULTIPLES = (8, 16, 32)
TUNE_B = 8
TUNE_REPEATS = 20
PHASE5_K2_US = {1: 24.22, 8: 77.24}   # K2's device time (PERF.md §6)
DAEMON_SCALE = 1              # load("web-stanford", scale=1): full size
DAEMON_JOBS = 8
DAEMON_QUERIES = 64
DAEMON_CORES = 16
DAEMON_PROBE = 16              # queries that measure t_avg for the deadline
DAEMON_SPREAD = 6              # deadline = X t_avg / 6: Lemma 2 asks >= 6
DAEMON_RATE = 8.0              # Poisson arrivals a virtual second
DAEMON_CACHE = 256
DAEMON_SNAPSHOT_EVERY = 20
DAEMON_CHAOS = "seed=7,failures=1,slowdowns=2,horizon=1.0"
DAEMON_MUTATIONS = 4
DAEMON_MUTATION_EDGES = 256
DAEMON_MUTATION_RATE = 8.0
SHARD_K = 4                    # phase 12: shards of one mesh on the card
SHARD_QUERIES = 64
SHARD_LANES = 1 << 20          # the paper path's calibrated lane count
SHARD_POKEC_QUERIES = 8
SHARD_RTOL = 1e-4              # sharded pi against one device's
SHARD_REPS = 20
CRASH_CHAOS = ("seed=7,failures=1,slowdowns=2,crashes=2,horizon=3,"
               "crash_span=300")
# phase 8: a dense graph at Pokec's order and size (paper Table I)
POKEC_N = 1_632_803
POKEC_M = 30_622_564
POKEC_SOURCES = 4              # exact PPR through K4, and FORA's check
POKEC_QUERIES = 256
# FORA's push threshold at this size, of its default: at the default, the
# walks FORA's guarantee asks for (omega * r_sum, omega = 2.29e8 at
# n = 1.6M) are ~17 times the walk-lane cap (ForaParams.max_walks = 2^22)
# and the error rose to 0.545 > eps (PERF.md, PR 16); pushing deeper
# leaves less residual, so the guarantee's walks fit under the cap
POKEC_RMAX_SCALE = 1 / 32
# phase 8's deadline loop: D&A_REAL at a deadline set for LOOP_CORES
# cores (the probe's t_avg with LOOP_SLACK) at the JAX example's d; one
# lane of the slot stalled by STALL t_hat, as the example's 1 s lane
LOOP_CORES = 4
LOOP_SLACK = 0.25
LOOP_D = 0.9
STALL_LANE = 1
STALL = 20
# phase 9: the engine on the paper path at full size, the fold's checks
ENGINE_LANES = 8
ENGINE_QUERIES = 256
ENGINE_SWEEPS = 4
ENGINE_PROFILED = 16           # queries of the profiled engine run
FOLD_BS = (1, 3, 8)
FOLD_BLOCK = 8192              # a broken fold drops each block's last 32 lanes
FOLD_SCALE_CUT = 32            # a broken fold on a scale 2^32 too coarse
FOLD_LAUNCHES: dict[str, int] = {}   # the fold's launches by path, as run
# engine row against its chunked answer: the sliced push's rtol, and at
# most MOVED_MAX walkers' weight r_sum / w_eff on each entry above it (a
# walk start that a push at another batch width put across a CDF boundary)
ENGINE_RTOL = 1e-4
MOVED_MAX = 4
# phase 10: seeded edge batches on the same graph
DYN_BATCHES = 8
DYN_BATCH_EDGES = 256
DYN_RTOL = 1e-4                # the sliced push's tolerance
# tests/test_kernels.py::test_ell_spmv_sweep's shapes (n, K)
SPMV_SWEEP = [(64, 4), (100, 7), (512, 16), (300, 130), (1000, 33)]
# K1 and K4 on non-left-packed tables: EDGE_N rows (not a multiple of the
# rows a warp takes), each K, K1 at each B
EDGE_N = 1003
EDGE_KS = (1, 7, 33, 48, 130)
EDGE_BS = (1, 3, 4, 33, 64)
# a dense graph past 2^19 nodes: K1's frontier bitmap at two nodes a bit
HALF_N = 600_000
# sweeps of one Pokec-order push whose residuals K1 runs on: a small
# frontier (~7% of the nodes), all of them, and ~15% late in the push
RESIDUAL_SWEEPS = (4, 6, 27)
# uniform tables at Pokec's mean degree on which phase 5 times K1's two
# routes over a push, between the dense path's n and the uniform table's
ROUTE_SIZES = (16_384, 131_072)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after two warm calls. For a short kernel this is
    the host's launch pace, not the kernel's time."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn``: the durations of every
    kernel and copy it ran on the card over ``reps`` calls, as
    ``torch.profiler`` records them, summed and divided by ``reps``."""
    return sum(device_split_us(fn, reps).values()) / 1e3


def device_split_us(fn, reps: int) -> dict[str, float]:
    """Mean device microseconds per call of ``fn``, by kernel name, from a
    window that recorded device time (see :func:`profile_window`)."""
    fn()
    by_name = profile_window(
        fn, reps, lambda b: sum(sum(ts) for ts in b.values()) > 0)
    return {k: sum(ts) / reps for k, ts in by_name.items()}


def device_us(prof) -> dict[str, list[float]]:
    """Microseconds of each device event in a finished profile, by name."""
    from torch.autograd import DeviceType

    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return by_name


def err_ratio(out, want, rtol: float) -> tuple[float, float]:
    """(max |out - want|, the largest |out - want| over its limit
    ``rtol * |want| + ATOL_FRAC * max|want|``); want is float64."""
    import torch

    diff = (out.double() - want).abs()
    limit = rtol * want.abs() + ATOL_FRAC * float(want.abs().max())
    ratio = diff / limit.clamp_min(torch.finfo(torch.float64).tiny)
    return float(diff.max()), float(ratio.max())


def f64(*ts):
    return [None if t is None else t.double() for t in ts]


def mass_rows(gen, B: int, n: int, device):
    """(B, n) float32 rows that each sum to 1 — the shape of a residual."""
    import torch

    u = torch.rand((B, n), generator=gen, device=device) ** 3
    return u / u.sum(dim=1, keepdim=True)


def spmm_cost(nnz: int, n: int, B: int, rows: int, fused: bool,
              sliced: bool) -> tuple[float, str]:
    """Least time (ms) for one SpMM on this input: every nonzero cell read
    once (int32 id + bool mask + f32 weight), x and the output once, the
    threshold and row_map once; two flops per nonzero and batch column."""
    nbytes = nnz * 9 + 2 * n * B * 4 + (n * 4 if fused else 0) \
        + (rows * 4 if sliced else 0)
    flops = 2 * nnz * B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def gather_cost(B: int, L: int, n: int, W: int) -> tuple[float, str]:
    """Least time (ms) for one K3 call on these shapes: the (B, n) output
    written once, starts and weights read once, and per lane two random
    4-byte reads (budget, endpoint) of one 32-byte sector each, each stream
    capped at its array's size (n budgets, n * W endpoints); one add per
    lane."""
    nbytes = B * n * 4 + B * L * 8 + min(B * L * 32, n * 4) \
        + min(B * L * 32, n * W * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, B * L / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def drop_last_lane(endpoints, budget, starts, weights):
    """Weights with the highest valid lane of every (row, endpoint) cell
    zeroed: what a gather that loses one lane per cell would fold."""
    import torch

    B, L = starts.shape
    n = endpoints.shape[0]
    lane = torch.arange(L, device=starts.device)
    s = starts.long()
    valid = lane[None] < budget[s]
    cell = endpoints[s, lane[None]].long() + \
        torch.arange(B, device=s.device)[:, None] * n
    last = torch.full((B * n,), -1, dtype=torch.long, device=s.device)
    last.scatter_reduce_(0, cell[valid], lane.expand(B, L)[valid], "amax")
    return torch.where(valid & (lane[None] == last[cell]), 0.0, weights)


def drop_last_of_range(endpoints, budget, starts, weights, cells: int):
    """Weights with the highest valid lane of every (row, range of
    ``cells`` cells) zeroed: what a K3 fold block that loses the last lane
    of its range would fold."""
    import torch

    B, L = starts.shape
    n = endpoints.shape[0]
    blocks = -(-n // cells)
    lane = torch.arange(L, device=starts.device)
    s = starts.long()
    valid = lane[None] < budget[s]
    key = endpoints[s, lane[None]].long() // cells + \
        torch.arange(B, device=s.device)[:, None] * blocks
    last = torch.full((B * blocks,), -1, dtype=torch.long, device=s.device)
    last.scatter_reduce_(0, key[valid], lane.expand(B, L)[valid], "amax")
    return torch.where(valid & (lane[None] == last[key]), 0.0, weights)


def fold_breaks(mask, row_map, fold):
    """(label, mask) for each path of K2's fold, the mask of a kernel that
    breaks that path: a short row's in-warp fold losing the second half of
    each slice (the lanes past the first), a warp-item row losing its last
    slice, a hub losing its last slice, and a hub losing its last chunk."""
    import torch

    n = fold.row_ptr.shape[0] - 1
    real = row_map < n
    r = torch.where(real, row_map, 0).long()
    lo = fold.row_ptr[r].long()
    slices = (fold.row_ptr[r + 1] - fold.row_ptr[r]).long()
    v = torch.arange(row_map.shape[0], device=mask.device)
    last = real & (v == lo + slices - 1)
    short = real & (slices <= fold.short_slices)
    item = real & (slices > fold.short_slices) & \
        (slices <= fold.chunk_slices)
    hub = real & (slices > fold.chunk_slices)
    cs = fold.chunk_slices
    last_chunk = hub & (v - lo >= (slices - 1) // cs * cs)
    half = torch.arange(mask.shape[1], device=mask.device) >= \
        mask.shape[1] // 2
    return [("short rows: each slice's second half",
             mask & ~(short[:, None] & half[None])),
            ("warp-item rows: last slice", mask & ~(item & last)[:, None]),
            ("hubs: last slice", mask & ~(hub & last)[:, None]),
            ("hubs: last chunk", mask & ~last_chunk[:, None])]


def drop_last_cell(mask):
    """The mask with each row's last live cell cleared: what an SpMV that
    loses one cell per row would sum."""
    import torch

    K = mask.shape[1]
    last = K - 1 - torch.flip(mask, dims=[1]).float().argmax(dim=1)
    rows = torch.nonzero(mask.any(dim=1)).reshape(-1)
    out = mask.clone()
    out[rows, last[rows]] = False
    return out


def extent_cut(mask, extent):
    """The mask with every cell at or past ``extent`` of its row cleared:
    what a kernel reading rows only up to that extent would sum."""
    import torch

    cols = torch.arange(mask.shape[1], device=mask.device)
    return mask & (cols[None] < extent[:, None])


def row_threshold(nbr, mask, x, w, thr):
    """K1 with the push threshold read at the output row instead of the
    source: ``sum_j mask * w * x[b, src] * [x[b, src] > thr[i]]``."""
    import torch

    gathered = x[:, nbr.long()]                    # (B, n, K)
    gathered = torch.where(gathered > thr[None, :, None], gathered, 0.0)
    return torch.einsum("nk,bnk->bn", mask.to(x.dtype) * w, gathered)


def edge_table(gen, n: int, K: int, dev):
    """A dense (n, K) table whose random mask is not left-packed
    (nonnegative weights, non-zero under a false mask too): row 0 and the
    last row with no live cell, row 1 with only its last column live."""
    import torch

    nbr = torch.randint(0, n, (n, K), generator=gen, device=dev,
                        dtype=torch.int32)
    mask = torch.rand((n, K), generator=gen, device=dev) < 0.6
    mask[0] = False
    mask[1] = False
    mask[1, K - 1] = True
    mask[n - 1] = False
    return nbr, mask, torch.rand((n, K), generator=gen, device=dev)


def csr_of(nbr, msk, w, rm, n: int):
    """The push table as an (n, n) CSR matrix for ``torch.sparse.mm``, the
    library yardstick of K1, K2 and K4: row dst, column the neighbour."""
    import torch

    keep = msk.reshape(-1)
    dst = (torch.arange(nbr.shape[0], device=nbr.device) if rm is None
           else rm.long())[:, None].expand(nbr.shape).reshape(-1)
    return torch.sparse_coo_tensor(
        torch.stack([dst[keep], nbr.reshape(-1)[keep].long()]),
        w.reshape(-1)[keep], (n, n)).coalesce().to_sparse_csr()


def profile_queries(graph, count: int, walk_index=None, params=None) -> None:
    """Where a paper-path query's time goes: ``count`` measured queries
    under ``torch.profiler``, device time summed by kernel name, and the
    share of the wall time the card was idle. ``params`` defaults to
    ``ForaParams(epsilon=0.5)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ppr import ForaExecutor, ForaParams, PprWorkload

    ex = ForaExecutor(workload=PprWorkload(graph, count, seed=1),
                      params=params or ForaParams(epsilon=0.5),
                      walk_index=walk_index, device="cuda")
    ex.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = ex(list(range(count)))
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = device_us(prof)
    busy = sum(sum(v) for v in by_name.values())
    print(f"  profile: {count} queries, wall {wall_us / 1e3:.2f} ms, "
          f"per query {stats.t_avg * 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share "
          f"{(1 - busy / wall_us) if wall_us else float('nan'):.3f}")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    for name, ts in top:
        print(f"    {sum(ts) / 1e3:9.3f} ms {len(ts):7d}x "
              f"{sum(ts) / len(ts):8.2f} us  {name[:90]}")


def limit_ratio(out, want, limit) -> tuple[float, float]:
    """(max |out - want|, the largest |out - want| / limit); want and
    limit are float64."""
    import torch

    diff = (out.double() - want).abs()
    ratio = diff / limit.clamp_min(torch.finfo(torch.float64).tiny)
    return float(diff.max()), float(ratio.max())


def attention_limit(q, k, want, mag):
    """K6's limit against the float64 plain version: the output rounded to
    q's type (ATTN_RTOL of |want|) plus float32 accumulation along the keys
    and the head dim, (Skv + Dh + 8) * 2^-24 of the magnitudes
    ``mag = sum_j p_j |v_j|`` (the plain version run on |v|)."""
    return ATTN_RTOL[str(q.dtype)] * want.abs() \
        + (k.shape[1] + k.shape[3] + 8) * 2.0**-24 * mag


def plain_slices(q, k, v, causal: bool, q_offset: int):
    """K6's float64 plain version of a call and its magnitudes (the plain
    version on |v|), a slice of KV heads (with their query heads) at a
    time, so that each slice's float64 scores stay under
    PLAIN_SLICE_BYTES: yields (the slice's query heads, want, mag). Heads
    are independent, so the slices make up the whole call."""
    from repro_torch.kernels import ref

    B, Sq, Hq, _ = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    step = max(1, min(Hkv, PLAIN_SLICE_BYTES
                      // (B * group * Sq * k.shape[1] * 8)))
    for h0 in range(0, Hkv, step):
        h1 = min(Hkv, h0 + step)
        heads = slice(h0 * group, h1 * group)
        qs, ks, vs = (t.double() for t in (q[:, :, heads], k[:, :, h0:h1],
                                           v[:, :, h0:h1]))
        want = ref.flash_attention_ref(qs, ks, vs, causal=causal,
                                       q_offset=q_offset)
        mag = ref.flash_attention_ref(qs, ks, vs.abs(), causal=causal,
                                      q_offset=q_offset)
        yield heads, want, mag


def attention_cost(B: int, Sq: int, Hq: int, Hkv: int, Dh: int, Skv: int,
                   causal: bool, q_offset: int, elem: int
                   ) -> tuple[float, str]:
    """Least time (ms) for one K6 call on these shapes: 4 Dh flops per
    visible (query, key) pair at the dense bf16 tensor-core peak; q and the
    output, and the keys and values some query sees, each moved once."""
    if causal:
        rows = np.arange(Sq) + q_offset
        pairs = int(np.minimum(rows + 1, Skv).sum())
        seen = min(Skv, q_offset + Sq)
    else:
        pairs, seen = Sq * Skv, Skv
    flops = 4.0 * Dh * B * Hq * pairs
    nbytes = elem * Dh * (2 * B * Sq * Hq + 2 * B * seen * Hkv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def bag_cost(table, ids, weights) -> tuple[float, str]:
    """Least time (ms) for one K5 call on these inputs: ids and weights as
    they lie read once (a broadcast history once), each distinct gathered
    row once in whole 32-byte sectors, the (B, d) output written once; one
    multiply-add per gathered element."""
    B, L = weights.shape
    d = table.shape[1]
    id_bytes = 4 * (L if ids.stride(0) == 0 else B * L)
    rows = int(ids.unique().numel())
    nbytes = id_bytes + 4 * B * L + rows * 32 * -(-4 * d // 32) + 4 * B * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * B * L * d / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def profile_calls(label: str, fn, calls: int = 1) -> None:
    """Where a path's time goes: ``calls`` calls of ``fn`` under
    ``torch.profiler``, device time summed by kernel name, and the share of
    the wall time the card was idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = device_us(prof)
    busy = sum(sum(v) for v in by_name.values())
    print(f"  profile {label}: {calls} calls, wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall_us:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, ts in top:
        print(f"    {sum(ts) / 1e3:9.3f} ms {len(ts):6d}x "
              f"{sum(ts) / len(ts):10.2f} us  {name[:90]}")


def flushing(fn, flush):
    """``fn`` after overwriting ``flush`` (larger than the 50 MB L2), so
    that each call finds its inputs in device memory, as a caller between
    other work would. The overwrite runs as a kernel whose name contains
    FLUSH_KERNEL, which the timings below leave out."""
    def run():
        flush.zero_()
        return fn()
    return run


def profile_window(fn, reps: int, usable) -> dict[str, list[float]]:
    """Device microseconds by kernel name over ``reps`` calls of ``fn``
    under ``torch.profiler``. A window now and then comes back without some
    or all of its device events; one that ``usable`` refuses is taken again,
    up to PROFILE_TRIES times, before the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = device_us(prof)
        if usable(by_name):
            return by_name
        print(f"  (profile window over {reps} calls lost its device events;"
              f" profiling again)")
    raise SmokeFailure("torch.profiler keeps losing device events")


def kernel_launch_ms(fn, reps: int, kernel: str) -> tuple[float, int]:
    """(mean device ms of one launch of the CUDA kernel whose name contains
    ``kernel``, launches recorded) over ``reps`` calls of ``fn``: a mean
    over the launches recorded, so a window that loses some is still
    right."""
    def launches(by_name):
        return [t for name, ts in by_name.items() if kernel in name
                for t in ts]

    ts = launches(profile_window(fn, reps, lambda b: bool(launches(b))))
    return sum(ts) / len(ts) / 1e3, len(ts)


def k6_call_ms(fn, reps: int, per_call: int) -> tuple[float, int]:
    """(mean device ms of one K6 call, launches recorded) over ``reps``
    calls of ``fn``: every K6 kernel a call launches (route A's, or route
    B's split pass and its merge, each once a call) by the mean of its
    recorded launches, summed; the L2 flush left out. A window counts when
    it recorded ``per_call`` distinct K6 kernels: a window can lose some of
    its device events, which a mean over those recorded survives."""
    def k6(by_name):
        return {name: ts for name, ts in by_name.items()
                if any(k in name for k in K6_KERNELS)}

    got = k6(profile_window(fn, reps, lambda b: len(k6(b)) == per_call))
    return (sum(sum(ts) / len(ts) for ts in got.values()) / 1e3,
            sum(len(ts) for ts in got.values()))


def attention_key_end(q, k, v, key_end):
    """Plain attention (float32, GQA folding as K6) in which query row i
    sees the keys j < key_end[i]: the broken versions' stand-in."""
    import torch

    B, Sq, Hq, Dh = q.shape
    group = Hq // k.shape[2]
    kr = k.float().repeat_interleave(group, dim=2)
    vr = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / Dh ** 0.5
    ki = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(ki[None, :] >= key_end[:, None], -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        vr).to(q.dtype)


def call_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn``, built with :func:`flushing`: the
    sum of every kernel it runs but the flush over ``reps`` calls, divided
    by ``reps``. A window counts when it recorded the flush, and, for a
    call that keeps the card busy for a millisecond or more, when its sum
    is at least half the CUDA-event time of a call."""
    ev = events_ms(fn, max(2, reps))

    def work(by_name):
        return sum(sum(ts) for name, ts in by_name.items()
                   if FLUSH_KERNEL not in name) / reps / 1e3

    def usable(by_name):
        flushed = any(FLUSH_KERNEL in name for name in by_name)
        return flushed and (ev < 1.0 or work(by_name) >= 0.5 * ev)

    return work(profile_window(fn, reps, usable))


def sdpa(q, k, v, causal: bool, q_offset: int):
    """``F.scaled_dot_product_attention`` on the same function, in the
    (B, S, H, Dh) layout: a yardstick for K6, on no path of the port.
    With ``q_offset`` a decode row (Sq = 1) sees the first q_offset + 1
    keys."""
    import torch.nn.functional as F

    Hq, Hkv = q.shape[2], k.shape[2]
    if causal and q_offset:
        if q.shape[1] != 1:
            raise ValueError("the yardstick takes q_offset at Sq = 1 only")
        k, v, causal = k[:, :q_offset + 1], v[:, :q_offset + 1], False
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=Hq != Hkv).transpose(1, 2)


def layer0_qkv(params, cfg, tokens, pos, cos, sin):
    """Layer 0's attention inputs for ``tokens`` at positions ``pos``: q,
    k (rotated) and v, each (B, n, H, Dh), as ``transformer._attention``
    makes them."""
    from repro_torch.models import transformer
    from repro_torch.models.common import apply_rope, rms_norm

    a = transformer.layer_params(params, 0)
    x = rms_norm(transformer._embed(params, cfg, tokens),
                 transformer.layer_params(params, 0)["ln1"], cfg.norm_eps)
    q, k, v = x @ a["attn"]["wq"], x @ a["attn"]["wk"], x @ a["attn"]["wv"]
    if cfg.qkv_bias:
        q, k, v = (q + a["attn"]["bq"], k + a["attn"]["bk"],
                   v + a["attn"]["bv"])
    shape = (tokens.shape[0], tokens.shape[1], -1, cfg.head_dim)
    return (apply_rope(q.reshape(shape), cos, sin, pos),
            apply_rope(k.reshape(shape), cos, sin, pos), v.reshape(shape))


def k6_check(label, q, k, v, causal, off, sms: int, stats: dict,
             broken=()) -> None:
    """K6 at these inputs against its float64 plain version (one slice of
    KV heads at a time): the route the rule picks, taken and printed; the
    limit held; a second launch with the same bits; each broken version,
    a (label, output) pair, refused."""
    import torch

    from repro_torch.kernels import flash_attention

    torch.cuda.synchronize()
    before = dict(flash_attention.LAUNCHES)
    out = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                               q_offset=off)
    torch.cuda.synchronize()
    way = [name[len("flash_attention_"):] for name, n
           in flash_attention.LAUNCHES.items()
           if n != before[name] and name != "flash_attention"]
    want_way = flash_attention.route(q.dtype, q.shape[1], q.shape[2],
                                     k.shape[2], q.shape[3])
    check(way == [want_way], f"K6 {label}: went through {way}, the rule "
          f"says {want_way}")
    if want_way == "split":
        way_label = "B, {} split(s)".format(flash_attention.split_plan(
            q.shape[0], k.shape[2], q.shape[1] * q.shape[2] // k.shape[2],
            flash_attention.visible_keys(q.shape[1], k.shape[1], causal,
                                         off), sms))
    else:
        way_label = "A"
    err = ratio = top = 0.0
    refused = [0.0] * len(broken)
    for heads, want, mag in plain_slices(q, k, v, causal, off):
        limit = attention_limit(q, k, want, mag)
        e, r = limit_ratio(out[:, :, heads], want, limit)
        err, ratio = max(err, e), max(ratio, r)
        top = max(top, float(want.abs().max()))
        for i, (_, got) in enumerate(broken):
            refused[i] = max(refused[i],
                             limit_ratio(got[:, :, heads], want, limit)[1])
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    again = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                                 q_offset=off)
    print(f"  flash_attention {label:44s} route {way_label:14s} "
          f"max_abs_err={err:.3e} max|want|={top:.3e} err/limit="
          f"{ratio:.4f} {'ok' if ratio <= 1 else 'FAIL'}")
    check(out.shape == q.shape and out.dtype == q.dtype,
          f"K6 {label}: shape or dtype")
    check(ratio <= 1.0, f"K6 {label}: error {err} above the limit "
          f"(ratio {ratio})")
    check(bool(torch.equal(out, again)),
          f"K6 {label}: a second launch gave other bits")
    for (bad, _), r in zip(broken, refused):
        print(f"  flash_attention {'broken: ' + bad:44s} "
              f"err/limit={r:.4g} {'refused' if r > 1 else 'PASSED'}")
        check(r > 1.0, f"K6: the check passes a broken kernel ({bad})")


def check_sdpa(label: str, q, k, v, off: int) -> None:
    """``F.scaled_dot_product_attention`` at a causal call against K6's
    float64 plain version, before it serves as K6's yardstick."""
    got, ratio = sdpa(q, k, v, True, off), 0.0
    for heads, want, mag in plain_slices(q, k, v, True, off):
        # its probabilities are rounded to bf16 before the value product
        ratio = max(ratio, limit_ratio(
            got[:, :, heads], want,
            ATTN_RTOL[str(q.dtype)] * want.abs() + 2.0**-7 * mag)[1])
    check(ratio <= 1.0, f"the SDPA yardstick disagrees at {label}")


def k6_splits(q, k, off: int, sms: int) -> int:
    """Key splits of a causal K6 call: 1 on route A."""
    from repro_torch.kernels import flash_attention

    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    if flash_attention.route(q.dtype, Sq, Hq, Hkv, Dh) == "mma":
        return 1
    return flash_attention.split_plan(
        B, Hkv, Sq * Hq // Hkv,
        flash_attention.visible_keys(Sq, k.shape[1], True, off), sms)


def k6_times(label: str, q, k, v, off: int, reps: int, flush, card: str,
             sms: int):
    """K6's device time at a path's causal shape, each call after an L2
    flush (and L2 warm), beside its bound, the float32 plain version's and
    ``F.scaled_dot_product_attention``'s, which is first held against the
    float64 plain version. Returns (ms, plain_ms, bound, bound_by,
    sdpa_ms)."""
    from repro_torch.kernels import flash_attention, ref

    B, Sq, Hq, Dh = q.shape
    kern = lambda: flash_attention.flash_attention_cuda(  # noqa: E731
        q, k, v, causal=True, q_offset=off)
    lib = lambda: sdpa(q, k, v, True, off)  # noqa: E731
    check_sdpa(label, q, k, v, off)
    splits = k6_splits(q, k, off, sms)
    per_call = 2 if splits > 1 else 1      # route B's split and merge
    ms, seen = k6_call_ms(flushing(kern, flush), reps, per_call)
    warm, _ = k6_call_ms(kern, reps, per_call)
    plain_ms = call_ms(flushing(lambda: ref.flash_attention_ref(
        q, k, v, causal=True, q_offset=off), flush), max(2, reps // 10))
    lib_ms = call_ms(flushing(lib, flush), reps)
    bound, by = attention_cost(B, Sq, Hq, k.shape[2], Dh, k.shape[1], True,
                               off, 2)
    print(f"  flash_attention {label} B={B} Sq={Sq} Skv={k.shape[1]} "
          f"q_offset={off}: kernel {ms * 1e3:10.2f} us ({seen} launches in "
          f"{reps} calls, {splits} split(s); L2 warm {warm * 1e3:10.2f} us)"
          f"  bound {bound * 1e3:8.2f} us ({by})  plain f32 "
          f"{plain_ms * 1e3:10.2f} us  sdpa {lib_ms * 1e3:9.2f} us  [{card}]")
    return ms, plain_ms, bound, by, lib_ms


def k6_event_times(label: str, q, k, v, off: int, reps: int, card: str,
                   sms: int) -> None:
    """K6's and ``F.scaled_dot_product_attention``'s ms a causal call by
    CUDA events around back-to-back calls (L2 warm; each call takes 50 us
    or more, above the host's pace), beside K6's bound; SDPA held against
    the float64 plain version first. Phase 13 times so: late in the whole
    run torch.profiler drops device events window after window."""
    from repro_torch.kernels import flash_attention

    B, Sq, Hq, Dh = q.shape
    check_sdpa(label, q, k, v, off)
    ms = events_ms(lambda: flash_attention.flash_attention_cuda(
        q, k, v, causal=True, q_offset=off), reps)
    lib_ms = events_ms(lambda: sdpa(q, k, v, True, off), reps)
    bound, by = attention_cost(B, Sq, Hq, k.shape[2], Dh, k.shape[1], True,
                               off, 2)
    print(f"  flash_attention {label} B={B} Sq={Sq} Skv={k.shape[1]} "
          f"q_offset={off}: kernel {ms * 1e3:10.2f} us by events (L2 warm, "
          f"{k6_splits(q, k, off, sms)} split(s))  bound {bound * 1e3:8.2f} "
          f"us ({by})  sdpa {lib_ms * 1e3:9.2f} us by events  [{card}]")


def phase6_lm(dev, gen, card: str) -> dict:
    """K6 and gemma-2b serving at full width and depth."""
    import torch

    from repro_torch.configs import LM_SHAPES, get_arch
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.models import transformer
    from repro_torch.models.common import rope_frequencies

    arch = get_arch("gemma-2b")
    cfg = arch.cfg
    B, S, steps = LM_BATCH, LM_PROMPT, LM_DECODE_STEPS
    Smax = S + LM_CACHE_SLACK
    print(f"phase 6: gemma-2b serving through K6 (flash attention), card "
          f"{card}")
    pre, dec = LM_SHAPES["prefill_32k"], LM_SHAPES["decode_32k"]
    full_cache = cfg.n_layers * 2 * dec["batch"] * dec["seq"] \
        * cfg.n_kv_heads * cfg.head_dim * 2
    print(f"  cut: prefill_32k B={pre['batch']} S={pre['seq']} -> B={B} "
          f"S={S}; decode_32k B={dec['batch']} cache {dec['seq']} -> B={B} "
          f"cache {Smax}, {steps} greedy steps (decode_32k's cache alone "
          f"is {full_cache / 1e9:.1f} GB beside "
          f"{cfg.param_count * 2 / 1e9:.2f} GB of weights); width and depth "
          f"as published")
    t0 = time.perf_counter()
    params = arch.init_params(gen, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.parameters())
    check(n_params == cfg.param_count == GEMMA_PARAMS,
          f"gemma-2b has {n_params} parameters, config {cfg.param_count}")
    print(f"  init: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} "
          f"query heads on {cfg.n_kv_heads} KV head, Dh {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}: {n_params} "
          f"parameters, {n_params * 2 / 1e9:.2f} GB, "
          f"{time.perf_counter() - t0:.2f}s")
    prompt = arch.make_inputs("prefill_32k", gen, dev, batch=B, seq=S)
    prefill = arch.build_step("prefill_32k")
    decode = arch.build_step("decode_32k")
    prefill(params, {"tokens": prompt["tokens"][:, :128]})     # warm up
    torch.cuda.synchronize()

    # the main path: prefill, then greedy decode against the cache
    flash_attention.reset_launches()
    t0 = time.perf_counter()
    logits, kv = prefill(params, prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    cache = transformer.make_kv_cache(cfg, B, Smax, device=dev)
    cache[:, :, :, :S] = kv
    first_token = logits.argmax(-1, keepdim=True).to(torch.int32)
    token = first_token
    step_ms, first_logits = [], None
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = decode(params, {"token": token, "kv_cache": cache,
                                "cache_len": S + t})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if first_logits is None:
            first_logits = lg
        token = lg.argmax(-1, keepdim=True).to(torch.int32)
    launches = flash_attention.LAUNCHES["flash_attention"]
    routes = {way: flash_attention.LAUNCHES[f"flash_attention_{way}"]
              for way in ("mma", "split")}
    want_launches = cfg.n_layers * (1 + steps)
    want_routes = {"mma": cfg.n_layers, "split": cfg.n_layers * steps}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    group = cfg.n_heads // cfg.n_kv_heads
    step_splits = [flash_attention.split_plan(B, cfg.n_kv_heads, group,
                                              S + t + 1, sms)
                   for t in range(steps)]
    print(f"  prefill B={B} S={S}: {t_prefill:.3f}s, "
          f"{B * S / t_prefill:.0f} tokens/s; decode {steps} steps: "
          f"{np.mean(step_ms):.3f} ms a step mean, "
          f"{np.median(step_ms):.3f} median, {max(step_ms):.3f} max "
          f"({B / np.mean(step_ms) * 1e3:.0f} tokens/s); K6 launches "
          f"{launches} (want {want_launches}): route A (mma) "
          f"{routes['mma']} (want {want_routes['mma']}), route B (split) "
          f"{routes['split']} (want {want_routes['split']}), decode's key "
          f"splits {min(step_splits)}..{max(step_splits)} on {sms} SMs")
    for kind, sid, seconds in (("prefill", "prefill_32k", t_prefill),
                               ("decode step", "decode_32k",
                                np.median(step_ms) / 1e3)):
        flops = arch.model_flops(sid, batch=B, seq=S)
        nbytes = arch.model_bytes(sid, batch=B, seq=S)
        least = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
        print(f"  {kind} roofline (configs' model_flops/model_bytes at B={B}"
              f" S={S}): {flops:.4e} flops, {nbytes:.4e} bytes, least "
              f"{least * 1e3:.3f} ms against {seconds * 1e3:.3f} ms measured"
              f" ({least / seconds:.4f} of the roofline)")
    check(bool(torch.isfinite(logits).all() and torch.isfinite(lg).all()),
          "gemma-2b: non-finite logits")
    check(launches == want_launches,
          f"gemma-2b path launched K6 {launches} times, not {want_launches}")
    check(routes == want_routes, f"gemma-2b's K6 routes {routes}, not "
          f"{want_routes}")
    check(min(step_splits) > 1, f"decode runs route B in one split: "
          f"{step_splits}")

    # layer 0's prefill q, k, v and a decode step's q against the cache
    cos, sin = rope_frequencies(cfg.head_dim, Smax, cfg.rope_theta, dev)
    pos = torch.arange(S, device=dev).expand(B, S)
    q0, k0, v0 = layer0_qkv(params, cfg, prompt["tokens"], pos, cos, sin)
    mid = S + steps // 2
    qd, _, _ = layer0_qkv(params, cfg, first_token,
                          torch.full((B, 1), mid, device=dev), cos, sin)
    stats = {"max_abs_err": 0.0}

    def attn_check(label, q, k, v, causal, off, broken=()):
        k6_check(label, q, k, v, causal, off, sms, stats, broken)

    print("  K6 against its float64 plain version (rtol 2^-20 float32, 2^-7 "
          "bfloat16; atol (Skv + Dh + 8) * 2^-24 * sum_j p_j |v_j|)")
    # route A without the mask on its diagonal tile: a row sees every key
    # of the tile that holds its own position
    tile_end = torch.clamp((torch.arange(S, device=dev) // MMA_KEY_TILE + 1)
                           * MMA_KEY_TILE, max=S)
    attn_check(f"gemma prefill layer 0 B={B} S={S} bf16", q0, k0, v0, True,
               0, broken=[("route A's diagonal tile unmasked",
                           attention_key_end(q0, k0, v0, tile_end))])
    ck, cv = cache[0, 0], cache[0, 1]
    check(ck.untyped_storage().data_ptr() == cache.untyped_storage()
          .data_ptr(), "the decode check must read a view of the cache")
    # route B's merge without its last split: keys [0, lo_last) alone
    dec_splits = flash_attention.split_plan(B, cfg.n_kv_heads, group, mid + 1,
                                            sms)
    lo_last = flash_attention.split_bounds(mid + 1, dec_splits)[-1][0]
    attn_check(f"gemma decode q_offset={mid} cache {Smax} (a view)", qd,
               ck, cv, True, mid,
               broken=[("q_offset ignored",
                        ref.flash_attention_ref(qd, ck, cv, causal=True,
                                                q_offset=0)),
                       (f"merge drops the last split (keys {lo_last}..)",
                        ref.flash_attention_ref(qd, ck[:, :lo_last],
                                                cv[:, :lo_last], causal=True,
                                                q_offset=mid))])
    # a GQA shape, where h % Hkv differs from h // group, and an MHA one
    for Hq, Hkv in ((8, 2), (8, 8)):
        rng = torch.Generator(device=dev).manual_seed(Hq * 10 + Hkv)
        q, k, v = (torch.randn((2, 128, h, 256), generator=rng, device=dev,
                               dtype=torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        broken = []
        if Hq != Hkv:
            perm = torch.tensor([h % Hkv for h in range(Hq)], device=dev)
            broken.append(("KV head h % Hkv", ref.flash_attention_ref(
                q, k[:, :, perm], v[:, :, perm])))
        attn_check(f"Hq={Hq} Hkv={Hkv} Dh=256 S=128 bf16", q, k, v, True, 0,
                   broken)
    # keys and values that are truly strided: one packed (B, S, 2, H, Dh)
    rng = torch.Generator(device=dev).manual_seed(7)
    packed = torch.randn((2, 300, 2, 2, 64), generator=rng, device=dev)
    q = torch.randn((2, 5, 4, 64), generator=rng, device=dev)
    attn_check("packed kv (strides of a (B,S,2,H,Dh)) f32", q,
               packed[:, :, 0], packed[:, :, 1], True, 290)
    for (Bs, Sq, Skv, Hq, Hkv, Dh, causal, off) in ATTN_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            rng = torch.Generator(device=dev).manual_seed(Sq * 1000 + Skv)
            q = torch.randn((Bs, Sq, Hq, Dh), generator=rng, device=dev,
                            dtype=dt)
            k, v = (torch.randn((Bs, Skv, Hkv, Dh), generator=rng,
                                device=dev, dtype=dt) for _ in range(2))
            attn_check(f"sweep {(Bs, Sq, Skv, Hq, Hkv, Dh)} causal={causal} "
                       f"off={off} {str(dt)[6:]}", q, k, v, causal, off)

    # decode's logits for token S equal a prefill's over S + 1 tokens
    longer = torch.cat([prompt["tokens"], first_token], dim=1)
    full_logits, _ = prefill(params, {"tokens": longer})
    scale = float(full_logits.abs().max())
    diff = float((first_logits - full_logits).abs().max())
    agree = float((first_logits.argmax(-1) == full_logits.argmax(-1))
                  .float().mean())
    print(f"  decode logits at position {S} vs prefill over {S + 1} "
          f"tokens: max|diff| {diff:.4e} (limit {LM_LOGIT_TOL} * "
          f"{scale:.4e}), argmax agreement {agree:.2f}")
    check(diff <= LM_LOGIT_TOL * scale,
          f"decode and prefill disagree: {diff} > {LM_LOGIT_TOL} * {scale}")

    # times at the path's shapes, each call after an L2 flush
    del full_logits, longer, kv
    torch.cuda.empty_cache()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = [k6_times(label, q, k, v, off, reps, flush, card, sms)
            for label, (q, k, v, off, reps) in (
                ("prefill", (q0, k0, v0, 0, 5)),
                ("decode", (qd, ck, cv, mid, 50)))]
    del flush
    profile_calls(f"gemma-2b prefill B={B} S={S}",
                  lambda: prefill(params, prompt))
    profile_calls(f"gemma-2b decode B={B} at {S}",
                  lambda: decode(params, {"token": first_token,
                                          "kv_cache": cache,
                                          "cache_len": S}), calls=4)
    ms, plain_ms, bound, by, lib_ms = rows[0]
    return {"name": "flash_attention", "launches": launches,
            "max_abs_err": stats["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def phase7_din(dev, gen, card: str) -> dict:
    """K5 and DIN serving with the full-size tables."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import DIN_SHAPES, get_arch
    from repro_torch.kernels import embedding_bag, ref
    from repro_torch.models.recsys import din

    arch = get_arch("din")
    cfg = arch.cfg
    print(f"phase 7: DIN serving through K5 (embedding bag), card {card}")
    t0 = time.perf_counter()
    params = arch.init_params(gen, dev)
    torch.cuda.synchronize()
    table_bytes = (params.item_emb.numel() + params.cat_emb.numel()) * 4
    print(f"  init: tables {tuple(params.item_emb.shape)} + "
          f"{tuple(params.cat_emb.shape)} float32, {table_bytes / 1e6:.1f}"
          f" MB, {time.perf_counter() - t0:.2f}s")
    check(table_bytes == DIN_TABLE_BYTES,
          f"DIN tables are {table_bytes} bytes")
    serve_b = arch.make_inputs("serve_p99", gen, dev)
    ret_b = arch.make_inputs("retrieval_cand", gen, dev)
    n_cand = DIN_SHAPES["retrieval_cand"]["candidates"]
    serve = arch.build_step("serve_p99")
    unfactored = arch.build_step("retrieval_cand", block=DIN_BLOCK)
    factored = arch.build_step("retrieval_cand", block=DIN_BLOCK,
                               factored=True)
    serve(params, serve_b)
    torch.cuda.synchronize()

    # the main path: serve_p99 requests, then 1M-candidate retrieval
    embedding_bag.reset_launches()
    lat = []
    for _ in range(DIN_SERVE_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = serve(params, serve_b)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    walls = {}
    cands = {}
    for name, step in (("unfactored", unfactored), ("factored", factored)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cands[name] = step(params, ret_b)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    launches = embedding_bag.LAUNCHES["embedding_bag"]
    Bs = DIN_SHAPES["serve_p99"]["batch"]
    blocks = -(-n_cand // DIN_BLOCK)
    want_launches = 2 * (DIN_SERVE_REQUESTS + 2 * blocks)
    print(f"  serve_p99 B={Bs} L={cfg.seq_len}: {DIN_SERVE_REQUESTS} "
          f"requests, latency p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms, "
          f"{Bs / np.mean(lat) * 1e3:.0f} scores/s")
    for name, wall in walls.items():
        print(f"  retrieval_cand {name}: {n_cand} candidates in blocks of "
              f"{DIN_BLOCK}: {wall:.3f}s, "
              f"{n_cand / wall:.0f} candidates/s")
    for label, sid, cuts, seconds in (
            ("serve_p99 request", "serve_p99", {}, np.median(lat) / 1e3),
            ("retrieval_cand factored", "retrieval_cand", {},
             walls["factored"])):
        flops = arch.model_flops(sid, **cuts)
        nbytes = arch.model_bytes(sid, **cuts)
        least = max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
        print(f"  {label} roofline (configs' model_flops/model_bytes, float32"
              f" peak): {flops:.4e} flops, {nbytes:.4e} bytes, least "
              f"{least * 1e3:.3f} ms against {seconds * 1e3:.3f} ms measured"
              f" ({least / seconds:.4f} of the roofline)")
    routes = {r: embedding_bag.LAUNCHES[f"embedding_bag_{r}"]
              for r in ("gather", "shared")}
    want_routes = {"gather": 2 * DIN_SERVE_REQUESTS, "shared": 4 * blocks}
    print(f"  K5 launches {launches} (want {want_launches}): route G "
          f"{routes['gather']} (want {want_routes['gather']}), route S "
          f"{routes['shared']} (want {want_routes['shared']})")
    check(launches == want_launches,
          f"DIN path launched K5 {launches} times, not {want_launches}")
    check(routes == want_routes,
          f"DIN path's K5 routes {routes}, not {want_routes}")
    check(scores.shape == (Bs,) and bool(torch.isfinite(scores).all()),
          "serve_p99: bad scores")
    for name, c in cands.items():
        check(c.shape == (n_cand,) and bool(torch.isfinite(c).all()),
              f"retrieval {name}: bad scores")
    diff = float((cands["factored"] - cands["unfactored"]).abs().max())
    print(f"  factored vs unfactored over {n_cand} candidates: max|diff| "
          f"{diff:.3e} (atol {DIN_ATOL})")
    check(diff <= DIN_ATOL, f"factored retrieval differs by {diff}")
    # 256 candidates against one user equal score on the same pairs
    sub = {k: ret_b[k] for k in ("hist_items", "hist_cats", "hist_mask")}
    sub["cand_items"] = ret_b["cand_items"][:256]
    sub["cand_cats"] = ret_b["cand_cats"][:256]
    few = unfactored(params, sub)
    pairs = {k: sub[k].expand(256, -1) for k in ("hist_items", "hist_cats",
                                                  "hist_mask")}
    pairs["target_item"], pairs["target_cat"] = sub["cand_items"], \
        sub["cand_cats"]
    point = serve(params, pairs)
    diff = float((few - point).abs().max())
    print(f"  score_candidates on 256 vs score on the same pairs: max|diff| "
          f"{diff:.3e} (atol {DIN_ATOL}); vs the {n_cand}-candidate run's "
          f"first 256: "
          f"{float((few - cands['unfactored'][:256]).abs().max()):.3e}")
    check(diff <= DIN_ATOL, f"score_candidates and score differ by {diff}")

    # K5 against its float64 plain version, at the path's inputs
    hist_e = din._pair_embed(params, serve_b["hist_items"],
                             serve_b["hist_cats"])
    target_e = din._pair_embed(params, serve_b["target_item"],
                               serve_b["target_cat"])
    t = target_e[:, None].expand(hist_e.shape)
    with torch.no_grad():
        w_serve = params.attn(torch.cat([hist_e, t, hist_e - t,
                                            hist_e * t], -1),
                                 "sigmoid")[..., 0]
    w_serve = (w_serve * serve_b["hist_mask"]).contiguous()
    blk = DIN_BLOCK
    ids_ret = ret_b["hist_items"][0][None].expand(blk, cfg.seq_len)
    w_ret = torch.rand((blk, cfg.seq_len), generator=gen, device=dev)
    # a shared history longer than one staged pass of route S
    long_l = 2 * embedding_bag.SHARED_ITEMS + 37
    ids_long = torch.randint(0, params.item_emb.shape[0], (1, long_l),
                             generator=gen, device=dev,
                             dtype=torch.int32).expand(BAG_LONG_B, long_l)
    w_long = torch.rand((BAG_LONG_B, long_l), generator=gen, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stats = {"max_abs_err": 0.0}

    def plain64(table, ids, w):
        return ref.embedding_bag_ref(table.double(), ids, w.double())

    def bag_check(label, table, ids, w, route, broken=()):
        """K5 on ``route`` against its float64 plain version; each of
        ``broken`` (label, its float64 output) must be refused."""
        before = dict(embedding_bag.LAUNCHES)
        torch.cuda.synchronize()
        out = embedding_bag.embedding_bag_cuda(table, ids, w)
        torch.cuda.synchronize()
        taken = [r for r in ("gather", "shared")
                 if embedding_bag.LAUNCHES[f"embedding_bag_{r}"]
                 != before[f"embedding_bag_{r}"]]
        want = plain64(table, ids, w)
        limit = ids.shape[1] * 2.0**-24 * ref.embedding_bag_ref(
            table.double().abs(), ids, w.double().abs())
        err, ratio = limit_ratio(out, want, limit)
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        again = embedding_bag.embedding_bag_cuda(table, ids, w)
        print(f"  embedding_bag {label:46s} route {'+'.join(taken):6s} "
              f"max_abs_err={err:.3e} max|want|="
              f"{float(want.abs().max()):.3e} err/limit={ratio:.4f} "
              f"{'ok' if ratio <= 1 else 'FAIL'}")
        check(taken == [route], f"K5 {label}: took {taken}, not {route}")
        check(ratio <= 1.0, f"K5 {label}: error {err} above the limit "
              f"(ratio {ratio})")
        check(bool(torch.equal(out, again)),
              f"K5 {label}: a second launch gave other bits")
        for bad, bout in broken:
            _, r = limit_ratio(bout, want, limit)
            print(f"  embedding_bag {'broken: ' + bad:46s} err/limit={r:.4g}"
                  f" {'refused' if r > 1 else 'PASSED'}")
            check(r > 1.0, f"K5: the check passes a broken kernel ({bad})")

    def no_last_unit(table, ids, w, unit):
        """The plain output with its last ``unit`` columns (a row load's
        last unit) dropped."""
        out = plain64(table, ids, w)
        out[:, -unit:] = 0.0
        return out

    print("  K5 against its float64 plain version (atol L * 2^-24 * "
          "sum_l |w| |row|)")
    L = cfg.seq_len
    no_last = w_serve.clone()
    no_last[torch.arange(Bs, device=dev),
            serve_b["hist_mask"].sum(1) - 1] = 0.0
    # route G's second warp of a bag (its items l with l mod bag threads
    # in [32, 64)) dropped
    g_plan = embedding_bag.plan(Bs, L, serve_b["hist_items"].stride(0), sms)
    check(g_plan.bag_warps > 1, f"serve_p99 bags take {g_plan.bag_warps} "
          f"warp(s)")
    lane = torch.arange(L, device=dev) % (g_plan.bag_warps * 32)
    no_warp = w_serve * ((lane < 32) | (lane >= 64))
    bag_check(f"serve_p99 items B={Bs} L={L}", params.item_emb,
              serve_b["hist_items"], w_serve, "gather",
              broken=[("last history item dropped",
                       plain64(params.item_emb, serve_b["hist_items"],
                               no_last)),
                      ("weights ignored",
                       plain64(params.item_emb, serve_b["hist_items"],
                               serve_b["hist_mask"].float())),
                      ("route G: a warp's share of items dropped",
                       plain64(params.item_emb, serve_b["hist_items"],
                               no_warp)),
                      ("route G: last column unit dropped",
                       no_last_unit(params.item_emb, serve_b["hist_items"],
                                    w_serve,
                                    embedding_bag.unit_width(
                                        params.item_emb)))])
    bag_check(f"serve_p99 categories B={Bs}", params.cat_emb,
              serve_b["hist_cats"], w_serve, "gather")
    bag_check(f"retrieval block {blk} broadcast history",
              params.item_emb, ids_ret, w_ret, "shared",
              broken=[("route S: last column unit dropped",
                       no_last_unit(params.item_emb, ids_ret, w_ret, 1))])
    no_tail = w_long.clone()
    no_tail[:, embedding_bag.SHARED_ITEMS:] = 0.0
    bag_check(f"shared history B={BAG_LONG_B} L={long_l}", params.item_emb,
              ids_long, w_long, "shared",
              broken=[("route S: staging stops after the first pass",
                       plain64(params.item_emb, ids_long, no_tail))])
    for V, d, Bq, Lq in BAG_SWEEP:
        rng = torch.Generator(device=dev).manual_seed(V + Lq)
        table = torch.randn((V, d), generator=rng, device=dev)
        ids = torch.randint(0, V, (Bq, Lq), generator=rng, device=dev,
                            dtype=torch.int32)
        w = torch.rand((Bq, Lq), generator=rng, device=dev)
        bag_check(f"sweep V={V} d={d} B={Bq} L={Lq}", table, ids, w,
                  "gather")
        bag_check(f"sweep V={V} d={d} B={Bq} L={Lq} one history", table,
                  ids[:1].expand(Bq, Lq), w, "shared")

    # times of every K5 launch of the path, each call after an L2 flush;
    # the library yardstick is F.embedding_bag
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = []
    for label, (table, ids, w) in (
            (f"serve_p99 items B={Bs} L={L}",
             (params.item_emb, serve_b["hist_items"], w_serve)),
            (f"serve_p99 categories B={Bs} L={L}",
             (params.cat_emb, serve_b["hist_cats"], w_serve)),
            (f"retrieval block B={blk} broadcast ids",
             (params.item_emb, ids_ret, w_ret))):
        ids_c = ids.long().contiguous()
        kern = lambda: embedding_bag.embedding_bag_cuda(  # noqa: E731
            table, ids, w)
        plain = lambda: ref.embedding_bag_ref(table, ids, w)  # noqa: E731
        lib = lambda: F.embedding_bag(  # noqa: E731
            ids_c, table, mode="sum", per_sample_weights=w)
        want = plain64(table, ids, w)
        _, lib_ratio = limit_ratio(lib(), want, LIBRARY_BAG_RTOL
                                   * ref.embedding_bag_ref(
                                       table.double().abs(), ids,
                                       w.double().abs()))
        check(lib_ratio <= 1.0, "F.embedding_bag disagrees with K5's plain "
              "version")
        name = f"bag_{embedding_bag.route(ids.stride(0))}"
        ms, seen = kernel_launch_ms(flushing(kern, flush), 100, name)
        warm, _ = kernel_launch_ms(kern, 100, name)
        plain_ms = call_ms(flushing(plain, flush), 50)
        lib_ms = call_ms(flushing(lib, flush), 100)
        bound, by = bag_cost(table, ids, w)
        print(f"  embedding_bag {label:38s} {name} {ms * 1e3:9.2f} us "
              f"({seen} launches; L2 warm {warm * 1e3:9.2f} us)  bound "
              f"{bound * 1e3:8.2f} us ({by})  plain {plain_ms * 1e3:9.2f} us"
              f"  F.embedding_bag {lib_ms * 1e3:9.2f} us  [{card}]")
        rows.append((ms, plain_ms, bound, by, lib_ms))
    del flush
    profile_calls(f"DIN serve_p99 B={Bs}", lambda: serve(params, serve_b),
                  calls=10)
    profile_calls(f"DIN retrieval_cand factored ({n_cand} candidates)",
                  lambda: factored(params, ret_b))
    ms, plain_ms, bound, by, lib_ms = rows[0]
    return {"name": "embedding_bag", "launches": launches,
            "max_abs_err": stats["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def start_floors_build(src=FLOORS_SRC):
    """nvcc started on a measurement-only source under ``tools/``
    (``ell_floors.cu``, ``segment_floors.cu``) with the port's flags,
    beside the port's own builds. Returns (process, the library it
    writes)."""
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR.parent / "tools" / f"lib{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
         str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, out


def floors(lib_path, tables, plan, k4, card: str) -> None:
    """The two floors of K1 and K4 on a dense table (``tools/ell_floors.cu``,
    measurement only), in device time, beside K4's time and spmm_cost's
    bound: the table floor reads each row's live cells (neighbour, weight,
    mask, by 4-cell units up to the row's extent) and gathers nothing; the
    gather floor gathers x at the table's live neighbours and reads nothing
    else but their list; the hashed one gathers as many scattered floats
    and reads no list (the L2 sector rate alone); ``x[live]`` is PyTorch's
    gather of the same floats, a yardstick."""
    import ctypes

    import torch

    P, I = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(lib_path))
    for fn, args, res in (
            ("ell_table_floor_launch", [P] * 4 + [I, I, P, P], I),
            ("ell_gather_floor_launch", [P, ctypes.c_longlong, P, I, P, P],
             I),
            ("ell_floor_warps", [], I),
            ("ell_floors_error_string", [I], ctypes.c_char_p)):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
    nbr, msk, w = tables
    n, K = nbr.shape
    dev = nbr.device
    live = nbr[msk].contiguous()
    x = torch.rand(n, device=dev)
    sums = torch.empty(lib.ell_floor_warps(), device=dev)

    def run(err):
        check(err == 0, f"floor kernel: CUDA error {err} "
              f"({lib.ell_floors_error_string(err).decode()})")

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa
    table_ms = device_ms(lambda: run(lib.ell_table_floor_launch(
        nbr.data_ptr(), msk.data_ptr(), w.data_ptr(), plan.extent.data_ptr(),
        n, K, sums.data_ptr(), stream())), 50)
    gather_ms = device_ms(lambda: run(lib.ell_gather_floor_launch(
        live.data_ptr(), live.numel(), x.data_ptr(), n, sums.data_ptr(),
        stream())), 50)
    hashed_ms = device_ms(lambda: run(lib.ell_gather_floor_launch(
        None, live.numel(), x.data_ptr(), n, sums.data_ptr(), stream())), 50)
    index_ms = device_ms(lambda: x[live], 50)
    bound, by = spmm_cost(live.numel(), n, 1, n, False, False)
    print(f"  floors at n={n} K={K} ({live.numel()} live cells, device "
          f"time): table {table_ms * 1e3:.2f} us (the rows' live cells in "
          f"4-cell units, no gather); gather "
          f"{gather_ms * 1e3:.2f} us (x at the live neighbours' list); "
          f"hashed gather {hashed_ms * 1e3:.2f} us (as many scattered "
          f"floats, no list); x[live] {index_ms * 1e3:.2f} us; spmm_cost "
          f"bound {bound * 1e3:.2f} us ({by}); K4 {k4[0] * 1e3:.2f} us "
          f"[{card}]")


def k1_on_route(tables, plan, x, thr, group: int):
    """One K1 launch at B = 1 through the library on a route picked here,
    whatever ``frontier_group`` would pick: the plain route (prepare_x,
    then ell_rows) at ``group`` 0, else the frontier route with ``group``
    nodes a bit. Outside the launch counts. Returns (n, 1)."""
    import torch

    from repro_torch.kernels import ell_spmv

    nbr, msk, w = tables
    n, K = nbr.shape
    dev = nbr.device
    xm = torch.empty((n, 1), device=dev)
    bits = torch.empty(-(-n // (32 * group)), dtype=torch.int32,
                       device=dev) if group else None
    y = torch.empty((n, 1), device=dev)
    lib = ell_spmv._lib()
    err = lib.ell_spmm_dense_launch(
        nbr.data_ptr(), msk.data_ptr(), w.data_ptr(), plan.extent.data_ptr(),
        x.data_ptr(), thr.data_ptr(), xm.data_ptr(),
        None if bits is None else bits.data_ptr(), y.data_ptr(),
        x.stride(0), x.stride(1), n, n, K, 1, plan.lanes.bit_length() - 1,
        group.bit_length() - 1, torch.cuda.current_stream(dev).cuda_stream)
    check(err == 0, f"K1 (group {group}): CUDA error {err}")
    return y


def push_residuals(tables, out_degree, plan, src: int, rmax: float,
                   sweeps=None) -> dict:
    """The residuals one push from ``src`` hands K1, by sweep: the residual
    after k sweeps for each k in ``sweeps``, or for every sweep the push
    launches (its ``iters``, a multiple of the host's check interval) when
    ``sweeps`` is None. Each (1, n) float32."""
    from repro_torch.ppr import forward_push
    from repro_torch.ppr.forward_push import CHECK_EVERY, one_hot_seeds

    n = tables[0].shape[0]
    seeds = one_hot_seeds([src], n, tables[0].device)
    if sweeps is None:
        iters = int(forward_push(*tables, out_degree, seeds, alpha=0.2,
                                 rmax=rmax, plan=plan).iters)
        sweeps = range(-(-iters // CHECK_EVERY) * CHECK_EVERY)
    return {k: forward_push(*tables, out_degree, seeds, alpha=0.2,
                            rmax=rmax, max_iters=k, plan=plan).r.contiguous()
            for k in sweeps}


def timed_push_routes(label, tables, plan, thr, residuals, card: str,
                      reps: int) -> tuple[float, float]:
    """K1's device time over every launch of one push (``residuals``, as
    :func:`push_residuals` gives them) on each route, both forced through
    the library: the sum a query's push pays, the route rule's yardstick.
    Returns (frontier route, plain route) microseconds a push."""
    from repro_torch.kernels import ell_spmv

    n = tables[0].shape[0]
    group = ell_spmv.bitmap_group(n)
    xs = list(residuals.values())
    share = sum(float((x[0] > thr).double().mean()) for x in xs) / len(xs)
    front_us = sum(device_split_us(lambda: [
        k1_on_route(tables, plan, x, thr, group) for x in xs],
        reps).values())
    plain_us = sum(device_split_us(lambda: [
        k1_on_route(tables, plan, x, thr, 0) for x in xs], reps).values())
    picked = "frontier" if ell_spmv.frontier_group(n, 1) else "plain"
    print(f"  ell_spmm routes over one push, {label} n={n} "
          f"K={tables[0].shape[1]}: {len(xs)} launches, mean frontier "
          f"share {share:.4f}; frontier route ({group} node(s) a bit) "
          f"{front_us:.2f} us ({front_us / len(xs):.2f} a launch), plain "
          f"route {plain_us:.2f} us ({plain_us / len(xs):.2f} a launch); "
          f"the rule picks {picked} [{card}]")
    return front_us, plain_us


def timed_residuals(tables, plan, thr, residuals, card: str) -> None:
    """K1 at B = 1 on phase 8's table, as a FORA query's push launches it
    (the frontier route), on mass rows and on the real residuals of one
    push after each of ``residuals``' sweep counts; beside the plain route
    (prepare_x and ell_rows, called through the library with no bitmap)
    and ``torch.sparse.mm`` on the same thresholded x. Device time."""
    import torch

    from repro_torch.kernels import ell_spmv

    nbr, msk, w = tables
    n, K = nbr.shape
    a = csr_of(nbr, msk, w, None, n)
    gen = torch.Generator(device=nbr.device).manual_seed(5)
    cases = [("mass rows", mass_rows(gen, 1, n, nbr.device))]
    cases += [(f"residual after sweep {k}", x)
              for k, x in residuals.items()]
    for label, x in cases:
        front = x[0] > thr
        live = float((front[nbr.long()] & msk).double().sum()
                     / msk.double().sum())
        route = device_split_us(lambda: ell_spmv.ell_spmm_cuda(
            nbr, msk, w, x, thr, plan), 50)
        plain_us = sum(device_split_us(
            lambda: k1_on_route(tables, plan, x, thr, 0), 50).values())
        xt = torch.where(front, x[0], 0.0)[:, None].contiguous()
        lib_us = device_ms(lambda: torch.sparse.mm(a, xt), 50) * 1e3
        share = float(front.double().mean())
        print(f"  ell_spmm pokec B=1 {label}: frontier {share:.4f} of the "
              f"nodes, {live:.4f} of the live cells; frontier route "
              f"{sum(route.values()):.2f} us (" + ", ".join(
                  f"{k.split('(')[0].split('::')[-1][:24]} {v:.2f}"
                  for k, v in route.items())
              + f"), plain route {plain_us:.2f} us, torch.sparse.mm on the "
              f"thresholded x {lib_us:.2f} us [{card}]")
    del a


def phase8_pokec(pokec, dg, dev, card: str) -> int:
    """Exact PPR through K4, FORA into D&A_REAL and the deadline-serving
    loop on the dense graph at Pokec's order. Returns K4's launches on this
    path."""
    import torch

    from repro_torch import deadline_serving, quickstart
    from repro_torch.core import DeviceAllocator, dna_real
    from repro_torch.kernels import ell_spmv
    from repro_torch.ppr import (ForaExecutor, ForaParams, PprWorkload,
                                 fora_fused, ppr_power_iteration,
                                 ppr_single_pair)
    from repro_torch.ppr.power_iteration import (default_iters,
                                                 power_iteration_coo)

    print(f"phase 8: dense graph at Pokec's order, exact PPR through K4, "
          f"FORA -> dna_real -> deadline_serving, card {card}")
    print(f"  graph n={pokec.n} m={pokec.m} layout {dg.layout} table "
          f"{tuple(dg.in_neighbors.shape)} {dg.ell_nbytes} bytes "
          f"({dg.ell_nbytes / 1e6:.1f} MB)")
    workload = PprWorkload(pokec, POKEC_QUERIES, seed=0)
    srcs = workload.sources[:POKEC_SOURCES]
    iters = default_iters()

    # the main path: exact PPR through K4, then FORA into dna_real
    ell_spmv.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = ppr_power_iteration(pokec, srcs, device=dev)
    t_k4 = time.perf_counter() - t0
    k4_oracle = ell_spmv.LAUNCHES["ell_spmv"]
    t0 = time.perf_counter()
    coo = power_iteration_coo(pokec, srcs, 0.2, iters, dev).cpu().numpy()
    t_coo = time.perf_counter() - t0
    want = torch.from_numpy(coo.astype(np.float64))
    err, ratio = err_ratio(torch.from_numpy(exact), want, RTOL)
    print(f"  power iteration, {len(srcs)} sources x {iters} steps: K4 "
          f"{t_k4:.3f}s ({k4_oracle} launches, want {iters * len(srcs)}), "
          f"COO index_add_ {t_coo:.3f}s; K4 vs COO max_abs_err={err:.3e} "
          f"max|want|={float(want.abs().max()):.3e} err/limit={ratio:.4f}")
    check(k4_oracle == iters * len(srcs),
          f"power iteration launched K4 {k4_oracle} times, not "
          f"{iters * len(srcs)}")
    check(np.isfinite(exact).all() and ratio <= 1.0,
          f"power iteration through K4 differs from COO (ratio {ratio})")
    row = exact[1].copy()
    row[srcs[1]] = -1.0
    target = int(row.argmax())                 # the largest entry but s
    pair = ppr_single_pair(pokec, int(srcs[1]), target, device=dev)
    print(f"  ppr_single_pair({int(srcs[1])}, {target}) = {pair!r}, row "
          f"entry {float(exact[1, target])!r}")
    check(pair == float(exact[1, target]),
          "ppr_single_pair differs from the row's entry")
    k4 = ell_spmv.LAUNCHES["ell_spmv"]

    params = ForaParams(epsilon=0.5, rmax_scale=POKEC_RMAX_SCALE)
    rp = params.resolve(pokec)
    fleet = DeviceAllocator(devices=list(range(deadline_serving.FLEET)),
                            spares_fraction=deadline_serving.SPARES_FRACTION)
    executor = ForaExecutor(workload=workload, params=params, device=dev)
    ell_spmv.reset_launches()
    t0 = time.perf_counter()
    T, res = quickstart.allocate(executor, POKEC_QUERIES,
                                 max_cores=fleet.capacity)
    t_dna = time.perf_counter() - t0
    k1 = ell_spmv.LAUNCHES["ell_spmm"]
    k1_frontier = ell_spmv.ROUTES["ell_spmm_frontier"]
    # the run's one push at B > 1, the executor's walk-budget calibration
    # (a batch of sources: the plain route), counted again on its own
    ell_spmv.reset_launches()
    budget = executor._calibrate_walk_budget()
    k1_calib = ell_spmv.LAUNCHES["ell_spmm"]
    k1_calib_frontier = ell_spmv.ROUTES["ell_spmm_frontier"]
    fres = fora_fused(executor.device_graph, srcs, params,
                      num_walks=executor.current_walk_budget(), device=dev)
    pi = fres.pi.cpu().numpy()
    mask = exact >= 1.0 / pokec.n
    rel = float((np.abs(pi - exact)[mask] / exact[mask]).max())
    # the walks FORA's guarantee asks for, against the lanes each row ran
    need = np.ceil(fres.residual_mass.cpu().numpy() * rp.omega)
    ran = fres.walks_effective.cpu().numpy()
    short = fres.walks_short.cpu().numpy()
    times = np.concatenate([res.sample_stats.times,
                            list(res.execution.per_query_times.values())])
    print(f"  FORA (rmax {rp.rmax:.3e}, {POKEC_RMAX_SCALE:.4g} of the "
          f"default; omega {rp.omega:.4e}): walk lanes "
          f"{executor.current_walk_budget()}, walks the guarantee asks for "
          f"{need.astype(np.int64).tolist()}, run {ran.tolist()}, short "
          f"{short.tolist()}; max rel "
          f"err {rel:.4f} against the K4 oracle over {len(srcs)} sources "
          f"(eps 0.5); K1 launches {k1}, {k1_frontier} on the frontier "
          f"route, {k1_calib} in the walk-budget calibration's push "
          f"({k1_calib_frontier} on the frontier route)")
    print(f"  dna_real: X={POKEC_QUERIES} T={T:.3f}s cores={res.cores} "
          f"lemma2={res.bounds.lemma2_cores} reduction="
          f"{res.reduction_vs_lemma2_pct:.1f}% completion="
          f"{res.completion_time:.3f}s accepted={res.accepted}; per query "
          f"mean {times.mean() * 1e3:.3f} ms max {times.max() * 1e3:.3f} ms;"
          f" {t_dna:.1f}s")
    check(not short.any() and bool((need <= ran).all()),
          "pokec: FORA ran fewer walks than its guarantee asks for")
    check(rel < 0.5, f"pokec: FORA rel err {rel} >= eps")
    check(res.accepted, "pokec: dna_real result not accepted")
    check(k1 > 0, "pokec: FORA never launched K1")
    # every query's push (B = 1) takes the frontier route, and only the
    # calibration's push (B > 1) takes the plain route
    check(budget == executor.current_walk_budget() and k1_calib > 0
          and k1_calib_frontier == 0,
          f"pokec: the calibration's push recounted gave budget {budget} "
          f"(want {executor.current_walk_budget()}), {k1_calib} K1 "
          f"launches, {k1_calib_frontier} on the frontier route")
    check(k1 - k1_frontier == k1_calib,
          f"pokec: {k1 - k1_frontier} of FORA's K1 launches took the plain "
          f"route, the calibration's push {k1_calib}: a push at B = 1 "
          f"missed the frontier route")

    # deadline_serving's loop needs several cores. The quickstart's rule
    # cannot give them: with its probe of X/4 queries, T = 8 t_pre = 2 X
    # t_avg, which one core meets. So the loop runs D&A_REAL again at
    # LOOP_CORES cores' worth of the probe's t_avg (plus LOOP_SLACK) at
    # d = LOOP_D, on the same executor: every time below is measured.
    st = res.sample_stats
    rest = POKEC_QUERIES - st.times.size
    T_loop = (res.preprocess_time + (1 + LOOP_SLACK) * rest * st.t_avg
              / LOOP_CORES) / LOOP_D
    t0 = time.perf_counter()
    res_loop = dna_real(POKEC_QUERIES, T_loop, executor,
                        max_cores=fleet.capacity, sample_size=st.times.size,
                        scaling_factor=LOOP_D)
    t_loop = time.perf_counter() - t0
    print(f"  dna_real for the loop: T={T_loop:.3f}s d={LOOP_D} cores="
          f"{res_loop.cores} lemma2={res_loop.bounds.lemma2_cores} "
          f"completion={res_loop.completion_time:.3f}s accepted="
          f"{res_loop.accepted}; {t_loop:.1f}s")
    check(res_loop.accepted and res_loop.cores >= 2,
          f"deadline loop: {res_loop.cores} cores, accepted "
          f"{res_loop.accepted}; the loop needs 2 or more")
    # the straggler monitor's unit is one query: the lanes are the measured
    # per-query times of the slot with the longest lane, one lane stalled
    # by STALL t_hat as the JAX example's pathological lane; a re-issued
    # lane runs its query again, measured
    qids, lanes = deadline_serving.slot_lanes(res_loop.execution)
    stalled = lanes.copy()
    stalled[STALL_LANE] += STALL * res_loop.sample_stats.t_hat()
    again = executor(qids).times
    out = deadline_serving.survive(
        fleet, res_loop, POKEC_QUERIES, T_loop, LOOP_D, stalled, again,
        log=lambda s: print(f"  {s}"))
    print(f"  slot {qids}: lanes {np.round(lanes * 1e3, 3).tolist()} ms, "
          f"lane {STALL_LANE} stalled, re-run "
          f"{np.round(again * 1e3, 3).tolist()} ms")
    print(f"  deadline loop: {json.dumps(out)}")
    check(out["allocated"] == res_loop.cores and out["healthy"]
          == deadline_serving.FLEET - deadline_serving.FAILED,
          "deadline loop: wrong allocation")
    # Lemma 1 on what is left: the fewest cores that run X/2 queries of
    # t_max each by T/2, at the deadline asked, while the fleet holds them
    work = (POKEC_QUERIES // 2) * res_loop.sample_stats.t_max
    fits = out["readmit_cores"] * T_loop / 2 >= work * (1 - 1e-12)
    fewest = (out["readmit_cores"] - 1) * T_loop / 2 < work
    check(not out["extended"] and out["feasible"] and fits and fewest,
          f"deadline loop: readmission of {out['readmit_cores']} cores is "
          f"not Lemma 1's count")
    thr = out["straggler_threshold"]
    over = sorted(((t, i) for i, t in enumerate(stalled) if t > thr),
                  reverse=True)
    want = [i for _, i in over][:fleet.spares]
    after = stalled.copy()
    after[want] = np.minimum(stalled[want], thr + again[want])
    print(f"  straggler: threshold {thr * 1e3:.3f} ms, lanes over it "
          f"{want}, spares {fleet.spares}")
    check(out["reissued"] == want and STALL_LANE in want,
          f"deadline loop: re-issued {out['reissued']}, not the lanes over "
          f"the threshold {want}")
    check(out["makespan_after"] == float(after.max())
          and out["makespan_after"] < out["makespan_before"],
          "deadline loop: the re-issue did not cut the slot to its "
          "first finishers")
    profile_calls(f"power iteration through K4, 1 source x {iters} steps",
                  lambda: ppr_power_iteration(pokec, srcs[:1], device=dev))
    profile_queries(pokec, 8, params=params)
    return k4


def fold_cost(B: int, W: int, n: int) -> tuple[float, str]:
    """Least time (ms) for one endpoint fold on these shapes: endpoints and
    weights read once (8 bytes a lane), the (B, n) output written once; one
    add per lane."""
    t_bytes = (B * W * 8 + B * n * 4) / HBM_BYTES_PER_S
    t_ops = B * W / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def last_lane_of_cell(pos, weights):
    """``weights`` with the highest lane of each (row, cell) zeroed: a fold
    that drops a cell's last lane."""
    import torch

    B, W = pos.shape
    key = pos.long() * W + torch.arange(W, device=pos.device)[None]
    order = torch.argsort(key, dim=1)
    cells = torch.gather(pos, 1, order)
    last = torch.ones_like(cells, dtype=torch.bool)
    last[:, :-1] = cells[:, 1:] != cells[:, :-1]
    drop = torch.zeros_like(last)
    drop.scatter_(1, order, last)
    return torch.where(drop, 0.0, weights)


def run_engine(ex, lanes: int, qids) -> tuple[dict, dict, int]:
    """Every query of ``qids`` through a ``QueryEngine`` of ``lanes``
    lanes, inserted in order as lanes free up, stepped and harvested until
    the pool drains. Returns ({qid: HarvestedQuery}, {qid: seconds from
    insertion to harvest}, steps)."""
    from repro_torch.serving import QueryEngine

    eng = QueryEngine(ex, lanes, sweeps=ENGINE_SWEEPS)
    pending = list(qids)
    rows, t_in, latency = {}, {}, {}
    while pending or eng.busy:
        while pending and eng.free:
            qid = pending.pop(0)
            eng.insert(qid)
            t_in[qid] = time.perf_counter()
        eng.step()
        for h in eng.harvest():
            rows[h.qid] = h
            latency[h.qid] = time.perf_counter() - t_in[h.qid]
    return rows, latency, eng.steps


def phase9_engine(web, small, dev, gen, card: str) -> dict:
    """The fold kernel against its plain version, the continuous-batching
    engine on the paper path at full size, and Monte Carlo PPR on the dense
    path. Returns the fold kernel's row of the kernels line."""
    import torch

    from repro_torch.kernels import (endpoint_fold, ell_spmv, ref,
                                     walk_gather)
    from repro_torch.ppr import (ForaExecutor, ForaParams, PprWorkload,
                                 QueryDraws, monte_carlo_ppr, forward_push,
                                 ppr_power_iteration, sample_walk_starts,
                                 walk_endpoints, walk_length_for_tail)
    from repro_torch.ppr.forward_push import one_hot_seeds
    from repro_torch.ppr.random_walk import lane_weights

    print(f"phase 9: continuous-batching engine on the paper path, the live "
          f"endpoint fold, Monte Carlo PPR on the dense path, card {card}")
    params = ForaParams(epsilon=0.5)
    ex = ForaExecutor(workload=PprWorkload(web, ENGINE_QUERIES, seed=0),
                      params=params, device=dev)
    ex.warmup()
    W = ex.current_walk_budget()
    dg = ex.device_graph
    rp = params.resolve(dg)
    L = walk_length_for_tail(rp.alpha, rp.walk_tail)
    print(f"  web-stanford n={web.n} layout {dg.layout}, calibrated walk "
          f"lanes {W}, {ENGINE_LANES} engine lanes, {ENGINE_SWEEPS} sweeps a "
          f"step")

    # the fold against its float64 plain version, on real walk endpoints of
    # the paper path's first queries at its lane count
    seeds = one_hot_seeds(ex.workload.sources[:max(FOLD_BS)], web.n, dev)
    push = forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                        dg.out_degree, seeds, alpha=rp.alpha, rmax=rp.rmax,
                        row_map=dg.in_row_map, fold=dg.in_fold)
    residual = push.r.contiguous()
    draws = QueryDraws(0, range(max(FOLD_BS)), W, dev)
    starts, r_sum = sample_walk_starts(residual, draws.start_uniforms())
    pos = walk_endpoints(dg.edge_dst, dg.out_offsets, dg.out_degree, starts,
                         (draws.step(t) for t in range(L)),
                         alpha=rp.alpha).contiguous()
    need = torch.clamp(torch.ceil(r_sum * rp.omega), min=1.0)
    w_eff = torch.clamp(torch.exp2(torch.ceil(torch.log2(need))), 1.0,
                        float(W)).to(torch.int32)
    path_w = lane_weights(r_sum, W, w_eff).contiguous()
    stats = {"max_abs_err": 0.0, "ratio": 0.0}

    def fold_check(label, p, w, broken=()):
        """The kernel against float64 (RTOL, ATOL_FRAC) and its emulation
        (bit for bit), the same bits on a second launch, under a lane
        permutation and for each row alone; each broken fold's output must
        fail the float64 limit. Returns the kernel's output."""
        torch.cuda.synchronize()
        out = endpoint_fold.endpoint_fold_cuda(p, w, web.n)
        torch.cuda.synchronize()
        want = ref.endpoint_fold_ref(p, w.double(), web.n)
        check(out.shape == want.shape and bool(torch.isfinite(out).all()),
              f"endpoint_fold {label}: bad output")
        err, ratio = err_ratio(out, want, RTOL)
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        stats["ratio"] = max(stats["ratio"], ratio)
        fixed = ref.endpoint_fold_fixed_ref(p, w, web.n)
        same = {"emulation": bool(torch.equal(out, fixed)),
                "second launch": bool(torch.equal(
                    out, endpoint_fold.endpoint_fold_cuda(p, w, web.n)))}
        perm = torch.argsort(torch.rand(p.shape, generator=gen, device=dev),
                             dim=1)
        same["lanes permuted"] = bool(torch.equal(
            out, endpoint_fold.endpoint_fold_cuda(
                torch.gather(p, 1, perm).contiguous(),
                torch.gather(w, 1, perm).contiguous(), web.n)))
        if p.shape[0] > 1:
            same["rows alone"] = all(bool(torch.equal(
                out[b], endpoint_fold.endpoint_fold_cuda(
                    p[b:b + 1].contiguous(), w[b:b + 1].contiguous(),
                    web.n)[0])) for b in range(p.shape[0]))
        print(f"  endpoint_fold {label:44s} max_abs_err={err:.3e} "
              f"max|want|={float(want.abs().max()):.3e} err/limit="
              f"{ratio:.4f} {'ok' if ratio <= 1 else 'FAIL'}; same bits: "
              + ", ".join(f"{k} {v}" for k, v in same.items()))
        check(ratio <= 1.0, f"endpoint_fold {label}: error {err} above the "
              f"limit (ratio {ratio})")
        for what, ok in same.items():
            check(ok, f"endpoint_fold {label}: other bits ({what})")
        for bad, bad_out in broken:
            _, r = err_ratio(bad_out, want, RTOL)
            print(f"  endpoint_fold {'broken: ' + bad:44s} err/limit="
                  f"{r:.4g} {'refused' if r > 1 else 'PASSED'}; bits of the "
                  f"emulation {bool(torch.equal(bad_out, fixed))}")
            check(r > 1.0, f"endpoint_fold: the check passes a broken fold "
                  f"({bad})")
        return out

    path_out = {}
    for B in FOLD_BS:
        p, w = pos[:B].contiguous(), path_w[:B].contiguous()
        broken = () if B < max(FOLD_BS) else (
            (f"scale cut by 2^{FOLD_SCALE_CUT}", ref.endpoint_fold_fixed_ref(
                p, w, web.n, scale_cut=FOLD_SCALE_CUT)),)
        path_out[B] = fold_check(f"paper path B={B} W={W} (r_sum/w_eff)", p,
                                 w, broken)
    widest = path_out[max(FOLD_BS)]
    check(all(bool(torch.equal(o, widest[:B])) for B, o in path_out.items()),
          "endpoint_fold: a row's bits depend on the batch it is folded in")
    rand_w = torch.rand(pos.shape, generator=gen, device=dev)
    lane = torch.arange(W, device=dev)
    broken_w = (("last lane of each cell dropped",
                 last_lane_of_cell(pos, rand_w)),
                ("weights ignored (row mean)",
                 rand_w.mean(dim=1, keepdim=True).expand_as(rand_w)),
                (f"each {FOLD_BLOCK}-lane block's last 32 lanes dropped",
                 torch.where((lane % FOLD_BLOCK >= FOLD_BLOCK - 32)[None],
                             0.0, rand_w)))
    fold_check(f"paper path B={max(FOLD_BS)} random weights", pos, rand_w,
               broken=tuple((bad, ref.endpoint_fold_ref(pos, bw.double(),
                                                        web.n))
                            for bad, bw in broken_w))
    hub = torch.full((1, W), web.n // 2, dtype=torch.int32, device=dev)
    fold_check(f"hub: every lane at node {web.n // 2}, B=1", hub,
               rand_w[:1].contiguous())
    print(f"  endpoint_fold: max_abs_err {stats['max_abs_err']:.3e}, largest "
          f"err/limit {stats['ratio']:.4f}")

    # the engine at full size: the main path of this phase
    for mod in (ell_spmv, walk_gather, endpoint_fold):
        mod.reset_launches()
    qids = list(range(ENGINE_QUERIES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, latency, steps = run_engine(ex, ENGINE_LANES, qids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ell_spmv.LAUNCHES, **walk_gather.LAUNCHES,
                **endpoint_fold.LAUNCHES}
    lat = np.array([latency[q] for q in qids]) * 1e3
    print(f"  engine: {ENGINE_QUERIES} queries through {ENGINE_LANES} lanes "
          f"in {steps} steps, wall {wall:.3f}s = {wall / ENGINE_QUERIES * 1e3:.3f}"
          f" ms a query; insert to harvest mean {lat.mean():.3f} ms, p50 "
          f"{np.percentile(lat, 50):.3f}, max {lat.max():.3f}; launches "
          f"{launches}")
    check(sorted(rows) == qids, "the engine lost queries")
    check(launches["ell_spmm_sliced"] > 0, "the engine never launched K2")
    check(launches["endpoint_fold"] > 0,
          "the engine never launched the endpoint fold")
    check(launches["ell_spmm"] == 0 and launches["walk_endpoint_gather"] == 0,
          "the engine on the sliced table launched K1 or K3")
    FOLD_LAUNCHES["phase 9 engine"] = launches["endpoint_fold"]
    # a second run with the same insertion schedule: the same bits
    again, _, steps2 = run_engine(ex, ENGINE_LANES, qids)
    same = sum(bool(np.array_equal(again[q].pi, rows[q].pi)) for q in qids)
    print(f"  second engine run: {same} of {ENGINE_QUERIES} rows have the "
          f"same bits ({steps2} steps)")
    check(same == ENGINE_QUERIES and steps2 == steps,
          "a second engine run gave other bits")
    # each row against its chunked answer: the pushes run at other batch
    # widths, so a walk start may cross a CDF boundary; such a walker moves
    # its weight r_sum / w_eff between two entries
    worst_over, worst_ratio = 0, 0.0
    for lo in range(0, ENGINE_QUERIES, ENGINE_LANES):
        chunk = qids[lo:lo + ENGINE_LANES]
        want = ex.answer_chunk(chunk)
        for i, q in enumerate(chunk):
            h = rows[q]
            diff = np.abs(h.pi.astype(np.float64) - want[i])
            limit = ENGINE_RTOL * np.abs(want[i]) + ATOL_FRAC * float(
                np.abs(want[i]).max())
            over = diff > limit
            weight = h.residual_mass / h.walks_effective
            worst_over = max(worst_over, int(over.sum()))
            if over.any():
                worst_ratio = max(worst_ratio, float(
                    (diff[over] / (MOVED_MAX * weight + limit[over])).max()))
    print(f"  engine rows vs answer_chunk (rtol {ENGINE_RTOL} + "
          f"{ATOL_FRAC} * max): at most {worst_over} entries a row over, "
          f"each within {worst_ratio:.4f} of {MOVED_MAX} walkers' weight")
    check(worst_over <= 2 * MOVED_MAX and worst_ratio <= 1.0,
          "engine rows differ from their chunked answers")
    # FORA's guarantee against power iteration, and the lane cap's flags
    srcs = ex.workload.sources[:CHECK_SOURCES]
    exact = ppr_power_iteration(web, srcs, device=dev)
    mask = exact >= 1.0 / web.n
    pis = np.stack([rows[q].pi for q in range(CHECK_SOURCES)])
    rel = float((np.abs(pis - exact)[mask] / exact[mask]).max())
    short = [q for q in qids if rows[q].walks_short]
    unflagged = [q for q in qids if not rows[q].walks_short and float(
        np.ceil(np.float32(rows[q].residual_mass) * np.float32(rp.omega)))
        > rows[q].walks_effective]
    print(f"  FORA max rel err {rel:.4f} over {CHECK_SOURCES} sources "
          f"(eps 0.5); rows flagged walks_short {len(short)}, unflagged "
          f"short rows {len(unflagged)}")
    check(rel < 0.5, f"engine rows: FORA rel err {rel} >= eps")
    check(not unflagged, f"short rows without the flag: {unflagged[:8]}")
    # where the time goes: a short engine run under the profiler
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_engine(ex, ENGINE_LANES, qids[:ENGINE_PROFILED])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = device_us(prof)
    busy = sum(sum(v) for v in by_name.values())
    print(f"  profile engine: {ENGINE_PROFILED} queries, wall "
          f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle "
          f"share {1 - busy / wall_us:.3f}")
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]:
        print(f"    {sum(ts) / 1e3:9.3f} ms {len(ts):7d}x "
              f"{sum(ts) / len(ts):8.2f} us  {name[:90]}")

    # the fold's time at the paper path's shape, beside index_add_
    def timed_fold(B, reps=100):
        p, w = pos[:B].contiguous(), path_w[:B].contiguous()
        flat = (p.long() + torch.arange(B, device=dev)[:, None]
                * web.n).reshape(-1)
        wf = w.reshape(-1)
        kern = lambda: endpoint_fold.endpoint_fold_cuda(  # noqa: E731
            p, w, web.n)
        plain = lambda: ref.endpoint_fold_ref(p, w, web.n)  # noqa: E731
        lib = lambda: torch.zeros(  # noqa: E731
            B * web.n, device=dev).index_add_(0, flat, wf)
        _, lib_ratio = err_ratio(lib().view(B, web.n), ref.endpoint_fold_ref(
            p, w.double(), web.n), LIBRARY_RTOL)
        check(lib_ratio <= 1.0, "library yardstick disagrees for the fold")
        split = device_split_us(kern, reps)
        ms = sum(split.values()) / 1e3
        plain_ms = device_ms(plain, max(5, reps // 10))
        lib_ms = device_ms(lib, reps)
        ev_ms = events_ms(kern, reps)
        bound, by = fold_cost(B, W, web.n)
        print("    fold device time by kernel: " + ", ".join(
            f"{k[:40]} {us:.2f} us" for k, us in split.items()))
        print(f"  {'endpoint_fold':16s} paper path B={B} W={W}"
              f"{'':12s} kernel {ms * 1e3:9.2f} us (events {ev_ms * 1e3:9.2f}"
              f" us)  bound {bound * 1e3:8.2f} us ({by})  plain "
              f"{plain_ms * 1e3:10.2f} us  index_add_ {lib_ms * 1e3:9.2f} us"
              f"  [{card}]")
        return ms, plain_ms, bound, by, lib_ms

    ms, plain_ms, bound, by, lib_ms = timed_fold(1)
    timed_fold(max(FOLD_BS), reps=30)

    # pure Monte Carlo PPR on the dense path against K4's oracle
    endpoint_fold.reset_launches()
    ell_spmv.reset_launches()
    msrcs = np.array(DENSE_SOURCES)
    mexact = ppr_power_iteration(small, msrcs, device=dev)
    k4 = ell_spmv.LAUNCHES["ell_spmv"]
    t0 = time.perf_counter()
    mc = monte_carlo_ppr(small, msrcs, ForaParams(epsilon=0.5), seed=0,
                         device=dev)
    t_mc = time.perf_counter() - t0
    mmask = mexact >= 1.0 / small.n
    mrel = float((np.abs(mc - mexact)[mmask] / mexact[mmask]).max())
    print(f"  Monte Carlo PPR, dense path, {len(msrcs)} sources: "
          f"{t_mc:.3f}s, max rel err {mrel:.4f} against K4's oracle ({k4} "
          f"K4 launches), row sums {np.round(mc.sum(axis=1), 5).tolist()}, "
          f"fold launches {endpoint_fold.LAUNCHES['endpoint_fold']}")
    check(np.isfinite(mc).all() and np.allclose(mc.sum(axis=1), 1.0,
                                                 atol=1e-4),
          "Monte Carlo PPR: bad rows")
    check(mrel < 0.5, f"Monte Carlo PPR rel err {mrel} >= eps")
    check(k4 > 0 and endpoint_fold.LAUNCHES["endpoint_fold"] == len(msrcs),
          "Monte Carlo PPR: K4 or the fold not launched")
    FOLD_LAUNCHES["phase 9 Monte Carlo PPR"] = endpoint_fold.LAUNCHES[
        "endpoint_fold"]
    return {"name": "endpoint_fold", "launches": launches["endpoint_fold"],
            "max_abs_err": stats["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def phase10_dyn(web, dev, card: str) -> None:
    """Seeded edge batches applied to the paper path's graph on the card:
    the walk view against a fresh build after every batch, the push on the
    mutated residency against a fresh build's, spare rows that K2 must not
    read, and compaction equal to a fresh build."""
    import torch

    from repro_torch.dyn import DynamicGraph, MutationLog
    from repro_torch.kernels import ell_spmv
    from repro_torch.ppr import ForaParams, PprWorkload, forward_push
    from repro_torch.ppr.forward_push import one_hot_seeds
    from repro_torch.ppr.graph import DeviceGraph

    print(f"phase 10: dynamic graphs on the full-size web-stanford stand-in, "
          f"{DYN_BATCHES} seeded batches of {DYN_BATCH_EDGES} edges, card "
          f"{card}")
    t0 = time.perf_counter()
    dyn = DynamicGraph(web, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    log = MutationLog.seeded(web, DYN_BATCHES, seed=0,
                             batch_edges=DYN_BATCH_EDGES)
    t_log = time.perf_counter() - t0
    print(f"  residency: width {dyn.width}, push rows "
          f"{int(dyn._push_rm.shape[0])} (capacity), walk slots "
          f"{int(dyn._walk_src.shape[0])}; set-up {t_init:.2f}s, log "
          f"{t_log:.2f}s")
    rp = ForaParams(epsilon=0.5).resolve(web)
    srcs = PprWorkload(web, ENGINE_QUERIES, seed=0).sources[:CHECK_SOURCES]
    seeds = one_hot_seeds(srcs, web.n, dev)

    def push_pi(dg):
        return forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                            dg.out_degree, seeds, alpha=rp.alpha,
                            rmax=rp.rmax, row_map=dg.in_row_map,
                            fold=dg.in_fold).pi

    ell_spmv.reset_launches()
    apply_s, worst = [], 0.0
    for batch in log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = dyn.apply(batch)
        torch.cuda.synchronize()
        apply_s.append(time.perf_counter() - t0)
        fresh_g = dyn.graph()
        m = fresh_g.m
        walk_ok = (dyn.dg.m == m and all(np.array_equal(
            getattr(dyn.dg, f)[:m].cpu().numpy(), getattr(fresh_g, f))
            for f in ("edge_src", "edge_dst")) and np.array_equal(
            dyn.dg.out_offsets.cpu().numpy(), fresh_g.out_offsets)
            and np.array_equal(dyn.dg.out_degree.cpu().numpy(),
                               fresh_g.out_degree))
        check(walk_ok, f"version {info.version}: the walk view's live "
              "prefix differs from a fresh build")
        fresh = DeviceGraph.from_graph(fresh_g, layout="sliced", device=dev)
        got, want = push_pi(dyn.dg), push_pi(fresh).double()
        _, ratio = err_ratio(got, want, DYN_RTOL)
        worst = max(worst, ratio)
        print(f"  version {info.version}: +{info.adds_applied} "
              f"-{info.removes_applied} edges, {info.push_rows} delta rows, "
              f"{len(info.affected)} sources affected, live {m}; apply "
              f"{apply_s[-1] * 1e3:.2f} ms; walk view = fresh build; push "
              f"err/limit {ratio:.4f}")
        check(ratio <= 1.0, f"version {info.version}: push on the mutated "
              f"residency differs from a fresh build (ratio {ratio})")
    k2 = ell_spmv.LAUNCHES["ell_spmm_sliced"]
    check(k2 > 0, "the mutated residency's push never launched K2")
    # spare rows (row_map == n) lie past the fold's row_ptr[n]: K2 must
    # not read them, whatever they hold
    dg = dyn.dg
    spare = dg.in_row_map == web.n
    x = seeds / seeds.sum(dim=1, keepdim=True)
    clean = ell_spmv.ell_spmm_sliced_cuda(dg.in_neighbors, dg.in_mask,
                                          dg.in_weights, dg.in_row_map, x,
                                          None, dg.in_fold)
    nbr = torch.where(spare[:, None], web.n - 1, dg.in_neighbors)
    poisoned = ell_spmv.ell_spmm_sliced_cuda(
        nbr, dg.in_mask | spare[:, None], torch.where(
            spare[:, None], 1.0, dg.in_weights), dg.in_row_map, x, None,
        dg.in_fold)
    print(f"  {int(spare.sum())} spare rows past row_ptr[n] = "
          f"{int(dg.in_fold.row_ptr[-1])}: K2 with them filled gives the "
          f"same bits: {bool(torch.equal(clean, poisoned))}")
    check(bool(torch.equal(clean, poisoned)), "K2 read the spare rows")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compacted = dyn.compact()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    fresh = DeviceGraph.from_graph(dyn.graph(), layout="sliced", device=dev)
    same = all(bool(torch.equal(getattr(compacted, f), getattr(fresh, f)))
               for f in DeviceGraph.ARRAY_FIELDS) and all(
        bool(torch.equal(getattr(compacted.in_fold, f),
                         getattr(fresh.in_fold, f)))
        for f in ("row_ptr", "items", "hubs", "hub_chunks"))
    print(f"  apply ms: mean {np.mean(apply_s) * 1e3:.2f}, max "
          f"{np.max(apply_s) * 1e3:.2f}; compact {t_compact:.2f}s, equal to a "
          f"fresh build: {same}; push err/limit at most {worst:.4f} (rtol "
          f"{DYN_RTOL}); K2 launches {k2}")
    check(same, "compact() differs from a fresh build")


def phase11_daemon(web, dev, gen, card: str) -> float:
    """The serving daemon on the paper path at full size: the autotune
    sweep and its CLI, a PPR daemon built as ``serve --daemon`` builds it
    (engine, result cache, WAL and snapshots, the tuning cache) and its
    recovery, a second run under chaos with mutations, and a crash leg on
    the simulated workload. Returns K2's largest error of the phase."""
    import os
    import shutil

    import torch

    from repro_torch.core.estimator import CacheAwareCostModel
    from repro_torch.ft.chaos import (ChaosSchedule, ChaosSpec,
                                      drive_with_crashes)
    from repro_torch.kernels import autotune, ell_spmv, endpoint_fold, ref
    from repro_torch.launch import serve
    from repro_torch.ppr import (ForaExecutor, ForaParams, PprWorkload,
                                 forward_push)
    from repro_torch.ppr.forward_push import one_hot_seeds
    from repro_torch.ppr.graph import DeviceGraph
    from repro_torch.serving import ServingRuntime

    print(f"phase 11: the serving daemon on the full-size web-stanford "
          f"stand-in, card {card}")
    t_phase = time.perf_counter()
    work = ROOT / "build" / "phase11"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    autotune.clear_cache()
    k2_err = 0.0

    # 1. autotune: the sweep on this graph, its cache, the CLI's two legs
    cache = autotune.TuningCache(path=work / "tune.json")
    trials: list = []
    best = autotune.sweep_sliced(web, B=TUNE_B, pad_multiples=TUNE_PAD_MULTIPLES,
                                 repeats=TUNE_REPEATS, device=dev,
                                 cache=cache, trials=trials)
    walk = autotune.sweep_walk(web, repeats=TUNE_REPEATS, device=dev,
                               cache=cache)
    cache.save()
    loaded = autotune.TuningCache.load(cache.path)
    check(loaded.entries == cache.entries,
          "the tuning cache did not load back equal")
    bucket = autotune.shape_bucket(web.n, web.m)
    backend = autotune.current_backend(dev)
    check(loaded.lookup(backend, "sliced", bucket) == best,
          f"the sweep's winner is not the cache's {backend} entry")
    x = mass_rows(gen, TUNE_B, web.n, dev)
    for cand in trials:
        se = web.ell_in_sliced(pad_multiple=cand.pad_multiple)
        nbr, msk, w, rm = (torch.from_numpy(a).to(dev) for a in (
            se.neighbors, se.mask, se.weights, se.row_map))
        fold = ell_spmv.sliced_fold(rm, web.n, se.width)
        out = ell_spmv.ell_spmm_sliced_cuda(nbr, msk, w, rm, x, None, fold)
        want = ref.ell_spmm_sliced_ref(nbr, msk, x.double(), w.double(),
                                       None, rm)
        err, ratio = err_ratio(out, want, RTOL)
        k2_err = max(k2_err, err)
        same = bool(torch.equal(out, ell_spmv.ell_spmm_sliced_cuda(
            nbr, msk, w, rm, x, None, fold)))
        print(f"  sweep pad_multiple {cand.pad_multiple:2d}: table "
              f"{tuple(se.neighbors.shape)} ({se.nbytes / 2**20:.1f} MiB), "
              f"K2 at B={TUNE_B} {cand.device_us:.2f} us by events (first "
              f"call {cand.compile_us / 1e3:.2f} ms); vs float64 plain "
              f"err/limit {ratio:.4f}, bits repeat {same}")
        check(ratio <= 1.0 and same, f"K2 on the pad_multiple "
              f"{cand.pad_multiple} table: ratio {ratio}, repeat {same}")
    print(f"  autotune: {backend}|sliced|{bucket} -> pad_multiple "
          f"{best.pad_multiple} width {best.width} {best.device_us:.2f} us "
          f"(phase 5's device time of K2 on the width-8 table: "
          f"{PHASE5_K2_US[1]} us at B=1, {PHASE5_K2_US[8]} us at B=8, "
          f"PERF.md); {backend}|walk|{bucket} {walk.device_us:.2f} us for "
          f"4096 lanes x 8 steps; cache saved and loaded equal [{card}]")
    model = CacheAwareCostModel.seeded_from_tuning(loaded, backend=backend)
    share = walk.device_us / (walk.device_us + best.device_us)
    print(f"  seeded_from_tuning walk_share {model.walk_share:.6f} = "
          f"walk / (walk + push) {share:.6f}")
    check(model.walk_share == share, "seeded_from_tuning's walk share")
    autotune.set_cache(loaded)
    tuned = DeviceGraph.from_graph(web, device=dev)
    mirror = web.device(dev)
    autotune.set_cache(None)
    plain_dg = DeviceGraph.from_graph(web, device=dev)
    check(tuned.ell_width == best.width == mirror.ell_width,
          f"a residency under the cache has width {tuned.ell_width}, the "
          f"mirror {mirror.ell_width}, not the tuned {best.width}")
    rp = ForaParams(epsilon=0.5).resolve(web)
    seeds = one_hot_seeds(PprWorkload(web, DAEMON_QUERIES, seed=0)
                          .sources[:CHECK_SOURCES], web.n, dev)

    def push_pi(dg):
        return forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                            dg.out_degree, seeds, alpha=rp.alpha,
                            rmax=rp.rmax, row_map=dg.in_row_map,
                            fold=dg.in_fold).pi

    want = push_pi(plain_dg).double()
    _, ratio = err_ratio(push_pi(tuned), want, DYN_RTOL)
    print(f"  residency under the cache: width {tuned.ell_width} (default "
          f"{plain_dg.ell_width}), graph.device's mirror rebuilt with it; "
          f"push on the tuned table vs the default table err/limit "
          f"{ratio:.4f} (rtol {DYN_RTOL})")
    check(ratio <= 1.0, f"the tuned table's push differs (ratio {ratio})")
    # every swept table answers as the default one, whichever wins
    for cand in trials:
        if cand.width == plain_dg.ell_width:
            continue
        other = DeviceGraph.from_graph(web, width=cand.width,
                                       pad_multiple=cand.pad_multiple,
                                       device=dev)
        _, ratio = err_ratio(push_pi(other), want, DYN_RTOL)
        print(f"  push on the width-{cand.width} table vs the default "
              f"table err/limit {ratio:.4f}")
        check(ratio <= 1.0, f"the width-{cand.width} table's push differs "
              f"(ratio {ratio})")
    del tuned, mirror, plain_dg
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for extra in ([], ["--expect-hit"]):
        cmd = [sys.executable, "-m", "repro_torch.kernels.autotune",
               "--smoke", "--cache", str(work / "cli.json"), *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=600)
        for line in proc.stdout.splitlines():
            print(f"  cli{' --expect-hit' if extra else ''}: {line}")
        print(f"  cli exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f}s")
        check(proc.returncode == 0, f"autotune CLI {extra} failed:\n"
              f"{proc.stdout}\n{proc.stderr}")

    # 2. the PPR daemon, its deadline set from a measured t_avg
    probe = ForaExecutor(workload=PprWorkload(web, DAEMON_QUERIES, seed=0),
                         params=ForaParams(epsilon=0.5), device=dev)
    t_avg = probe(list(range(DAEMON_PROBE))).t_avg
    deadline = DAEMON_QUERIES * t_avg / DAEMON_SPREAD
    del probe
    base = ["--daemon", "--workload", "ppr", "--dataset", "web-stanford",
            "--scale", str(DAEMON_SCALE), "--num-jobs", str(DAEMON_JOBS),
            "--queries",
            str(DAEMON_QUERIES), "--deadline", repr(deadline),
            "--arrival-rate", str(DAEMON_RATE), "--max-cores",
            str(DAEMON_CORES), "--cache-size", str(DAEMON_CACHE),
            "--autotune-cache", str(cache.path), "--device", "cuda"]

    def daemon(argv):
        args = serve.build_parser().parse_args(argv)
        serve.prepare(args)
        rt, factory, heartbeat = serve._build_daemon_runtime(args)
        rt.submit_poisson(args.num_jobs, args.arrival_rate,
                          queries=args.queries, deadline=args.deadline,
                          seed=args.seed)
        return args, rt, factory, heartbeat

    def launches():
        return {"ell_spmm_sliced": ell_spmv.LAUNCHES["ell_spmm_sliced"],
                "endpoint_fold": endpoint_fold.LAUNCHES["endpoint_fold"],
                "ell_spmm": ell_spmv.LAUNCHES["ell_spmm"],
                "ell_spmv": ell_spmv.LAUNCHES["ell_spmv"]}

    def lost_none(rt, report, label):
        recs = report.records
        check(len(recs) == DAEMON_JOBS and all(r.state == "done"
                                                for r in recs),
              f"{label}: a job did not complete: "
              f"{[r.state for r in recs]}")
        for r in recs:
            check(r.core_seconds > 0 and r.lemma2_core_seconds > 0
                  and r.lateness >= 0, f"{label}: job {r.job_id}'s "
                  f"accounting: {r}")
        check(rt.pool.used == 0 and rt.engine.busy == 0
              and abs(rt.ledger.outstanding) < 1e-9,
              f"{label}: the pool, the lanes or the ledger did not drain")

    wal = work / "wal"
    args, rt, factory, _ = daemon(base + [
        "--wal-dir", str(wal), "--snapshot-every",
        str(DAEMON_SNAPSHOT_EVERY)])
    ell_spmv.reset_launches()
    endpoint_fold.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    FOLD_LAUNCHES["phase 11 daemon"] = counts["endpoint_fold"]
    print(f"  daemon: {DAEMON_JOBS} Poisson jobs (rate {DAEMON_RATE}/s) of "
          f"{DAEMON_QUERIES} queries, T = {deadline:.4f}s = X t_avg / "
          f"{DAEMON_SPREAD} (t_avg {t_avg * 1e3:.3f} ms over "
          f"{DAEMON_PROBE} probe queries), {DAEMON_CORES} cores, engine, "
          f"cache {DAEMON_CACHE}, WAL snapshot every "
          f"{DAEMON_SNAPSHOT_EVERY}, tuned width {best.width}")
    serve.print_daemon_report(rt, report)
    measured = sum(j.effective_queries - j.late_hits for j in rt.jobs)
    lemma2 = [round(r.lemma2_core_seconds / r.deadline) for r in
              report.records]
    print(f"  per measured query {1e3 * report.core_seconds / measured:.3f} "
          f"ms over {measured} queries; Lemma-2 cores a job {lemma2}; peak "
          f"lanes a job {[r.grant_peak for r in report.records]}; cache hit "
          f"rate {rt.cache.hit_rate:.4f}; launches {counts}; events "
          f"{rt.events_processed}; wall {wall:.2f}s [{card}]")
    lost_none(rt, report, "daemon")
    check(min(lemma2) >= 4, f"the deadline lets Lemma 2 ask fewer than 4 "
          f"cores: {lemma2}")
    check(counts["ell_spmm_sliced"] > 0 and counts["endpoint_fold"] > 0,
          f"the daemon's queries did not run K2 and the fold: {counts}")
    check(counts["ell_spmv"] == 0 and counts["ell_spmm"] == 0,
          f"the daemon launched K4 or K1 on a sliced graph: {counts}")
    t0 = time.perf_counter()
    rt2, info = ServingRuntime.recover(wal, factory)
    report2 = rt2.run()
    print(f"  recovery from the WAL: snapshot step {info.snapshot_step}, "
          f"{info.replayed_events} of {info.logged_events} logged events "
          f"replayed in {time.perf_counter() - t0:.2f}s; trace records "
          f"equal: {rt2.trace_records() == rt.trace_records()}, job "
          f"records equal: {report2.records == report.records}")
    check(rt2.trace_records() == rt.trace_records()
          and report2.records == report.records,
          "the recovered runtime differs from the live run")
    del rt, rt2

    # 3. failures, slowdowns and mutations applied on the card
    args, rt, factory, _ = daemon(base + [
        "--chaos", DAEMON_CHAOS, "--mutation-rate",
        str(DAEMON_MUTATION_RATE), "--mutations", str(DAEMON_MUTATIONS),
        "--mutation-edges", str(DAEMON_MUTATION_EDGES)])
    schedule = ChaosSchedule.from_spec(ChaosSpec.parse(args.chaos),
                                       args.max_cores)
    schedule.apply(rt)
    ell_spmv.reset_launches()
    endpoint_fold.reset_launches()
    t0 = time.perf_counter()
    report = rt.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    print(f"  chaos [{DAEMON_CHAOS}] with {DAEMON_MUTATIONS} mutation "
          f"batches of {DAEMON_MUTATION_EDGES} edges: failures "
          f"{list(schedule.failures)}, slowdowns {list(schedule.slowdowns)}")
    serve.print_daemon_report(rt, report)
    print(f"  launches {counts}; wall {wall:.2f}s")
    lost_none(rt, report, "chaos daemon")
    check(rt.mutations_applied == DAEMON_MUTATIONS,
          f"{rt.mutations_applied} mutations applied")
    check(counts["ell_spmm_sliced"] > 0 and counts["endpoint_fold"] > 0,
          f"the chaos daemon's queries did not run K2 and the fold: {counts}")
    dyn = rt.dynamic_graph
    ell_spmv.reset_launches()
    got = push_pi(dyn.dg)
    k2 = ell_spmv.LAUNCHES["ell_spmm_sliced"]
    fresh = DeviceGraph.from_graph(dyn.graph(), layout="sliced", device=dev)
    _, ratio = err_ratio(got, push_pi(fresh).double(), DYN_RTOL)
    print(f"  mutated residency (version {dyn.version}): push with K2 on the "
          f"rebuilt fold ({k2} launches) vs a fresh build err/limit "
          f"{ratio:.4f}")
    check(k2 > 0 and ratio <= 1.0, f"the push on the mutated residency "
          f"(K2 launches {k2}, ratio {ratio})")
    del rt, dyn, fresh

    # 4. crashes: the simulated workload (its times replay; a measuring
    # executor's do not, ROADMAP F8), crashed and recovered from the WAL
    sim = ["--daemon", "--workload", "lm-decode", "--num-jobs",
           str(DAEMON_JOBS), "--queries", str(DAEMON_QUERIES), "--deadline",
           "1.0", "--arrival-rate", "4", "--max-cores", str(DAEMON_CORES),
           "--chaos", CRASH_CHAOS, "--device", "cuda"]
    args, rt, _, _ = daemon(sim)
    schedule = ChaosSchedule.from_spec(ChaosSpec.parse(args.chaos),
                                       args.max_cores)
    schedule.apply(rt)
    uncrashed = rt.run()
    args, rt, factory, heartbeat = daemon(sim + [
        "--wal-dir", str(work / "crash_wal"), "--snapshot-every",
        str(DAEMON_SNAPSHOT_EVERY)])
    schedule.apply(rt)
    crashed, infos, rt = drive_with_crashes(
        rt, args.wal_dir, factory, schedule.crashes, heartbeat=heartbeat)
    print(f"  crashes at events {list(schedule.crashes)}: "
          f"{len(infos)} recoveries "
          f"{[(i.snapshot_step, i.replayed_events) for i in infos]}; "
          f"records equal the uncrashed run's: "
          f"{crashed.records == uncrashed.records}; {crashed.summary()}")
    check(len(infos) == 2 and crashed.records == uncrashed.records
          and crashed.completed == DAEMON_JOBS,
          "the crashed run differs from the uncrashed one")
    autotune.clear_cache()
    shutil.rmtree(work, ignore_errors=True)
    print(f"  phase 11 wall {time.perf_counter() - t_phase:.1f}s")
    return k2_err


def phase12_sharded(web, pokec, small, dev, gen, card: str, psrcs,
                    pexact) -> dict[str, float]:
    """The node-sharded residency on the one card: the paper path at full
    size on a 4-shard and a 1-shard mesh against the DeviceGraph, every
    shard's K2 against float64 plain, a 3-shard mesh against phase 3's
    power-iteration oracle; the Pokec-order dense table in 4 row blocks,
    each shard's K1 against float64 plain with its route; the executor and
    ``serve`` with ``devices=2`` refused over capacity. Times are printed,
    not gated. Returns K1's and K2's largest errors of the phase."""
    import os

    import torch

    from repro_torch.kernels import ell_spmv, endpoint_fold, ops, ref
    from repro_torch.ppr import (DeviceGraph, DeviceMesh, ForaExecutor,
                                 ForaParams, PprWorkload, ShardedDeviceGraph,
                                 fora_fused)

    print(f"phase 12: the node-sharded residency, {SHARD_K} shards on one "
          f"card, card {card}")
    t_phase = time.perf_counter()
    errs = {"ell_spmm": 0.0, "ell_spmm_sliced": 0.0}
    meshes = {k: DeviceMesh((dev,) * k) for k in (1, 3, SHARD_K)}

    def hold(name, kernel, plain, label):
        """One kernel launch against its float64 plain version, a second
        launch with the same bits."""
        torch.cuda.synchronize()
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        want = plain()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} {label}: shape {tuple(got.shape)} or non-finite")
        err, ratio = err_ratio(got, want, RTOL)
        errs[name] = max(errs[name], err)
        print(f"  {name:16s} {label:34s} max_abs_err={err:.3e} "
              f"err/limit={ratio:.4f} {'ok' if ratio <= 1 else 'FAIL'}")
        check(ratio <= 1.0, f"{name} {label}: error {err} above rtol {RTOL} "
              f"+ {ATOL_FRAC} * max|want| (ratio {ratio})")
        check(bool(torch.equal(got, again)),
              f"{name} {label}: a second launch gave other bits")

    def threshold(graph, params):
        return (params.resolve(graph).rmax * torch.clamp(
            torch.from_numpy(graph.out_degree).to(dev).float(), min=1.0))

    def queries(dg, workload, params, count, lanes):
        """``count`` queries one at a time, each timed to its sync."""
        res, times = [], []
        for q in range(count):
            t0 = time.perf_counter()
            r = fora_fused(dg, workload.sources[q:q + 1], params, 0,
                           num_walks=lanes, query_ids=[q], device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            res.append(r)
        return res, float(np.mean(times)) * 1e3

    def held(got, want, label):
        """A sharded query's answer against the single-device one."""
        worst = 0.0
        for q, (a, b) in enumerate(zip(got, want)):
            check(int(a.push_iters) == int(b.push_iters),
                  f"{label} query {q}: {int(a.push_iters)} sweeps, one "
                  f"device {int(b.push_iters)}")
            _, r_ratio = err_ratio(a.residual_mass,
                                   b.residual_mass.double(), 1e-5)
            check(r_ratio <= 1.0, f"{label} query {q}: residual mass off")
            check(bool(torch.equal(a.walks_effective, b.walks_effective))
                  and bool(torch.equal(a.walks_short, b.walks_short)),
                  f"{label} query {q}: another walk budget")
            _, ratio = err_ratio(a.pi, b.pi.double(), SHARD_RTOL)
            worst = max(worst, ratio)
        check(worst <= 1.0, f"{label}: pi off the single device's by "
              f"{worst} of rtol {SHARD_RTOL} + {ATOL_FRAC} * max")
        return worst

    # 1. the paper path at full size
    params = ForaParams(epsilon=0.5)
    t0 = time.perf_counter()
    single = web.device(dev)
    sg = {k: web.device(mesh=meshes[k]) for k in (1, SHARD_K)}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sg4 = sg[SHARD_K]
    rows = int(single.in_neighbors.shape[0])
    print(f"  paper path: web-stanford n={web.n}, sliced {rows} x "
          f"{single.ell_width}; {SHARD_K} shards of {sg4.rows_per_shard} "
          f"virtual rows ({sg4.ell_nbytes} bytes), built in {build_s:.2f}s")
    check(sg4.layout == "sliced" and sg4.num_shards == SHARD_K
          and sg4.rows_per_shard == -(-rows // SHARD_K),
          "the paper path's shards are not its virtual-row blocks")
    thr = threshold(web, params)
    for B in (1, 8):
        x = mass_rows(gen, B, web.n, dev)
        for s in range(SHARD_K):
            tab = (sg4.in_neighbors[s], sg4.in_mask[s], sg4.in_weights[s],
                   sg4.in_row_map[s])
            first = int(tab[3][0])
            cont = s > 0 and first == int(sg4.in_row_map[s - 1][-1])
            hold("ell_spmm_sliced",
                 lambda t=tab, s=s, x=x: ell_spmv.ell_spmm_sliced_cuda(
                     *t, x, thr, sg4.in_fold[s]),
                 lambda t=tab, x=x: ref.ell_spmm_sliced_ref(
                     t[0], t[1], x.double(), t[2].double(), thr.double(),
                     t[3]),
                 f"shard {s}/{SHARD_K} B={B}"
                 f"{' (continues row ' + str(first) + ')' if cont else ''}")
        hold("ell_spmm_sliced",
             lambda x=x: ops.ell_spmm_sliced_shard(
                 sg4.in_neighbors, sg4.in_mask, sg4.in_weights,
                 sg4.in_row_map, x, threshold=thr, folds=sg4.in_fold),
             lambda x=x: ref.ell_spmm_sliced_ref(
                 single.in_neighbors, single.in_mask, x.double(),
                 single.in_weights.double(), thr.double(),
                 single.in_row_map),
             f"{SHARD_K} shards combined B={B}")
    workload = PprWorkload(web, SHARD_QUERIES, seed=0)
    ell_spmv.reset_launches()
    endpoint_fold.reset_launches()
    one_dev, ms_single = queries(single, workload, params, SHARD_QUERIES,
                                 SHARD_LANES)
    one_launches = {**ell_spmv.LAUNCHES, **endpoint_fold.LAUNCHES}
    ell_spmv.reset_launches()
    endpoint_fold.reset_launches()
    four, ms_four = queries(sg4, workload, params, SHARD_QUERIES,
                            SHARD_LANES)
    four_launches = {**ell_spmv.LAUNCHES, **endpoint_fold.LAUNCHES}
    FOLD_LAUNCHES[f"phase 12 {SHARD_K} shards"] = four_launches[
        "endpoint_fold"]
    sweeps = sum(int(r.push_iters) for r in four)
    four_again, _ = queries(sg4, workload, params, SHARD_QUERIES,
                            SHARD_LANES)
    one_mesh, ms_one_mesh = queries(sg[1], workload, params, SHARD_QUERIES,
                                    SHARD_LANES)
    worst = held(four, one_dev, f"paper path {SHARD_K} shards")
    check(all(bool(torch.equal(a.pi, b.pi)) for a, b in
              zip(four, four_again)),
          "paper path: a repeated 4-shard query gave other bits")
    check(all(bool(torch.equal(a.pi, b.pi))
              and bool(torch.equal(a.residual_mass, b.residual_mass))
              for a, b in zip(one_mesh, one_dev)),
          "paper path: the 1-shard mesh differs from the DeviceGraph")
    print(f"  paper path, {SHARD_QUERIES} queries at {SHARD_LANES} lanes: "
          f"{SHARD_K} shards {ms_four:.3f} ms a query, 1 shard "
          f"{ms_one_mesh:.3f}, DeviceGraph {ms_single:.3f} [{card}]; pi "
          f"err/limit {worst:.4f} (rtol {SHARD_RTOL}); repeat and 1-shard "
          f"bit-equal; launches {SHARD_K} shards {four_launches}, "
          f"DeviceGraph {one_launches}")
    # a push launches K2 on every shard each sweep, and up to
    # CHECK_EVERY - 1 sweeps past convergence move nothing
    k2 = four_launches["ell_spmm_sliced"]
    check(k2 % SHARD_K == 0 and k2 >= SHARD_K * sweeps > 0
          and four_launches["endpoint_fold"] == SHARD_K * SHARD_QUERIES
          and four_launches["ell_spmm"] == 0,
          f"paper path: {SHARD_K} shards launched {four_launches} for "
          f"{sweeps} sweeps and {SHARD_QUERIES} queries")
    del one_dev, four, four_again, one_mesh
    sg3 = web.device(mesh=meshes[3])
    res3 = fora_fused(sg3, psrcs, params, 0, num_walks=SHARD_LANES,
                      device=dev)
    pi3 = res3.pi.cpu().numpy()
    mask = pexact >= 1.0 / web.n
    rel3 = float((np.abs(pi3 - pexact)[mask] / pexact[mask]).max())
    print(f"  3 shards of {sg3.rows_per_shard} rows: lanes "
          f"{res3.walks_budget}, max rel err {rel3:.4f} against phase 3's "
          f"power iteration over {len(psrcs)} sources, row sums "
          f"{np.round(pi3.sum(axis=1), 5).tolist()}")
    check(res3.walks_budget % 3 == 0 and res3.walks_budget >= SHARD_LANES,
          f"3 shards: lane count {res3.walks_budget}")
    check(np.allclose(pi3.sum(axis=1), 1.0, atol=1e-3) and rel3 < 0.5,
          f"3 shards: rel err {rel3} or rows off 1")
    del sg3, res3

    # device time of K2 on a shard's block against the whole table, and of
    # the combine a sweep
    x = mass_rows(gen, 1, web.n, dev)
    k2_block = device_ms(lambda: ell_spmv.ell_spmm_sliced_cuda(
        sg4.in_neighbors[0], sg4.in_mask[0], sg4.in_weights[0],
        sg4.in_row_map[0], x, thr, sg4.in_fold[0]), SHARD_REPS)
    k2_whole = device_ms(lambda: ell_spmv.ell_spmm_sliced_cuda(
        single.in_neighbors, single.in_mask, single.in_weights,
        single.in_row_map, x, thr, single.in_fold), SHARD_REPS)
    parts = [ell_spmv.ell_spmm_sliced_cuda(
        sg4.in_neighbors[s], sg4.in_mask[s], sg4.in_weights[s],
        sg4.in_row_map[s], x, thr, sg4.in_fold[s]) for s in range(SHARD_K)]

    def frame_sum():
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    sum_ms = device_ms(frame_sum, SHARD_REPS)
    print(f"  K2 device time, B=1: shard block 0 ({sg4.rows_per_shard} "
          f"rows) {k2_block * 1e3:.2f} us, whole table ({rows} rows) "
          f"{k2_whole * 1e3:.2f} us; the combine (sum of {SHARD_K} (1, n) "
          f"frames) {sum_ms * 1e3:.2f} us a sweep [{card}]")

    # 2. the Pokec-order dense table in 4 row blocks
    pparams = ForaParams(epsilon=0.5, rmax_scale=POKEC_RMAX_SCALE)
    pdg = pokec.device(dev)
    t0 = time.perf_counter()
    psg = ShardedDeviceGraph.from_graph(pokec, meshes[SHARD_K])
    torch.cuda.synchronize()
    pbuild_s = time.perf_counter() - t0
    print(f"  pokec order: dense {tuple(pdg.in_neighbors.shape)} in "
          f"{SHARD_K} row blocks of {psg.rows_per_shard} ({psg.ell_nbytes} "
          f"bytes), built in {pbuild_s:.2f}s; row plan lanes "
          f"{psg.in_plan[0].lanes} (DeviceGraph {pdg.in_plan.lanes})")
    check(psg.layout == "dense"
          and psg.rows_per_shard == -(-pokec.n // SHARD_K),
          "the Pokec-order shards are not its row blocks")
    pthr = threshold(pokec, pparams)
    x = mass_rows(gen, 1, pokec.n, dev)
    routes = []
    for s in range(SHARD_K):
        tab = (psg.in_neighbors[s], psg.in_mask[s], psg.in_weights[s])
        before = ell_spmv.ROUTES["ell_spmm_frontier"]
        ell_spmv.ell_spmm_cuda(*tab, x, pthr, psg.in_plan[s])
        routes.append("frontier" if ell_spmv.ROUTES["ell_spmm_frontier"]
                      > before else "plain")
        hold("ell_spmm",
             lambda t=tab, s=s: ell_spmv.ell_spmm_cuda(*t, x, pthr,
                                                       psg.in_plan[s]),
             lambda t=tab: ref.ell_spmm_ref(t[0], t[1], x.double(),
                                            t[2].double(), pthr.double()),
             f"pokec shard {s}/{SHARD_K} B=1 ({routes[-1]} route)")
    print(f"  K1 routes on the row blocks at B = 1: {routes} "
          f"(frontier_group(n={pokec.n}, 1) = "
          f"{ell_spmv.frontier_group(pokec.n, 1)})")
    k1_block = device_ms(lambda: ell_spmv.ell_spmm_cuda(
        psg.in_neighbors[0], psg.in_mask[0], psg.in_weights[0], x, pthr,
        psg.in_plan[0]), SHARD_REPS)
    k1_whole = device_ms(lambda: ell_spmv.ell_spmm_cuda(
        pdg.in_neighbors, pdg.in_mask, pdg.in_weights, x, pthr,
        pdg.in_plan), SHARD_REPS)
    blocks = [ell_spmv.ell_spmm_cuda(psg.in_neighbors[s], psg.in_mask[s],
                                     psg.in_weights[s], x, pthr,
                                     psg.in_plan[s])
              for s in range(SHARD_K)]
    cat_ms = device_ms(lambda: torch.cat([b.t() for b in blocks])[
        :pokec.n].t(), SHARD_REPS)
    print(f"  K1 device time, B=1 on mass rows ({routes[0]} route): row "
          f"block 0 ({psg.rows_per_shard} rows) {k1_block * 1e3:.2f} us, "
          f"whole table ({pokec.n} rows) {k1_whole * 1e3:.2f} us; the "
          f"combine (blocks put together) {cat_ms * 1e3:.2f} us a sweep "
          f"[{card}]")
    del blocks, parts
    lanes = ForaExecutor(workload=PprWorkload(pokec, POKEC_QUERIES, seed=0),
                         params=pparams, device=dev)._calibrate_walk_budget()
    pwork = PprWorkload(pokec, POKEC_QUERIES, seed=0)
    ell_spmv.reset_launches()
    pone, pms_one = queries(pdg, pwork, pparams, SHARD_POKEC_QUERIES, lanes)
    ell_spmv.reset_launches()
    pfour, pms_four = queries(psg, pwork, pparams, SHARD_POKEC_QUERIES,
                              lanes)
    p_launch = dict(ell_spmv.LAUNCHES)
    p_front = ell_spmv.ROUTES["ell_spmm_frontier"]
    psweeps = sum(int(r.push_iters) for r in pfour)
    pworst = held(pfour, pone, f"pokec {SHARD_K} shards")
    short = sum(int(r.walks_short.sum()) for r in pfour + pone)
    print(f"  pokec order, {SHARD_POKEC_QUERIES} queries at {lanes} lanes: "
          f"{SHARD_K} shards {pms_four:.3f} ms a query, DeviceGraph "
          f"{pms_one:.3f} [{card}]; pi err/limit {pworst:.4f}; rows "
          f"walks_short {short}; K1 launches {p_launch['ell_spmm']} "
          f"({p_front} on the frontier route) for {psweeps} sweeps")
    check(short == 0, "pokec: a sharded row ran short of its walks")
    check(p_launch["ell_spmm"] % SHARD_K == 0
          and p_launch["ell_spmm"] >= SHARD_K * psweeps > 0,
          "pokec: the shards' K1 launches do not match the sweeps")
    del pone, pfour, psg

    # 3. the executor and serve with devices = 2 on one card
    ex1 = ForaExecutor(workload=PprWorkload(small, 8, seed=0), params=params,
                       device=dev, devices=1)
    ex1.warmup()
    check(isinstance(ex1.device_graph, DeviceGraph),
          "ForaExecutor(devices=1) did not take the DeviceGraph")
    count = torch.cuda.device_count()
    ex2 = ForaExecutor(workload=PprWorkload(small, 8, seed=0), params=params,
                       device=dev, devices=2)
    if count >= 2:
        ex2(list(range(2)))
        check(isinstance(ex2.device_graph, ShardedDeviceGraph),
              "ForaExecutor(devices=2) on two cards is not sharded")
        print(f"  {count} cards: ForaExecutor(devices=2) ran sharded")
    else:
        try:
            ex2(list(range(2)))
            refused = ""
        except ValueError as e:
            refused = str(e)
        print(f"  ForaExecutor(devices=2) on {count} card: {refused!r}")
        check(f"devices=2 requested but only {count} present" in refused,
              "ForaExecutor(devices=2) on one card was not refused")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                                   if env.get("PYTHONPATH") else []))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
             "ppr", "--devices", "2", "--scale", "512"], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=300)
        said = (proc.stdout + proc.stderr).strip().splitlines()
        print(f"  serve --devices 2: exit {proc.returncode}, "
              f"{said[-1] if said else ''!r}")
        check(proc.returncode != 0 and any(
            f"--devices 2 but only {count} device(s) present" in line
            for line in said), "serve --devices 2 was not refused")
    print(f"  phase 12 wall {time.perf_counter() - t_phase:.1f}s")
    return errs


@contextmanager
def recorded_drops():
    """While open, every MoE bucketing records its dropped (token, k)
    entries, a (T, K) bool on the host a call, into the list it yields."""
    from repro_torch.models import moe

    seen: list = []
    bucket = moe.bucket

    def recording(gate_i, num_experts, capacity):
        out = bucket(gate_i, num_experts, capacity)
        seen.append((out[2] == num_experts * capacity)
                    .reshape(gate_i.shape).cpu())
        return out

    moe.bucket = recording
    try:
        yield seen
    finally:
        moe.bucket = bucket


@contextmanager
def annotated_moe():
    """While open, each MoE stage of ``models/moe.py`` runs inside a
    ``record_function`` range named after its part of the split: routing,
    bucketing and the gather into capacity slots "moe:dispatch", the
    experts' products "moe:experts", the combine "moe:combine"."""
    from torch.profiler import record_function

    from repro_torch.models import moe

    saved = {name: getattr(moe, name) for name in MOE_STAGES}

    def annotate(name, fn):
        def run(*args, **kwargs):
            with record_function(f"moe:{MOE_STAGES[name]}"):
                return fn(*args, **kwargs)
        return run

    for name, fn in saved.items():
        setattr(moe, name, annotate(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)


def profile_split(label: str, fn) -> None:
    """Where one call of an LM step spends the card's time, under
    ``torch.profiler``: K6 by kernel name; the MoE stages by the range
    (:func:`annotated_moe`) around the op that launched each kernel; other
    GEMMs by that op (mm, bmm, addmm, matmul, linear); the rest (norms,
    rotary, embedding, cache writes, elementwise); and the share of the
    wall time the card was idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with annotated_moe(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    busy = k6 = 0.0
    for e in events:
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            us = e.time_range.elapsed_us()
            busy += us
            if any(k in e.name for k in K6_KERNELS):
                k6 += us
    split = {"GEMMs": 0.0, "MoE experts": 0.0, "MoE dispatch": 0.0,
             "MoE combine": 0.0}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        chain, up = [], e
        while up is not None:
            chain.append(up.name)
            up = up.cpu_parent
        us = sum(kern.duration for kern in e.kernels
                 if not any(k in kern.name for k in K6_KERNELS))
        stage = next((n[len("moe:"):] for n in chain
                      if n.startswith("moe:")), None)
        if stage is not None:
            split[f"MoE {stage}"] += us
        elif any(n in GEMM_OPS for n in chain):
            split["GEMMs"] += us
    parts = {**split, "K6": k6, "other": busy - k6 - sum(split.values())}
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}; "
          + ", ".join(f"{name} {us / 1e3:.3f} ms ({us / max(busy, 1e-9):.3f})"
                      for name, us in parts.items()))


def moe_plain64(fp, m, xt, gate_w, gate_i, capacity: int,
                drop_last: bool = False, keep_all: bool = False):
    """The MoE feed-forward in float64 on a given routing, written apart
    from the port's bucketing: an entry is kept where fewer than C earlier
    entries, in (token, k) order, went to its expert (a running count of
    one-hot rows); each expert's GLU over its entries; the entries summed
    with their gate weights; the shared experts added. Returns (y (T, d)
    float64, dropped (T, K) bool). The broken versions: ``drop_last``
    drops each token's last expert too, ``keep_all`` keeps the entries
    past capacity."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.common import act_fn

    T, K = gate_i.shape
    flat = gate_i.reshape(-1)
    rank = F.one_hot(flat, m.num_experts).cumsum(0) \
        .gather(1, flat[:, None])[:, 0] - 1
    dropped = (rank >= capacity).reshape(T, K)
    w = gate_w.double()
    if not keep_all:
        w = torch.where(dropped, 0.0, w)
    if drop_last:
        w = torch.cat([w[:, :-1], torch.zeros_like(w[:, -1:])], dim=1)
    w = w.reshape(-1)
    act = act_fn(m.act)
    x64 = xt.double()
    y = torch.zeros_like(x64)
    for e in range(m.num_experts):
        entries = torch.nonzero(flat == e)[:, 0]
        tok = entries // K
        xe = x64[tok]
        h = act(xe @ fp["w_gate"][e].double()) * (xe @ fp["w_up"][e].double())
        y.index_add_(0, tok, (h @ fp["w_down"][e].double())
                     * w[entries, None])
    if "shared" in fp:
        sp = fp["shared"]
        hs = act(x64 @ sp["w_gate"].double()) * (x64 @ sp["w_up"].double())
        y += hs @ sp["w_down"].double()
    return y, dropped


def moe_layer0_check(arch_id: str, params, cfg, tokens) -> None:
    """Layer 0's MoE feed-forward on the prefill's tokens, on the card,
    against float64: the router's logits, the top-k sets, and y with its
    drops at the published capacity factor and at MOE_DROP_FACTOR, with
    the broken versions refused."""
    import dataclasses

    import torch

    from repro_torch.models import moe, transformer
    from repro_torch.models.common import rms_norm, rope_frequencies

    B, S = tokens.shape
    T = B * S
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    p = transformer.layer_params(params, 0)
    fp = p["ffn"]
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta,
                                tokens.device)
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    x = transformer._embed(params, cfg, tokens)
    h, _ = transformer._attention(p["attn"], cfg,
                                  rms_norm(x, p["ln1"], cfg.norm_eps),
                                  cos, sin, pos)
    xt = rms_norm(x + h, p["ln2"], cfg.norm_eps).reshape(T, cfg.d_model)
    del x, h
    logits, _, gate_w, gate_i = moe.route(fp, m, xt)
    l64 = xt.double() @ fp["router"].double()
    # a dot product rounds relative to sum_j |x_j r_j|, not to its value,
    # which cancels: rtol 1e-5 of both (float32 sums over d = 2,048 terms
    # err by ~sqrt(d) 2^-24 = 2.7e-6 of the first)
    terms = xt.double().abs() @ fp["router"].double().abs()
    err, ratio = limit_ratio(logits, l64, MOE_LOGIT_RTOL * (l64.abs() + terms))
    print(f"  {arch_id} MoE layer 0 on T={T} tokens, {E} experts, top {K}: "
          f"router logits (float32) max_abs_err={err:.3e} against float64, "
          f"err/limit={ratio:.4f} (rtol {MOE_LOGIT_RTOL} of |logit| + "
          f"sum|x r|)")
    check(ratio <= 1.0, f"{arch_id}: router logits off by {err}")
    top = torch.topk(torch.softmax(l64, dim=-1), K + 1, dim=-1)
    pk, pk1 = top.values[:, K - 1], top.values[:, K]
    clear = pk - pk1 > MOE_TOPK_MARGIN * pk
    same = (torch.sort(gate_i, dim=-1).values
            == torch.sort(top.indices[:, :K], dim=-1).values).all(dim=-1)
    n_close, n_differ = int((~clear).sum()), int((~same).sum())
    n_bad = int((clear & ~same).sum())
    print(f"  {arch_id} top-{K} sets: {T - n_differ} of {T} tokens equal to "
          f"float64's; {n_close} tokens with a margin p_k - p_k+1 under "
          f"{MOE_TOPK_MARGIN} p_k (not held), {n_bad} differing above it")
    check(n_bad == 0, f"{arch_id}: {n_bad} tokens route to other experts "
          f"than float64 with a clear margin")
    del l64, terms, top
    for factor in (m.capacity_factor, MOE_DROP_FACTOR):
        mc = dataclasses.replace(m, capacity_factor=factor)
        C = mc.capacity(T)
        y, _ = moe.moe_apply(fp, mc, xt.reshape(B, S, -1))
        y = y.reshape(T, -1)
        port_dropped = (moe.bucket(gate_i, E, C)[2] == E * C).reshape(T, K)
        y64, dropped = moe_plain64(fp, mc, xt, gate_w, gate_i, C)
        check(bool(torch.equal(port_dropped, dropped)),
              f"{arch_id}: the port drops other entries than the plain "
              f"version at capacity factor {factor}")
        # y passes through about K + 9 roundings to bfloat16 (2^-8 of a
        # value each): the gate and up products, the activation, their
        # product, the down product, the gate weight, each weighted entry,
        # the K - 1 adds, the shared path's four and the last add. The
        # hidden elements' reach y through sums of F products, so y's error
        # is a sum of many independent roundings, std ~ 2^-8 std(y)
        # (0.67 of it in a CPU rehearsal at qwen2-moe's widths), and its
        # largest over T d outputs ~6 std ~ 2^-8 max|y|. The limit leaves
        # about twice that; a lost expert moves y by its weighted output,
        # ~0.1-0.2 std(y) an element.
        limit = 2.0**-8 * (MOE_Y_REL * y64.abs()
                           + MOE_Y_MAX * float(y64.abs().max()))
        err, ratio = limit_ratio(y, y64, limit)
        print(f"  {arch_id} MoE layer 0 y (bf16) at capacity factor {factor}"
              f" (C={C}): {int(dropped.sum())} of {T * K} (token, k) entries "
              f"dropped, the same as the plain version's; max_abs_err="
              f"{err:.3e} max|y|={float(y64.abs().max()):.3e} err/limit="
              f"{ratio:.4f} {'ok' if ratio <= 1 else 'FAIL'}")
        check(ratio <= 1.0, f"{arch_id}: MoE y off by {err} (ratio {ratio})")
        broken = [("each token's last expert dropped",
                   dict(drop_last=True))]
        if factor == MOE_DROP_FACTOR:
            broken.append(("capacity ignored (overflow kept)",
                           dict(keep_all=True)))
        for bad, kw in broken:
            yb, _ = moe_plain64(fp, mc, xt, gate_w, gate_i, C, **kw)
            _, r = limit_ratio(yb, y64, limit)
            print(f"  {arch_id} MoE broken: {bad:34s} err/limit={r:.4g} "
                  f"{'refused' if r > 1 else 'PASSED'}")
            check(r > 1.0, f"{arch_id}: the MoE check passes a broken "
                  f"version ({bad})")
            del yb
        del y, y64


def lm_family_model(arch_id: str, layers, steps: int, dev, gen, card: str,
                    sms: int, stats: dict) -> int:
    """One LM of phase 13 on the card: its main path (prefill, then greedy
    decode through K6), its checks, its times; returns its K6 launches."""
    import dataclasses

    import torch

    from repro_torch.configs import LMArch, get_arch
    from repro_torch.kernels import flash_attention
    from repro_torch.models import transformer
    from repro_torch.models.common import rope_frequencies

    base = get_arch(arch_id)
    arch = base if layers is None else LMArch(
        arch_id, dataclasses.replace(base.cfg, n_layers=layers),
        base.smoke_cfg)
    cfg = arch.cfg
    B, S = LM_BATCH, LM_PROMPT
    Smax = S + LM_CACHE_SLACK
    depth = (f"depth cut to {layers} of {base.cfg.n_layers} layers ("
             f"{base.cfg.param_count * 2 / 1e9:.2f} GB of bf16 weights in "
             f"all)" if layers else "depth as published")
    print(f"  {arch_id}: cut: prefill_32k B=32 S=32768 -> B={B} S={S}; "
          f"decode_32k B=128 cache 32768 -> B={B} cache {Smax}, {steps} "
          f"greedy steps; {depth}; width as published")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = arch.init_params(gen, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.parameters())
    check(n_params == cfg.param_count,
          f"{arch_id} has {n_params} parameters, config {cfg.param_count}")
    ffn = (f"{cfg.moe.num_experts} experts of d_ff {cfg.moe.d_ff_expert}, "
           f"top {cfg.moe.top_k}, {cfg.moe.num_shared} shared"
           if cfg.moe else f"d_ff {cfg.d_ff}")
    print(f"  {arch_id} init: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} query heads on {cfg.n_kv_heads} KV heads, Dh "
          f"{cfg.head_dim}, {ffn}, vocab {cfg.vocab}, qkv bias "
          f"{cfg.qkv_bias}, {cfg.dtype}: {n_params} parameters ("
          f"{cfg.active_param_count} active), {n_params * 2 / 1e9:.2f} GB, "
          f"{time.perf_counter() - t0:.2f}s")
    prompt = arch.make_inputs("prefill_32k", gen, dev, batch=B, seq=S)
    prefill = arch.build_step("prefill_32k")
    decode = arch.build_step("decode_32k")
    prefill(params, {"tokens": prompt["tokens"][:, :128]})     # warm up
    torch.cuda.synchronize()

    # the main path: prefill, then greedy decode against the cache
    flash_attention.reset_launches()
    t0 = time.perf_counter()
    logits, kv = prefill(params, prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    cache = transformer.make_kv_cache(cfg, B, Smax, device=dev)
    cache[:, :, :, :S] = kv
    first_token = logits.argmax(-1, keepdim=True).to(torch.int32)
    token = first_token
    step_ms, first_logits = [], None
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = decode(params, {"token": token, "kv_cache": cache,
                                "cache_len": S + t})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if first_logits is None:
            first_logits = lg
        token = lg.argmax(-1, keepdim=True).to(torch.int32)
    main_peak = torch.cuda.max_memory_allocated(dev)
    launches = flash_attention.LAUNCHES["flash_attention"]
    routes = {way: flash_attention.LAUNCHES[f"flash_attention_{way}"]
              for way in ("mma", "split")}
    want_launches = cfg.n_layers * (1 + steps)
    want_routes = {"mma": cfg.n_layers, "split": cfg.n_layers * steps}
    print(f"  {arch_id} prefill B={B} S={S}: {t_prefill:.3f}s, "
          f"{B * S / t_prefill:.0f} tokens/s; decode {steps} steps: "
          f"{np.mean(step_ms):.3f} ms a step mean, "
          f"{np.median(step_ms):.3f} median, {max(step_ms):.3f} max "
          f"({B / np.mean(step_ms) * 1e3:.0f} tokens/s); K6 launches "
          f"{launches} (want {want_launches}): route A (mma) "
          f"{routes['mma']} (want {want_routes['mma']}), route B (split) "
          f"{routes['split']} (want {want_routes['split']})  [{card}]")
    for kind, sid, seconds in (("prefill", "prefill_32k", t_prefill),
                               ("decode step", "decode_32k",
                                np.median(step_ms) / 1e3)):
        flops = arch.model_flops(sid, batch=B, seq=S)
        nbytes = arch.model_bytes(sid, batch=B, seq=S)
        least = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
        print(f"  {arch_id} {kind} roofline (model_flops/model_bytes at "
              f"B={B} S={S}, {cfg.n_layers} layers): {flops:.4e} flops, "
              f"{nbytes:.4e} bytes, least {least * 1e3:.3f} ms against "
              f"{seconds * 1e3:.3f} ms measured ({least / seconds:.4f} of "
              f"the roofline)")
    check(bool(torch.isfinite(logits).all() and torch.isfinite(lg).all()),
          f"{arch_id}: non-finite logits")
    check(launches == want_launches,
          f"{arch_id} launched K6 {launches} times, not {want_launches}")
    check(routes == want_routes, f"{arch_id}'s K6 routes {routes}, not "
          f"{want_routes}")

    if cfg.moe or arch_id == LEAD_MODEL:
        # the path's prefill again, its MoE drops recorded
        with recorded_drops() as drops:
            again, kv_again = prefill(params, prompt)
        if cfg.moe:
            per_layer = [int(d.sum()) for d in drops]
            print(f"  {arch_id} prefill at capacity factor "
                  f"{cfg.moe.capacity_factor} (C="
                  f"{cfg.moe.capacity(B * S)}): {sum(per_layer)} of "
                  f"{len(drops) * drops[0].numel()} MoE entries dropped "
                  f"over {len(drops)} layers, by layer {per_layer}")
        if arch_id == LEAD_MODEL:
            same = bool(torch.equal(again, logits)
                        and torch.equal(kv_again, kv))
            print(f"  {arch_id} prefill again: logits and cache "
                  f"{'the same bits' if same else 'DIFFER'}")
            check(same, f"{arch_id}: a second prefill gave other bits")
        del again, kv_again

    # decode's logits for token S equal a prefill's over S + 1 tokens. A
    # capacity-bound MoE drops entries by their place in the batch, and with
    # random weights the deeper layers send most tokens to a few experts, so
    # at the published factor the two prefills drop different entries. An
    # MoE model is held to the identity at capacity factor E / K, where
    # C >= T (an expert takes at most one entry a token), both prefills
    # recorded drop-free; its decode step cannot drop either (at most B <=
    # 8 <= C entries an expert).
    longer = torch.cat([prompt["tokens"], first_token], dim=1)
    with recorded_drops() as drops:
        if cfg.moe:
            roomy = LMArch(arch_id, dataclasses.replace(
                cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=cfg.moe.num_experts
                    / cfg.moe.top_k)), base.smoke_cfg)
            _, kv_roomy = roomy.build_step("prefill_32k")(params, prompt)
            cache_roomy = transformer.make_kv_cache(cfg, B, Smax, device=dev)
            cache_roomy[:, :, :, :S] = kv_roomy
            del kv_roomy
            first_logits, _ = roomy.build_step("decode_32k")(
                params, {"token": first_token, "kv_cache": cache_roomy,
                         "cache_len": S})
            del cache_roomy
            full_logits, _ = roomy.build_step("prefill_32k")(
                params, {"tokens": longer})
        else:
            full_logits, _ = prefill(params, {"tokens": longer})
    if cfg.moe:
        dropped = sum(int(d.sum()) for d in drops)
        print(f"  {arch_id} decode vs prefill at capacity factor "
              f"{cfg.moe.num_experts / cfg.moe.top_k:.4g}: {dropped} MoE "
              f"entries dropped over {len(drops)} layer calls")
        check(len(drops) == 3 * cfg.n_layers and dropped == 0,
              f"{arch_id}: {dropped} entries dropped where none may be")
    scale = float(full_logits.abs().max())
    diff = float((first_logits - full_logits).abs().max())
    agree = float((first_logits.argmax(-1) == full_logits.argmax(-1))
                  .float().mean())
    print(f"  {arch_id} decode logits at position {S} vs prefill over "
          f"{S + 1} tokens: max|diff| {diff:.4e} (limit {LM_LOGIT_TOL} * "
          f"{scale:.4e}), argmax agreement {agree:.2f}")
    check(diff <= LM_LOGIT_TOL * scale, f"{arch_id}: decode and prefill "
          f"disagree: {diff} > {LM_LOGIT_TOL} * {scale}")
    del full_logits, longer, kv

    if cfg.moe:
        moe_layer0_check(arch_id, params, cfg, prompt["tokens"])
    if arch_id == LEAD_MODEL:
        profile_split(f"{arch_id} prefill B={B} S={S}",
                      lambda: prefill(params, prompt))
        profile_split(f"{arch_id} decode step B={B} at {S}",
                      lambda: decode(params, {"token": first_token,
                                              "kv_cache": cache,
                                              "cache_len": S}))
    if arch_id in K6_FAMILY:
        cos, sin = rope_frequencies(cfg.head_dim, Smax, cfg.rope_theta, dev)
        pos = torch.arange(S, device=dev).expand(B, S)
        q0, k0, v0 = layer0_qkv(params, cfg, prompt["tokens"], pos, cos, sin)
        mid = S + steps // 2
        qd = layer0_qkv(params, cfg, first_token,
                        torch.full((B, 1), mid, device=dev), cos, sin)[0]
        layer0 = cache[0].clone()       # its (B, Smax, H, Dh) views' strides
    torch.cuda.synchronize()
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"  {arch_id} peak device memory (torch.cuda.max_memory_allocated)"
          f": {main_peak / 1e9:.2f} GB through the main path, "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB with the "
          f"checks, of {total / 1e9:.2f} GB")
    del params, cache, logits, lg, first_logits, prompt
    torch.cuda.empty_cache()
    if arch_id in K6_FAMILY:
        ck, cv = layer0[0], layer0[1]
        k6_check(f"{arch_id} prefill layer 0 B={B} S={S} bf16", q0, k0, v0,
                 True, 0, sms, stats)
        k6_check(f"{arch_id} decode q_offset={mid} cache {Smax}", qd, ck,
                 cv, True, mid, sms, stats)
        k6_event_times(f"{arch_id} prefill", q0, k0, v0, 0, 20, card, sms)
        k6_event_times(f"{arch_id} decode", qd, ck, cv, mid, 200, card, sms)
        del q0, k0, v0, qd, layer0, ck, cv
    torch.cuda.empty_cache()
    return launches


def phase13_family(dev, gen, card: str) -> tuple[int, float]:
    """The LM family beyond gemma-2b on the card; returns (K6 launches on
    the paths, K6's largest error against float64 in the checks)."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"phase 13: the MoE and dense LMs through K6 and the MoE "
          f"feed-forward, card {card}")
    stats = {"max_abs_err": 0.0}
    launches = 0
    for arch_id, layers, steps in LM_FAMILY:
        t0 = time.perf_counter()
        launches += lm_family_model(arch_id, layers, steps, dev, gen, card,
                                    sms, stats)
        print(f"  {arch_id} wall {time.perf_counter() - t0:.1f}s")
    return launches, stats["max_abs_err"]


# ---------------------------------------------------------------------------
# phase 14: the GNN family


def gnn_segment_launches(arch_id: str, cfg) -> int:
    """segment_reduce calls of one forward, from the model's structure:
    GCN one a layer (its degrees are the plans' counts), PNA four a layer
    (mean, mean of squares, max, min; the counts again from the plan),
    GraphCast one a processor block, DimeNet one a block (the triplet sum)
    and two more (the node sum, the graph sum)."""
    return {"gcn-cora": lambda: cfg.n_layers,
            "pna": lambda: 4 * cfg.n_layers,
            "graphcast": lambda: cfg.n_layers,
            "dimenet": lambda: cfg.n_blocks + 2}[arch_id]()


def gnn_train_launches(arch_id: str, cfg) -> tuple[int, int]:
    """(segment_reduce, segment_reduce_grad) calls of one train step, from
    the model's structure: each forward reduction once, and once more
    where GraphCast recomputes its blocks in the backward; one
    segment_reduce a gather that carries a gradient (its backward: GCN's
    h[src], PNA's and GraphCast's h[src] and h[dst], DimeNet's two rows by
    idx_kj); one segment_reduce_grad a forward reduction."""
    forward = gnn_segment_launches(arch_id, cfg)
    depth = getattr(cfg, "n_layers", getattr(cfg, "n_blocks", 0))
    gathers = {"gcn-cora": 1, "pna": 2, "graphcast": 2, "dimenet": 2}
    remat = forward if arch_id == "graphcast" else 0
    return forward + remat + gathers[arch_id] * depth, forward


def din_train_launches() -> dict[str, int]:
    """Kernel calls of one DIN train step, from its structure: K5 once a
    table (the pooling), its backward once a table (each call launching
    both kernels), one segment_reduce a gather that carries a gradient
    (the history's and the target's rows of each table), and no
    segment_reduce_grad."""
    return {"embedding_bag": 2, "embedding_bag_grad_table": 2,
            "embedding_bag_grad_weights": 2, "segment_reduce": 4,
            "segment_reduce_grad": 0}


def is_float_scatter(name: str, args, kwargs) -> bool:
    """Whether a dispatched op (``OpOverload.__name__``, e.g.
    "index_add_.default") folds into a float tensor by index, as a card
    does with float atomics in no fixed order: ``index_add``,
    ``scatter_add``, ``scatter_reduce``, ``scatter`` with a reduction, or
    an accumulating ``index_put_``/``_index_put_impl_``/``put_``."""
    import torch

    base = name.split(".")[0].rstrip("_")
    target = args[0] if args else None
    if not (isinstance(target, torch.Tensor)
            and target.dtype.is_floating_point):
        return False
    if base in ("index_add", "scatter_add", "scatter_reduce"):
        return True
    if base == "scatter":
        return len(args) > 4 or "reduce" in kwargs
    if base in ("index_put", "_index_put_impl", "put"):
        accumulate = kwargs.get("accumulate", args[3] if len(args) > 3
                                else False)
        return bool(accumulate)
    return False


def gnn_output_shape(arch, shape_id: str) -> tuple[int, int]:
    from repro_torch.configs.base import GNN_SHAPES, _pad

    s = GNN_SHAPES[shape_id]
    cfg = arch.config(shape_id=shape_id)
    if arch.arch_id == "dimenet":
        return (s["graphs"], cfg.n_out)
    if arch.arch_id == "graphcast":
        return (_pad(s["n"]), cfg.n_out)
    return (_pad(s["n"]), cfg.n_classes)


@contextmanager
def recorded_segments(last: bool = False):
    """While open, every ``ops.segment_reduce`` call (with ``last``, only
    the latest) is recorded, (values, plan, op), into the list it
    yields."""
    from repro_torch.kernels import ops

    seen: list = []
    reduce = ops.segment_reduce

    def recording(values, plan, op):
        if last:
            seen.clear()
        seen.append((values, plan, op))
        return reduce(values, plan, op)

    ops.segment_reduce = recording
    try:
        yield seen
    finally:
        ops.segment_reduce = reduce


@contextmanager
def recorded_gathers():
    """While open, every ``ops.gather_rows`` call is recorded, (rows,
    index, plan), into the list it yields: the plan whose segment sum is
    the gather's backward."""
    from repro_torch.kernels import ops

    seen: list = []
    gather = ops.gather_rows

    def recording(x, index, plan):
        seen.append((x, index, plan))
        return gather(x, index, plan)

    ops.gather_rows = recording
    try:
        yield seen
    finally:
        ops.gather_rows = gather


def check_label(arch_id: str, shape_id: str, i: int) -> str:
    """The label of a cell's i-th recorded aggregation: GCN's are its
    layers, the others' the first layer's."""
    layer = i if arch_id == "gcn-cora" else 0
    return f"{arch_id} {shape_id} layer {layer} #{i}"


@contextmanager
def annotated_plans():
    """While open, each GNN model's ``segment_plan`` runs inside a
    ``record_function`` range named "gnn:plan" (the stable sort, the
    offsets and the keys)."""
    from torch.profiler import record_function

    from repro_torch.kernels import ops
    from repro_torch.models.gnn import dimenet, gcn, graphcast, pna

    mods = (dimenet, gcn, graphcast, pna)

    def annotated(index, num_segments, **kw):
        with record_function("gnn:plan"):
            return ops.segment_plan(index, num_segments, **kw)

    for m in mods:
        m.segment_plan = annotated
    try:
        yield
    finally:
        for m in mods:
            m.segment_plan = ops.segment_plan


def gnn_profile(label: str, fn) -> None:
    """Where one forward spends the card's time, under ``torch.profiler``:
    ``segment_reduce`` by kernel name; the plans (sort, offsets, keys) by
    their range; GEMMs and gathers by the op that launched each kernel;
    ``segment_reduce_grad`` by kernel name; the rest (elementwise, norms,
    concatenations, AdamW); and the share of the wall time the card was
    idle. Not gated: a window that lost its device
    events is printed as such."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with annotated_plans(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        busy = seg = grad = 0.0
        for e in events:
            if e.device_type == DeviceType.CUDA and \
                    not getattr(e, "is_user_annotation", False):
                us = e.time_range.elapsed_us()
                busy += us
                if any(k in e.name for k in SEGMENT_KERNELS):
                    seg += us
                elif any(k in e.name for k in GRAD_KERNELS):
                    grad += us
        if busy > 0:
            break
        print(f"  (profile {label} lost its device events; again)")
    else:
        print(f"  profile {label}: not measured (the profiler recorded no "
              f"device time in {PROFILE_TRIES} windows)")
        return
    split = {"plan": 0.0, "GEMMs": 0.0, "gathers": 0.0}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        chain, up = [], e
        while up is not None:
            chain.append(up.name)
            up = up.cpu_parent
        us = sum(k.duration for k in e.kernels
                 if not any(s in k.name
                            for s in SEGMENT_KERNELS + GRAD_KERNELS))
        if "gnn:plan" in chain:
            split["plan"] += us
        elif any(n in GEMM_OPS for n in chain):
            split["GEMMs"] += us
        elif any(n in GATHER_OPS for n in chain):
            split["gathers"] += us
    parts = {**split, "segment_reduce": seg}
    if grad:
        parts["segment_reduce_grad"] = grad
    parts["elementwise and the rest"] = busy - seg - grad - sum(
        split.values())
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}; "
          + ", ".join(f"{name} {us / 1e3:.3f} ms ({us / max(busy, 1e-9):.3f})"
                      for name, us in parts.items()))


def queued_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, with the calls queued behind a sleep kernel so that the card
    runs them back to back whatever the host's pace (a short kernel's
    launch costs the host more than the card's run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(QUEUE_CYCLES_PER_CALL * reps))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def segment_bound(plan, d: int) -> float:
    """Least ms of a reduction on the card: the rows inside segments read
    once, their order entries (or keys, on the contiguous route) and the
    offsets read once, the output written once, over the memory rate
    (float32, int32)."""
    off = plan.offsets
    rows = int(off[-1] - off[0])
    S = plan.num_segments
    return (rows * d + rows + S + 1 + S * d) * 4 / HBM_BYTES_PER_S * 1e3


SEG_IDENT = {"sum": 0.0, "max": -math.inf, "min": math.inf}


def plain_fold(rows, seg, S: int, op: str):
    """The float64 plain fold of (P, w) rows into S segments by seg (P,)."""
    import torch

    out = torch.full((S, rows.shape[1]), SEG_IDENT[op], dtype=rows.dtype,
                     device=rows.device)
    if op == "sum":
        return out.index_add_(0, seg, rows)
    return out.scatter_reduce_(0, seg[:, None].expand_as(rows), rows,
                               "amax" if op == "max" else "amin")


def column_chunks(E: int, d: int) -> list[tuple[int, int]]:
    """Column slices whose float64 copy of E rows stays near 2 GB."""
    w = max(1, min(d, (2 << 30) // max(8 * E, 1)))
    return [(c, min(c + w, d)) for c in range(0, d, w)]


def segment_positions(plan):
    """The positions inside segments, int64 on the plan's device: their
    rows, their segments, their segments' starts and ends, and the
    positions themselves."""
    import torch

    lo, hi = int(plan.offsets[0]), int(plan.offsets[-1])
    seg = plan.keys[lo:hi].long()
    rows = plan.rows()[lo:hi].long()
    off = plan.offsets.long()
    return rows, seg, off[:-1][seg], off[1:][seg], torch.arange(
        lo, hi, device=seg.device)


def segment_floors(lib_path, flat, plan, card: str, label: str,
                   write: bool) -> float:
    """One floor of ``tools/segment_floors.cu`` (measurement only) at a
    recorded shape, in device time: the read floor (every position's row
    through the order or as a stream, and its key, read once) or, with
    ``write``, the write floor (the (E, d) gradient written once as 16-byte
    units from the keys alone)."""
    import ctypes

    import torch

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = ctypes.CDLL(str(lib_path))
    for fn, args, res in (
            ("segment_read_floor_launch", [P, P, P, L, I, I, P, P], I),
            ("segment_write_floor_launch", [P, L, I, P, P], I),
            ("segment_floor_warps", [], I),
            ("segment_floors_error_string", [I], ctypes.c_char_p)):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
    E, d = flat.shape
    dev = flat.device

    def run(err):
        check(err == 0, f"segment floor kernel: CUDA error {err} "
              f"({lib.segment_floors_error_string(err).decode()})")

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa
    if write:
        grad = torch.empty((E, d), device=dev)
        ms = queued_ms(lambda: run(lib.segment_write_floor_launch(
            plan.keys.data_ptr(), E, d, grad.data_ptr(), stream())),
            SEGMENT_REPS)
        what = "the gradient written once as 16-byte units, keys read once"
        del grad
    else:
        sums = torch.empty(lib.segment_floor_warps(), device=dev)
        order = None if plan.order is None else plan.order.data_ptr()
        vec = 4 if d % 4 == 0 else 1
        ms = queued_ms(lambda: run(lib.segment_read_floor_launch(
            flat.data_ptr(), order, plan.keys.data_ptr(), E, d, vec,
            sums.data_ptr(), stream())), SEGMENT_REPS)
        what = ("each position's row " + ("through the order" if order
                                          else "as one stream")
                + " and its key read once")
    print(f"  {label}: floor {ms * 1e3:10.2f} us (device, queued events; "
          f"{what})  [{card}]")
    return ms


def segment_check(label: str, values, plan, op: str, card: str,
                  stats: dict, time_it: bool, floors_lib=None) -> None:
    """The kernel against its float64 plain version on one recorded
    aggregation, on the route its plan gives (the contiguous route where
    the plan has no order): sum within deg 2^-24 sum|v| + 1e-30 a cell,
    max and min equal; a second launch the same bits; versions that drop
    each segment's last edge, read each segment's end one edge late, and
    drop the carry of a segment across its first run boundary refused.
    Checked in column chunks (float64 copies near 2 GB). With ``time_it``,
    the kernel's time beside its bound, the plain version's and the three
    library calls'; where the kernel is slower than the fastest of them,
    the read floor (``tools/segment_floors.cu``) beside it."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr

    flat = values.reshape(values.shape[0], -1).contiguous()
    E, d = flat.shape
    S = plan.num_segments
    kern = lambda: sr.segment_reduce_cuda(  # noqa: E731
        flat, plan.order, plan.keys, plan.offsets, op)
    torch.cuda.synchronize()
    out = kern()
    again = kern()
    torch.cuda.synchronize()
    check(bool(torch.equal(out, again)), f"segment_reduce {label}: a second "
          f"launch gave other bits")
    del again
    rows, seg, starts, ends, pos = segment_positions(plan)
    R1, RL = sr.run_lengths(E, d, sr.unit_width(d))
    boundary = (starts // R1 + 1) * R1
    carried = (boundary < ends) & (pos < boundary)
    late = (ends < E) & (pos == ends - 1)       # a segment's last position
    late_rows = plan.rows().long()[ends[late]]
    broken = {"each segment's last edge dropped": pos != ends - 1,
              "each segment's end read one edge late": None,
              "a run boundary's carry dropped": ~carried}
    deg = plan.counts.double()[:, None]
    ratio, err = 0.0, 0.0
    bad_ratio = dict.fromkeys(broken, 0.0)
    for c0, c1 in column_chunks(E, d):
        part = flat[:, c0:c1]
        r64 = part[rows].double()
        want = plain_fold(r64, seg, S, op)
        got = out[:, c0:c1].double()
        if op == "sum":
            limit = deg * 2.0**-24 * plain_fold(r64.abs(), seg, S, "sum") \
                + 1e-30

            def ratio_of(x):
                return float(((x - want).abs() / limit).max())
        else:
            def ratio_of(x):
                return 0.0 if torch.equal(x, want) else float("inf")
        ratio = max(ratio, ratio_of(got))
        err = max(err, float((got - want).abs().nan_to_num(0.0).max()))
        for name, keep in broken.items():
            if keep is None:
                extra = part[late_rows].double()
                bad = plain_fold(torch.cat([r64, extra]),
                                 torch.cat([seg, seg[late]]), S, op)
            else:
                bad = plain_fold(r64[keep], seg[keep], S, op)
            bad_ratio[name] = max(bad_ratio[name], ratio_of(bad))
            del bad
        del r64, want, got
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    rule = "deg 2^-24 sum|v|" if op == "sum" else "bit-equal"
    route = "gathered" if plan.order is not None else "contiguous"
    crossing = int(((boundary < ends) & (pos == starts)).sum())
    print(f"  segment_reduce {label}: {op} of E={E} rows, d={d}, into "
          f"S={S} segments on the {route} route (largest "
          f"{int(plan.counts.max())} edges; runs of {R1} then {RL}, "
          f"{len(sr.levels(E, d))} levels, {crossing} segments "
          f"carried across a run boundary), max_abs_err={err:.3e} "
          f"err/limit={ratio:.4f} {'ok' if ratio <= 1 else 'FAIL'} "
          f"({rule}); bits repeat")
    check(ratio <= 1.0, f"segment_reduce {label}: error above its limit "
          f"(ratio {ratio})")
    for name, r in bad_ratio.items():
        print(f"  segment_reduce {label} broken: {name:40s} err/limit="
              f"{r:.4g} {'refused' if r > 1 else 'PASSED'}")
        check(r > 1.0, f"segment_reduce {label}: the check passes a broken "
              f"version ({name})")
    del rows, seg, starts, ends, pos, boundary, carried, late, late_rows
    del broken
    if not time_it:
        return
    ms = queued_ms(kern, SEGMENT_REPS)
    plain_ms = events_ms(lambda: ref.segment_reduce_ref(
        flat, plan.rows(), plan.offsets, op), 3)
    # the library calls, never on the path: index_add_ and scatter_reduce
    # (amax) over the in-segment rows with their segment ids, and
    # torch.segment_reduce over the rows already sorted by segment
    seg_of = torch.full((E,), -1, dtype=torch.long, device=flat.device)
    lo, hi = int(plan.offsets[0]), int(plan.offsets[-1])
    inside = plan.rows()[lo:hi].long()
    seg_of[inside] = plan.keys[lo:hi].long()
    keep = seg_of >= 0
    lib_rows, ids = flat[keep], seg_of[keep]
    sorted_rows = flat[inside] if plan.order is not None else flat[lo:hi]
    lengths = plan.counts.long()
    lib = {
        "index_add_": lambda: torch.zeros((S, d), device=flat.device)
        .index_add_(0, ids, lib_rows),
        "scatter_reduce amax": lambda: torch.full(
            (S, d), -float("inf"), device=flat.device).scatter_reduce_(
            0, ids[:, None].expand(-1, d), lib_rows, "amax"),
        f"torch.segment_reduce {op}": lambda: torch.segment_reduce(
            sorted_rows, op, lengths=lengths, axis=0, unsafe=True)}
    lib_ms = {name: queued_ms(fn, SEGMENT_REPS) for name, fn in lib.items()}
    bound = segment_bound(plan, d)
    stats["timed"].append((label, ms, plain_ms, bound,
                           lib_ms[f"torch.segment_reduce {op}"]))
    print(f"  segment_reduce {label}: kernel {ms * 1e3:10.2f} us (device, "
          f"queued events)  bound {bound * 1e3:9.2f} us (bytes)  plain "
          f"{plain_ms * 1e3:10.2f} us  " + "  ".join(
              f"{name} {t * 1e3:10.2f} us" for name, t in lib_ms.items())
          + f"  [{card}]")
    del seg_of, lib_rows, ids, sorted_rows, keep, inside
    if floors_lib is not None and ms > min(lib_ms.values()):
        floor = segment_floors(floors_lib, flat, plan, card,
                               f"segment_reduce {label}", write=False)
        print(f"  segment_reduce {label}: slower than "
              f"{min(lib_ms, key=lib_ms.get)}; the kernel reaches "
              f"{floor / ms:.3f} of the read floor")


def gnn_cell(arch_id: str, shape_id: str, web, dev, gen, card: str,
             stats: dict, keep: dict) -> int:
    """One GNN cell on the card through ``forward_step`` on
    ``make_inputs``: finite output and loss of the right shapes, two
    forwards with the same bits, the segment_reduce launches of the
    model's structure, ms a forward beside the least time, peak memory.
    The cell's aggregations named in GNN_CHECKS are held against float64
    plain (and timed); GNN_PROFILES are profiled. Returns the launches."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import segment_reduce

    arch = get_arch(arch_id)
    cfg = arch.config(shape_id=shape_id)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    inputs = arch.make_inputs(shape_id, gen, dev, graph=web)
    params = arch.init_params(gen, dev, shape_id=shape_id)
    torch.cuda.synchronize()
    t_inputs = time.perf_counter() - t0
    fwd = arch.forward_step(shape_id)
    n, m = int(inputs["node_mask"].sum()), int(inputs["edge_mask"].sum())
    extra = ""
    if arch_id == "dimenet":
        real = int((inputs["triplet_ji"] < inputs["edge_index"].shape[1])
                   .sum())
        extra = (f", triplets {real} of a budget of "
                 f"{inputs['triplet_ji'].shape[0]}")
    fwd(params, inputs)                                   # warm up
    torch.cuda.synchronize()
    segment_reduce.reset_launches()
    with recorded_segments() as seen, recorded_gathers() as gathers:
        t0 = time.perf_counter()
        out, loss = fwd(params, inputs)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
    launches = segment_reduce.LAUNCHES["segment_reduce"]
    peak = torch.cuda.max_memory_allocated(dev)
    want_launches = gnn_segment_launches(arch_id, cfg)
    again, loss2 = fwd(params, inputs)
    same = bool(torch.equal(out, again) and torch.equal(loss, loss2))
    ms = events_ms(lambda: fwd(params, inputs),
                   GNN_REPS.get((arch_id, shape_id), GNN_REPS_DEFAULT))
    flops, nbytes = arch.forward_flops(shape_id), arch.forward_bytes(shape_id)
    least = max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    shape = gnn_output_shape(arch, shape_id)
    print(f"  {arch_id} {shape_id}: {n} of {inputs['node_mask'].shape[0]} "
          f"nodes and {m} of {inputs['edge_mask'].shape[0]} edges real"
          f"{extra}; inputs {t_inputs:.2f}s; forward {t_main * 1e3:.3f} ms "
          f"(first), {ms:.3f} ms a forward by events; least "
          f"{least * 1e3:.3f} ms ({flops:.4e} flops at 67 TFLOP/s float32, "
          f"{nbytes:.4e} bytes at 3.35 TB/s; {least * 1e3 / ms:.4f} of it); "
          f"loss {float(loss):.6g}; output {tuple(out.shape)}; "
          f"segment_reduce launches {launches} (want {want_launches}); peak "
          f"{peak / 1e9:.2f} GB; bits repeat: {same}  [{card}]")
    check(tuple(out.shape) == shape, f"{arch_id} {shape_id}: output "
          f"{tuple(out.shape)}, not {shape}")
    check(bool(torch.isfinite(out).all() and torch.isfinite(loss)),
          f"{arch_id} {shape_id}: non-finite output or loss")
    check(same, f"{arch_id} {shape_id}: a second forward gave other bits")
    check(launches == want_launches, f"{arch_id} {shape_id}: "
          f"segment_reduce launched {launches} times, not {want_launches}")
    stats["cells"].append((arch_id, shape_id, ms, least, peak))
    calls = GNN_CHECKS.get((arch_id, shape_id), 0)
    keep[(arch_id, shape_id)] = seen[:calls]
    if (arch_id, shape_id) in GATHER_CHECKS:
        keep["gathers"] = [(x.shape[1], plan) for x, _, plan in gathers]
    del seen, gathers
    if (arch_id, shape_id) in GNN_PROFILES:
        gnn_profile(f"{arch_id} {shape_id} forward",
                    lambda: fwd(params, inputs))
    del params, inputs, out, again, loss, loss2
    torch.cuda.empty_cache()
    return launches


def phase14_gnn(dev, gen, card: str) -> dict:
    """The GNN family on the card: 13 cells at full width through
    ``forward_step``, segment_reduce against float64 plain at four real
    layer-0 aggregations, each smoke configuration card = CPU. Returns the
    kernel's row of the ``kernels`` line."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.ppr import load

    print(f"phase 14: the GNN family (GCN, PNA, GraphCast, DimeNet) through "
          f"segment_reduce, card {card}")
    t_phase = time.perf_counter()
    web = load("web-stanford", scale=1)
    stats = {"max_abs_err": 0.0, "cells": [], "timed": []}
    launches = 0
    for arch_id, cells in GNN_CELLS:
        for shape_id in cells:
            keep: dict = {}
            t0 = time.perf_counter()
            launches += gnn_cell(arch_id, shape_id, web, dev, gen, card,
                                 stats, keep)
            gathers = keep.pop("gathers", [])
            for (a, s), calls in keep.items():
                for i, (values, plan, op) in enumerate(calls):
                    segment_check(check_label(a, s, i), values, plan, op,
                                  card, stats, time_it=True,
                                  floors_lib=SEGMENT_FLOORS_LIB)
            del keep
            # the gathers' backward sums: a seeded output gradient summed
            # over the plan of each gather's index
            for i, (d, plan) in enumerate(gathers):
                g = torch.randn((plan.num_positions, d), generator=gen,
                                device=gen.device).to(dev)
                segment_check(f"{arch_id} {shape_id} layer {i} gather "
                              f"backward", g, plan, "sum", card, stats,
                              time_it=True, floors_lib=SEGMENT_FLOORS_LIB)
                del g
            del gathers
            torch.cuda.empty_cache()
            print(f"  {arch_id} {shape_id} wall "
                  f"{time.perf_counter() - t0:.1f}s")
    # each smoke configuration on the card against the same on the CPU
    for arch_id, _ in GNN_CELLS:
        arch = get_arch(arch_id)
        params, inputs = arch.smoke_case(torch.Generator().manual_seed(0),
                                         "cpu")
        fwd = arch.forward_step(smoke=True)
        want, want_loss = fwd(params, inputs)
        got, loss = fwd(params.to(dev), {k: v.to(dev)
                                         for k, v in inputs.items()})
        rtol = GNN_RTOL[arch_id]
        err = float((got.cpu() - want).abs().max())
        limit = rtol * (want.abs() + float(want.abs().max()))
        ratio = float(((got.cpu() - want).abs() / limit).max())
        lratio = abs(float(loss) - float(want_loss)) / (
            rtol * abs(float(want_loss)))
        print(f"  {arch_id} smoke config card vs CPU: max_abs_err={err:.3e} "
              f"err/limit={ratio:.4f} (rtol {rtol} of |out| + max|out|), "
              f"loss {float(loss):.8g} vs {float(want_loss):.8g} "
              f"(err/limit {lratio:.4f})")
        check(ratio <= 1.0 and lratio <= 1.0, f"{arch_id}: the smoke config "
              f"on the card is not the CPU's")
    ms, plain_ms, bound, lib_ms = next(
        (t[1], t[2], t[3], t[4]) for t in stats["timed"]
        if t[0].startswith("gcn-cora ogb_products layer 0"))
    print(f"  phase 14 wall {time.perf_counter() - t_phase:.1f}s")
    return {"name": "segment_reduce", "launches": launches,
            "max_abs_err": stats["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# phase 15: GNN training


def float_scatter_recorder():
    """A ``TorchDispatchMode`` that records, in ``.seen``, every op that
    :func:`is_float_scatter` names, forward and backward alike (autograd
    carries the mode into its backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen: list[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if is_float_scatter(func.__name__, args, kwargs):
                self.seen.append(func.__name__)
            return func(*args, **kwargs)

    return Recorder()


def segment_grad_bound(plan, d: int, op: str) -> float:
    """Least ms of the backward on the card: the g_out rows of the
    segments that have edges read once, the order (or keys) and offsets
    read once, every gradient row written once, and for max and min the
    value rows of the edges inside segments and the output rows of those
    segments read once (float32, int32)."""
    E, S = plan.num_positions, plan.num_segments
    live = int((plan.counts > 0).sum())
    inside = int(plan.offsets[-1] - plan.offsets[0])
    words = live * d + E + S + 1 + E * d
    if op != "sum":
        words += inside * d + live * d
    return words * 4 / HBM_BYTES_PER_S * 1e3


def segment_grad_broken(kind: str, want, hit, g64, seg, pos, starts, ends):
    """The float64 plain backward's rows at the positions inside segments,
    broken one way: ``first`` gives the whole gradient to the first tied
    edge of each segment and column (for a sum, to the first edge of each
    segment) and 0 to the others; ``last`` leaves each segment's last edge
    unwritten (0); ``shift`` gives each segment's first edge the row of the
    position before it (the segment before's last edge)."""
    import torch

    bad = want.clone()
    if kind == "last":
        bad[pos == ends - 1] = 0.0
        return bad
    if kind == "shift":
        first = torch.nonzero(pos == starts).flatten()
        first = first[first > 0]
        bad[first] = want[first - 1]
        return bad
    if hit is None:
        return torch.where((pos == starts)[:, None], g64[seg], 0.0)
    h = hit.long()
    seen = torch.cumsum(h, 0)
    before = (seen - h)[(starts - pos[0]).clamp(max=max(len(pos) - 1, 0))]
    return torch.where((h == 1) & (seen - before == 1), g64[seg], 0.0)


def segment_grad_check(label: str, values, plan, op: str, card: str,
                       gen, stats: dict, time_it: bool,
                       floors_lib=None) -> None:
    """The backward kernel against its float64 plain version on one
    recorded aggregation, on the route its plan gives, with a seeded
    output gradient: within rtol 1e-5 of the float64 gradient, the tied
    entries (nonzero) exactly the plain version's for max and min, the
    rows of edges in no segment 0; a second launch the same bits; the
    limit refuses a backward that gives the whole gradient to the first
    tied edge, one that leaves each segment's last edge unwritten and one
    that gives each segment's first edge the row of the position before.
    Checked in column chunks. With ``time_it``, its time beside its bound,
    the plain version's and PyTorch's own backward of the same function;
    where the kernel is slower than it, the write floor
    (``tools/segment_floors.cu``) beside it."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_reduce import (segment_reduce_cuda,
                                                    segment_reduce_grad_cuda)

    flat = values.reshape(values.shape[0], -1).contiguous()
    E, d = flat.shape
    S = plan.num_segments
    pargs = (plan.order, plan.keys, plan.offsets)
    out = segment_reduce_cuda(flat, *pargs, op)
    g_out = torch.randn((S, d), generator=gen, device=gen.device).to(
        flat.device)
    vals, outs = (None, None) if op == "sum" else (flat, out)
    kern = lambda: segment_reduce_grad_cuda(  # noqa: E731
        g_out, vals, outs, plan.order, plan.keys, plan.index, plan.offsets,
        op)
    torch.cuda.synchronize()
    got = kern()
    again = kern()
    torch.cuda.synchronize()
    check(bool(torch.equal(got, again)), f"segment_reduce_grad {label}: a "
          f"second launch gave other bits")
    del again
    rows, seg, starts, ends, pos = segment_positions(plan)
    none = torch.ones(E, dtype=torch.bool, device=flat.device)
    none[rows] = False
    outside = int(none.sum())
    check(not bool(got[none].any()), f"segment_reduce_grad {label}: an edge "
          f"in no segment has a nonzero gradient")
    del none

    def ratio_of(x, want):
        err = (x - want).abs()
        return float((err / (GRAD_RTOL * want.abs())).nan_to_num(
            0.0, posinf=float("inf")).max()) if len(err) else 0.0

    ident = SEG_IDENT[op]
    ratio, err, marks, hits = 0.0, 0.0, True, 0
    kinds = {"first": "whole gradient to the first tied edge",
             "last": "each segment's last edge unwritten",
             "shift": "each first edge the row before it"}
    bad_ratio = dict.fromkeys(kinds, 0.0)
    for c0, c1 in column_chunks(E, d):
        g64 = g_out[:, c0:c1].double()
        if op == "sum":
            hit = None
            want = g64[seg]
        else:
            o64 = out[:, c0:c1].double()
            hit = flat[rows, c0:c1].double() == o64[seg]
            ties = plain_fold(hit.double(), seg, S, "sum") + (o64 == ident)
            share = g64 * (1.0 / ties.clamp_min(1.0))
            want = torch.where(hit, share[seg], 0.0)
            hits += int(hit.sum())
            del o64, ties, share
        mine = got[rows, c0:c1].double()
        ratio = max(ratio, ratio_of(mine, want))
        err = max(err, float((mine - want).abs().max()) if len(want) else 0.0)
        marks = marks and bool(torch.equal(mine != 0, want != 0))
        del mine
        for kind in kinds:
            bad = segment_grad_broken(kind, want, hit, g64, seg, pos, starts,
                                      ends)
            bad_ratio[kind] = max(bad_ratio[kind], ratio_of(bad, want))
            del bad
        del want, hit, g64
    stats["grad_max_abs_err"] = max(stats["grad_max_abs_err"], err)
    ties_note = ""
    if op != "sum":
        ties_note = (f", {hits} tied entries marked as the plain version's: "
                     f"{marks}")
    route = "gathered" if plan.order is not None else "contiguous"
    print(f"  segment_reduce_grad {label}: {op} of E={E} rows, d={d}, S={S} "
          f"segments on the {route} route (largest "
          f"{int(plan.counts.max())} edges, {outside} edges in none), "
          f"max_abs_err={err:.3e} err/limit={ratio:.4f} "
          f"{'ok' if ratio <= 1 else 'FAIL'} (rtol {GRAD_RTOL} of float64)"
          f"{ties_note}; bits repeat")
    check(ratio <= 1.0, f"segment_reduce_grad {label}: error above its "
          f"limit (ratio {ratio})")
    check(op == "sum" or marks, f"segment_reduce_grad {label}: the tied "
          f"entries are not the plain version's")
    for kind, what in kinds.items():
        r = bad_ratio[kind]
        print(f"  segment_reduce_grad {label} broken: {what:38s} err/limit="
              f"{r:.4g} {'refused' if r > 1 else 'PASSED'}")
        check(r > 1.0, f"segment_reduce_grad {label}: the check passes a "
              f"broken version ({what})")
    del rows, seg, starts, ends, pos, got
    if not time_it:
        return
    ms = queued_ms(kern, SEGMENT_REPS)
    plain_ms = events_ms(lambda: ref.segment_reduce_grad_ref(
        g_out, vals, outs, plan.rows(), plan.offsets, op), 3)
    # PyTorch's own backward of the same function, never on the path: a
    # gather of g_out by each edge's segment for a sum, scatter_reduce's
    # autograd for max and min (its ties split as the kernel's), over the
    # edges inside segments
    kernel_grad = kern()
    seg_of = torch.full((E,), -1, dtype=torch.long, device=flat.device)
    lo, hi = int(plan.offsets[0]), int(plan.offsets[-1])
    seg_of[plan.rows()[lo:hi].long()] = plan.keys[lo:hi].long()
    keep = seg_of >= 0
    ids = seg_of[keep]
    if op == "sum":
        name = "index_select"
        lib = lambda: torch.index_select(g_out, 0, ids)  # noqa: E731
        lib_got = lib()
    else:
        name = f"scatter_reduce {'amax' if op == 'max' else 'amin'} backward"
        src = flat[keep].detach().requires_grad_(True)
        # initial value the op's identity: PyTorch counts the initial value
        # among the ties where it equals the result (a zero initial value
        # against ReLU messages whose maximum is 0), as JAX does -inf's
        red = torch.full((S, d), ident, device=flat.device).scatter_reduce(
            0, ids[:, None].expand(-1, d), src,
            "amax" if op == "max" else "amin", include_self=False)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            red, src, g_out, retain_graph=True)[0]
        lib_got = lib()
    # compared in row chunks of about 1 GB
    rows_in = keep.nonzero().flatten()
    lib_err = lib_ratio = 0.0
    step = max(1, (1 << 28) // d)
    for r0 in range(0, len(rows_in), step):
        mine = kernel_grad[rows_in[r0:r0 + step]]
        diff = (lib_got[r0:r0 + step] - mine).abs()
        lib_err = max(lib_err, float(diff.max()))
        lib_ratio = max(lib_ratio, float((diff / (GRAD_RTOL * mine.abs()))
                                         .nan_to_num(0.0, posinf=float("inf"))
                                         .max()))
        del mine, diff
    print(f"  segment_reduce_grad {label}: {name} against the kernel: "
          f"max_abs_err={lib_err:.3e} err/limit={lib_ratio:.4f} (same split "
          f"of the ties: {lib_ratio <= 1})")
    check(lib_ratio <= 1.0, f"segment_reduce_grad {label}: {name} is not "
          f"the same function")
    del kernel_grad, lib_got, rows_in
    lib_ms = queued_ms(lib, SEGMENT_REPS)
    bound = segment_grad_bound(plan, d, op)
    stats["grad_timed"].append((label, ms, plain_ms, bound, lib_ms))
    print(f"  segment_reduce_grad {label}: kernel {ms * 1e3:10.2f} us "
          f"(device, queued events)  bound {bound * 1e3:9.2f} us (bytes)  "
          f"plain {plain_ms * 1e3:10.2f} us  {name} {lib_ms * 1e3:10.2f} us"
          f"  [{card}]")
    del seg_of, ids, keep
    if floors_lib is not None and ms > lib_ms:
        floor = segment_floors(floors_lib, flat, plan, card,
                               f"segment_reduce_grad {label}", write=True)
        print(f"  segment_reduce_grad {label}: slower than {name}; the "
              f"kernel reaches {floor / ms:.3f} of the write floor")


def gnn_train_cell(arch_id: str, shape_id: str, web, dev, gen, card: str,
                   stats: dict) -> tuple[int, int]:
    """One GNN cell's train step on the card through ``build_step`` on
    ``make_inputs``, from ``init_params`` and ``adamw_init``: a finite
    loss, parameters that moved, a second step from the same start with
    the same bits (parameters, moments, loss), no float scatter recorded,
    the launches of both kernels that the model's structure gives; ms a
    step by CUDA events beside the least time, peak memory. The cell's
    aggregations named in GRAD_CHECKS are then recorded from a forward and
    held against float64 plain. Returns the two kernels' launches."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import segment_reduce
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw_init, global_norm

    arch = get_arch(arch_id)
    cfg = arch.config(shape_id=shape_id)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)        # earlier phases' tensors
    inputs = arch.make_inputs(shape_id, gen, dev, graph=web)
    params = arch.init_params(gen, dev, shape_id=shape_id)
    start = [p.detach().clone() for p in tree_leaves(params)]
    step = arch.build_step(shape_id)
    recorder = float_scatter_recorder()
    segment_reduce.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorder:
        params, state, loss = step(params, adamw_init(params), inputs)
        torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    fwd_l = segment_reduce.LAUNCHES["segment_reduce"]
    grad_l = segment_reduce.LAUNCHES["segment_reduce_grad"]
    peak = torch.cuda.max_memory_allocated(dev)
    first = [p.detach().clone() for p in tree_leaves(params)]
    moved = sum(int((a != b).sum()) for a, b in zip(first, start))
    with torch.no_grad():
        for p, s in zip(tree_leaves(params), start):
            p.copy_(s)
    # the JAX smoke_run's numbers at the start: the loss, the gradient norm
    loss0, grads = arch.grad_step(shape_id)(params, inputs)
    gnorm = float(global_norm(grads))
    del grads
    params, again, loss2 = step(params, adamw_init(params), inputs)
    same = bool(torch.equal(loss, loss2)) and all(
        torch.equal(a, b) for a, b in zip(first, tree_leaves(params))) and \
        all(torch.equal(a, b) for a, b in zip(state.m + state.v,
                                               again.m + again.v))
    del first, start, again
    ms = events_ms(lambda: step(params, state, inputs),
                   GNN_TRAIN_REPS.get((arch_id, shape_id),
                                      GNN_TRAIN_REPS_DEFAULT))
    flops, nbytes = arch.model_flops(shape_id), arch.model_bytes(shape_id)
    least = max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    want = gnn_train_launches(arch_id, cfg)
    total = sum(p.numel() for p in tree_leaves(params))
    print(f"  {arch_id} {shape_id} train step: loss {float(loss):.6g} "
          f"(at the start; gradient norm {gnorm:.6g}); "
          f"{moved} of {total} parameters moved; first step "
          f"{t_first * 1e3:.3f} ms, {ms:.3f} ms a step by events; least "
          f"{least * 1e3:.3f} ms ({flops:.4e} flops at 67 TFLOP/s float32, "
          f"{nbytes:.4e} bytes at 3.35 TB/s; {least * 1e3 / ms:.4f} of it); "
          f"launches segment_reduce {fwd_l} (want {want[0]}), "
          f"segment_reduce_grad {grad_l} (want {want[1]}); float scatters "
          f"{sorted(set(recorder.seen))}; peak {peak / 1e9:.2f} GB "
          f"({(peak - held) / 1e9:.2f} GB above the {held / 1e9:.2f} GB held "
          f"before the cell); bits repeat: {same}  [{card}]")
    check(bool(torch.isfinite(loss)) and math.isfinite(gnorm),
          f"{arch_id} {shape_id}: non-finite loss or gradient norm")
    check(bool(torch.equal(loss0, loss)), f"{arch_id} {shape_id}: grad_step "
          f"and the train step disagree on the loss")
    check(moved > 0, f"{arch_id} {shape_id}: the step moved no parameter")
    check(same, f"{arch_id} {shape_id}: a second step from the same start "
          f"gave other bits")
    check(not recorder.seen, f"{arch_id} {shape_id}: float scatters ran "
          f"in the step: {sorted(set(recorder.seen))}")
    check((fwd_l, grad_l) == want, f"{arch_id} {shape_id}: launches "
          f"{(fwd_l, grad_l)}, not {want}")
    stats["train_cells"].append((arch_id, shape_id, ms, least, peak))
    if (arch_id, shape_id) in GNN_TRAIN_PROFILES:
        gnn_profile(f"{arch_id} {shape_id} train step",
                    lambda: step(params, state, inputs))
    checks = GRAD_CHECKS.get((arch_id, shape_id), ())
    del state, loss, loss2, loss0
    if checks:
        with torch.no_grad(), recorded_segments() as seen:
            arch.forward_step(shape_id)(params, inputs)
            kept = [seen[i] for i in checks]
            seen.clear()
        del params, inputs
        torch.cuda.empty_cache()
        for i, (values, plan, op) in zip(checks, kept):
            segment_grad_check(check_label(arch_id, shape_id, i), values,
                               plan, op, card, gen, stats, time_it=True,
                               floors_lib=SEGMENT_FLOORS_LIB)
        del kept, values, plan
    torch.cuda.empty_cache()
    return fwd_l, grad_l


def smoke_train_on_card(arch_id: str, dev) -> None:
    """The smoke config's first TRAIN_SMOKE_STEPS train steps on the card
    against the same on the CPU: losses within the CPU parity tests' rtol,
    parameters and first moments within rtol |x| + rtol max|x| (second
    moments twice that rtol), except parameter entries whose CPU gradient
    was at rounding level at some step, which may flip Adam's sign: those
    within 2 sum(lr) more (tests/test_torch_gnn_train.py's rule)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    arch = get_arch(arch_id)
    rtol = GNN_RTOL[arch_id]
    cparams, inputs = arch.smoke_case(torch.Generator().manual_seed(0),
                                      "cpu")
    gparams = copy.deepcopy(cparams).to(dev)
    ginputs = {k: v.to(dev) for k, v in inputs.items()}
    cstate, gstate = adamw_init(cparams), adamw_init(gparams)
    grad_step = arch.grad_step(smoke=True)
    train_step = arch.build_step(smoke=True)
    opt = AdamWConfig()
    tiny = [torch.zeros(p.shape, dtype=torch.bool)
            for p in tree_leaves(cparams)]
    lrs, lratio = [], 0.0
    for k in range(TRAIN_SMOKE_STEPS):
        closs, grads = grad_step(cparams, inputs)
        for i, g in enumerate(grads):
            a = g.abs().double()
            tiny[i] |= a <= rtol * a + rtol * float(a.max())
        cparams, cstate, _ = adamw_update(opt, cparams, grads, cstate)
        gparams, gstate, gloss = train_step(gparams, gstate, ginputs)
        lrs.append(opt.lr * min(1.0, (k + 1) / opt.warmup_steps))
        lratio = max(lratio, abs(float(gloss) - float(closs))
                     / (rtol * abs(float(closs))))
    slack = 2.0 * sum(lrs)
    pratio = flipped = 0
    for i, (g, c) in enumerate(zip(tree_leaves(gparams),
                                   tree_leaves(cparams))):
        g, c = g.detach().cpu().double(), c.detach().double()
        limit = rtol * c.abs() + rtol * float(c.abs().max())
        err = (g - c).abs()
        flipped += int((tiny[i] & (err > limit)).sum())
        limit = torch.where(tiny[i], limit + slack, limit)
        pratio = max(pratio, float((err / limit).max()))
    mratio = 0.0
    for moments, r in ((zip(gstate.m, cstate.m), rtol),
                       (zip(gstate.v, cstate.v), 2 * rtol)):
        for g, c in moments:
            g, c = g.cpu().double(), c.double()
            limit = r * c.abs() + r * float(c.abs().max())
            mratio = max(mratio, float(((g - c).abs() / limit.clamp_min(
                1e-30)).max()))
    print(f"  {arch_id} smoke config, {TRAIN_SMOKE_STEPS} train steps card "
          f"vs CPU: loss err/limit {lratio:.4f}, parameters err/limit "
          f"{pratio:.4f} ({flipped} entries past the rtol rule, within the "
          f"sign rule's 2 sum(lr) = {slack:.3g}), moments err/limit "
          f"{mratio:.4f} (rtol {rtol})")
    check(lratio <= 1.0 and pratio <= 1.0 and mratio <= 1.0,
          f"{arch_id}: the smoke config's train steps on the card are not "
          f"the CPU's")


def phase15_gnn_train(dev, gen, card: str) -> tuple[dict, int]:
    """GNN training on the card: 13 cells at full width through
    ``build_step``, the backward kernel against float64 plain at four real
    aggregations, each smoke configuration's train steps card = CPU.
    Returns the backward kernel's row of the ``kernels`` line and the
    forward kernel's launches in the steps."""
    import torch

    from repro_torch.ppr import load

    print(f"phase 15: GNN training (the train step, AdamW, "
          f"segment_reduce_grad), card {card}")
    t_phase = time.perf_counter()
    web = load("web-stanford", scale=1)
    # the recorder sees a backward's float scatter on the card
    recorder = float_scatter_recorder()
    x = torch.ones((4, 2), device=dev, requires_grad=True)
    with recorder:
        torch.index_select(x, 0, torch.tensor([0, 0, 3], device=dev)) \
            .sum().backward()
    print(f"  recorder check: index_select's backward records "
          f"{sorted(set(recorder.seen))}")
    check(any(n.startswith("index_add") for n in recorder.seen),
          "the float scatter recorder does not see a backward's index_add")
    stats = {"grad_max_abs_err": 0.0, "train_cells": [], "grad_timed": []}
    fwd_launches = grad_launches = 0
    for arch_id, cells in GNN_CELLS:
        for shape_id in cells:
            t0 = time.perf_counter()
            f, g = gnn_train_cell(arch_id, shape_id, web, dev, gen, card,
                                  stats)
            fwd_launches += f
            grad_launches += g
            print(f"  {arch_id} {shape_id} train wall "
                  f"{time.perf_counter() - t0:.1f}s")
    for arch_id, _ in GNN_CELLS:
        smoke_train_on_card(arch_id, dev)
    ms, plain_ms, bound, lib_ms = next(
        t[1:] for t in stats["grad_timed"]
        if t[0].startswith("gcn-cora ogb_products layer 0"))
    print(f"  phase 15 wall {time.perf_counter() - t_phase:.1f}s")
    return {"name": "segment_reduce_grad", "launches": grad_launches,
            "max_abs_err": stats["grad_max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_ms}, fwd_launches


# ---------------------------------------------------------------------------
# phase 16: DIN training


@contextmanager
def recorded_din_calls():
    """While open, the arguments of every call ``ops`` makes to K5's
    wrappers (forward and backward) and to ``segment_reduce_cuda`` are
    recorded in the dict of lists it yields (the calls still run)."""
    from repro_torch.kernels import ops

    seen: dict[str, list] = {"forward": [], "backward": [], "segment": []}
    kept = (ops.embedding_bag_cuda, ops.embedding_bag_grad_cuda,
            ops.segment_reduce_cuda)

    def forward(*args):
        seen["forward"].append(args)
        return kept[0](*args)

    def backward(*args, **kwargs):
        seen["backward"].append((args, kwargs))
        return kept[1](*args, **kwargs)

    def segment(*args):
        seen["segment"].append(args)
        return kept[2](*args)

    ops.embedding_bag_cuda, ops.embedding_bag_grad_cuda, \
        ops.segment_reduce_cuda = forward, backward, segment
    try:
        yield seen
    finally:
        ops.embedding_bag_cuda, ops.embedding_bag_grad_cuda, \
            ops.segment_reduce_cuda = kept


@contextmanager
def annotated_din_step():
    """While open, DIN's batch plans run inside a ``record_function`` range
    named "din:plan" and the train step's AdamW update inside "din:adamw"."""
    from torch.profiler import record_function

    from repro_torch.configs import base
    from repro_torch.models.recsys import din

    plans, update = din.batch_plans, base.adamw_update

    def annotated_plans(cfg, batch):
        with record_function("din:plan"):
            return plans(cfg, batch)

    def annotated_update(*args, **kwargs):
        with record_function("din:adamw"):
            return update(*args, **kwargs)

    din.batch_plans, base.adamw_update = annotated_plans, annotated_update
    try:
        yield
    finally:
        din.batch_plans, base.adamw_update = plans, update


def din_profile(label: str, fn) -> dict[str, float] | None:
    """Where one DIN train step spends the card's time, under
    ``torch.profiler``: K5's forward and backward and ``segment_reduce`` by
    kernel name; the plans and AdamW by their ranges
    (:func:`annotated_din_step`); GEMMs and gathers by the op that
    launched each kernel; the rest (elementwise, concatenations, the
    loss); and the share of the wall time the card was idle. Returns the
    split in ms with the idle share, or None where every window lost its
    device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    named = {"K5 forward": BAG_KERNELS, "K5 backward": BAG_GRAD_KERNELS,
             "segment_reduce": SEGMENT_KERNELS}
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with annotated_din_step(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        busy = 0.0
        by_kernel = dict.fromkeys(named, 0.0)
        for e in events:
            if e.device_type == DeviceType.CUDA and \
                    not getattr(e, "is_user_annotation", False):
                us = e.time_range.elapsed_us()
                busy += us
                for part, kernels in named.items():
                    if any(k in e.name for k in kernels):
                        by_kernel[part] += us
        if busy > 0:
            break
        print(f"  (profile {label} lost its device events; again)")
    else:
        print(f"  profile {label}: not measured (the profiler recorded no "
              f"device time in {PROFILE_TRIES} windows)")
        return None
    ours = sum(named.values(), ())
    split = {"plans": 0.0, "AdamW": 0.0, "GEMMs": 0.0, "gathers": 0.0}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        chain, up = [], e
        while up is not None:
            chain.append(up.name)
            up = up.cpu_parent
        us = sum(k.duration for k in e.kernels
                 if not any(s in k.name for s in ours))
        if "din:plan" in chain:
            split["plans"] += us
        elif "din:adamw" in chain:
            split["AdamW"] += us
        elif any(n in GEMM_OPS for n in chain):
            split["GEMMs"] += us
        elif any(n in GATHER_OPS for n in chain):
            split["gathers"] += us
    parts = {**by_kernel, **split}
    parts["rest"] = busy - sum(parts.values())
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}; "
          + ", ".join(f"{name} {us / 1e3:.3f} ms ({us / max(busy, 1e-9):.3f})"
                      for name, us in parts.items()))
    return {**{k: v / 1e3 for k, v in parts.items()},
            "idle_share": 1 - busy / wall_us}


def bag_grad_oracle(table, ids, w, g, *, table64=None):
    """Float64 dT and dw of the plain version with their limits: a table
    cell within cnt 2^-24 sum |w| |g| (cnt the length of the row's
    segment), a dw within d 2^-24 sum_c |T| |g|."""
    import torch

    from repro_torch.kernels import ref

    t64 = table.double() if table64 is None else table64
    want_t, want_w = ref.embedding_bag_grad_ref(t64, ids, w.double(),
                                                g.double())
    abs_t, abs_w = ref.embedding_bag_grad_ref(t64.abs(), ids, w.double().abs(),
                                              g.double().abs())
    cnt = torch.bincount(ids.reshape(-1).long(),
                         minlength=table.shape[0]).double()[:, None]
    return (want_t, abs_t.mul_(cnt * 2.0**-24), want_w,
            abs_w.mul_(table.shape[1] * 2.0**-24))


def over_limit(x, want, limit) -> float:
    """The largest |x - want| over its limit (a cell whose limit is 0 must
    be exact: inf where it is not)."""
    import torch

    diff = (x.double() - want).abs()
    r = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    return float(r.nan_to_num(float("inf")).max())


def bag_grad_check(label: str, table, ids, w, g, plan, card: str,
                   stats: dict, time_it: bool) -> None:
    """K5's backward on one recorded (or built) call against its float64
    plain version: dT within cnt 2^-24 sum|w||g| a cell, the rows no id
    names exactly 0; dw within d 2^-24 sum_c |T||g|; a second call the
    same bits. Each limit must refuse two broken versions: dT with the
    last position of a short segment dropped, and with two bags' g rows
    swapped; dw with two bags' g rows swapped, and with the table's last
    column dropped. The float64 limit grows with a segment's length (about
    a tenth of sum|w||g| on the Zipf batch's hot row), so dT must also
    have the bits of ``segment_reduce_cuda`` over the float32 products
    w[r] g[r / L], materialised, on the same plan: the same fold tree on
    the same terms. That check must refuse a dT with one level-1 run's sum
    dropped inside the hottest segment, and one with a level-1 block's
    carry dropped there, where the segment spans three blocks' positions
    (both of which the float64 limit passes on the hot row). With
    ``time_it``, each kernel's time (queued events)
    beside its bound, its plain version's and ``F.embedding_bag``'s
    backward with ``per_sample_weights`` (and ``index_add_`` of the
    products, formed beforehand, beside the table's)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_grad_cuda
    from repro_torch.kernels.segment_reduce import THREADS as SEG_THREADS
    from repro_torch.kernels.segment_reduce import (geometry,
                                                    segment_reduce_cuda)

    V, d = table.shape
    B, L = ids.shape
    E = B * L
    kern = lambda **kw: embedding_bag_grad_cuda(  # noqa: E731
        table, ids, w, g, plan.order, plan.keys, plan.offsets, **kw)
    torch.cuda.synchronize()
    d_t, d_w = kern()
    again_t, again_w = kern()
    torch.cuda.synchronize()
    check(bool(torch.equal(d_t, again_t)) and bool(torch.equal(d_w, again_w)),
          f"embedding_bag_grad {label}: a second call gave other bits")
    del again_t, again_w
    want_t, lim_t, want_w, lim_w = bag_grad_oracle(table, ids, w, g)
    r_t, r_w = over_limit(d_t, want_t, lim_t), over_limit(d_w, want_w, lim_w)
    e_t = float((d_t.double() - want_t).abs().max())
    e_w = float((d_w.double() - want_w).abs().max())
    counts = plan.counts
    unnamed = counts == 0
    check(not bool(d_t[unnamed].any()), f"embedding_bag_grad {label}: a row "
          f"no id names is not 0")
    stats["table_err"] = max(stats["table_err"], e_t)
    stats["weights_err"] = max(stats["weights_err"], e_w)
    print(f"  embedding_bag_grad {label}: B={B} L={L} V={V} d={d}, "
          f"{int((~unnamed).sum())} rows named (largest "
          f"{int(counts.max())} positions); dT max_abs_err={e_t:.3e} "
          f"err/limit={r_t:.4f} {'ok' if r_t <= 1 else 'FAIL'}, dw "
          f"max_abs_err={e_w:.3e} err/limit={r_w:.4f} "
          f"{'ok' if r_w <= 1 else 'FAIL'}; bits repeat")
    check(r_t <= 1.0 and r_w <= 1.0, f"embedding_bag_grad {label}: error "
          f"above its limit (dT {r_t}, dw {r_w})")
    # the broken versions, each the float64 plain version on bent inputs
    lo, hi = BAG_SHORT_SEGMENT
    ends = plan.order[(plan.offsets[1:] - 1).clamp_min(0).long()].long()
    short = (counts >= lo) & (counts <= hi) & (w.reshape(-1)[ends] != 0)
    last = ends[torch.nonzero(short)[0, 0]]      # its weight is not masked
    w_cut = w.double().clone()
    w_cut.view(-1)[last] = 0.0
    b1 = int(last) // L
    b2 = (b1 + B // 2) % B
    g_swap = g.double().clone()
    g_swap[[b1, b2]] = g_swap[[b2, b1]]
    t64 = table.double()
    bad_t = {"a short segment's last position dropped":
             ref.embedding_bag_grad_ref(t64, ids, w_cut, g.double(),
                                        weights_grad=False)[0]}
    swapped_t, swapped_w = ref.embedding_bag_grad_ref(t64, ids, w.double(),
                                                      g_swap)
    bad_t["two bags' g rows swapped"] = swapped_t
    t64[:, d - 1] = 0.0
    bad_w = {"two bags' g rows swapped": swapped_w,
             "the table's last column dropped": ref.embedding_bag_grad_ref(
                 t64, ids, w.double(), g.double(), table_grad=False)[1]}
    del t64, w_cut, g_swap, swapped_t
    for what, bads, want, lim in (("dT", bad_t, want_t, lim_t),
                                  ("dw", bad_w, want_w, lim_w)):
        for name, bad in bads.items():
            r = over_limit(bad, want, lim)
            print(f"  embedding_bag_grad {label} broken {what}: {name:40s} "
                  f"err/limit={r:.4g} {'refused' if r > 1 else 'PASSED'}")
            check(r > 1.0, f"embedding_bag_grad {label}: the {what} check "
                  f"passes a broken version ({name})")
    del bad_t, bad_w, lim_w
    # the bits: segment_reduce over the materialised float32 products
    terms = (w[..., None] * g[:, None, :]).reshape(E, d)
    fold = lambda rows: segment_reduce_cuda(  # noqa: E731
        rows, plan.order, plan.keys, plan.offsets, "sum")
    bits = fold(terms).view(torch.int32)
    same = bool(torch.equal(d_t.view(torch.int32), bits))
    print(f"  embedding_bag_grad {label}: dT has the bits of segment_reduce "
          f"over the float32 products on the same plan: {same}")
    check(same, f"embedding_bag_grad {label}: dT's bits are not "
          f"segment_reduce's over the products")
    # broken versions that the float64 limit cannot see on a hot row: one
    # level-1 run's sum, and one level-1 block's carry (a level-2 slot),
    # dropped inside the hottest segment
    _, group, _, R1, _, _, _ = geometry(E, d)
    span = {"a level-1 run's sum": R1,
            "a level-1 block's carry": (SEG_THREADS // group) * R1}
    hot = int(counts.argmax())
    p0, p1 = int(plan.offsets[hot]), int(plan.offsets[hot + 1])
    for name, n in span.items():
        a = (-(-p0 // n) + 1) * n               # a whole span inside
        if a + n > p1:
            print(f"  embedding_bag_grad {label} broken dT: {name} dropped "
                  f"in the hottest segment: not built ({p1 - p0} positions,"
                  f" spans of {n})")
            continue
        bent = terms.clone()
        bent[plan.order[a:a + n].long()] = 0.0
        bad = fold(bent)
        r = over_limit(bad, want_t, lim_t)
        refused = r > 1.0 or not bool(torch.equal(bad.view(torch.int32),
                                                  bits))
        print(f"  embedding_bag_grad {label} broken dT: {name} dropped in "
              f"the hottest segment (row {hot}, {p1 - p0} positions; "
              f"positions {a}:{a + n}): float64 err/limit={r:.4g}, bits "
              f"{'differ' if refused else 'SAME'}: "
              f"{'refused' if refused else 'PASSED'}")
        check(refused, f"embedding_bag_grad {label}: the dT check passes a "
              f"broken version ({name} dropped in the hottest segment)")
        del bent, bad
    del bits, want_t, lim_t
    if not time_it:
        return
    # the library's backward (never on the path): F.embedding_bag with
    # per_sample_weights, differentiated in the table or in the weights
    flat = ids.reshape(-1)
    offsets = torch.arange(0, E, L, device=ids.device, dtype=torch.int32)
    tab = table.detach().requires_grad_(True)
    wq = w.reshape(-1).detach().requires_grad_(True)
    with torch.enable_grad():
        out_t = F.embedding_bag(flat, tab, offsets, mode="sum",
                                per_sample_weights=w.reshape(-1))
        out_w = F.embedding_bag(flat, table, offsets, mode="sum",
                                per_sample_weights=wq)
    lib_t = lambda: torch.autograd.grad(  # noqa: E731
        out_t, tab, g, retain_graph=True)[0]
    lib_w = lambda: torch.autograd.grad(  # noqa: E731
        out_w, wq, g, retain_graph=True)[0]
    _, r_lib_t = err_ratio(lib_t(), d_t.double(), LIBRARY_RTOL)
    _, r_lib_w = err_ratio(lib_w().reshape(B, L), d_w.double(),
                           LIBRARY_RTOL)
    print(f"  embedding_bag_grad {label}: F.embedding_bag's backward against"
          f" the kernels: err/limit dT {r_lib_t:.4f}, dw {r_lib_w:.4f} "
          f"(rtol {LIBRARY_RTOL})")
    check(r_lib_t <= 1.0 and r_lib_w <= 1.0, f"embedding_bag_grad {label}: "
          f"F.embedding_bag's backward is not the same function")
    idx = flat.long()
    add = lambda: torch.zeros((V, d), device=table.device).index_add_(  # noqa
        0, idx, terms)
    names = torch.unique(flat).numel()
    bound_t = (V * d + 2 * E + V + 1 + E + B * d) * 4 / HBM_BYTES_PER_S * 1e3
    bound_w = (2 * E + names * d + B * d) * 4 / HBM_BYTES_PER_S * 1e3
    flops_ms = 2.0 * E * d / F32_FLOPS_PER_S * 1e3
    rows = {}
    for name, fn, plain, lib, bound in (
            ("embedding_bag_grad_table", lambda: kern(weights_grad=False),
             lambda: ref.embedding_bag_grad_ref(table, ids, w, g,
                                                weights_grad=False),
             lib_t, bound_t),
            ("embedding_bag_grad_weights", lambda: kern(table_grad=False),
             lambda: ref.embedding_bag_grad_ref(table, ids, w, g,
                                                table_grad=False),
             lib_w, bound_w)):
        ms = queued_ms(fn, BAG_GRAD_REPS)
        plain_ms = events_ms(plain, 3)
        lib_ms = queued_ms(lib, BAG_GRAD_REPS)
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(bound, flops_ms),
                      "bound_by": "bytes" if bound >= flops_ms
                      else "operations", "library_ms": lib_ms}
        extra = ""
        if name == "embedding_bag_grad_table":
            # and the dense gradient's write alone: one fill of (V, d) zeros
            fill = lambda: torch.zeros((V, d), device=table.device)  # noqa
            extra = (f"  index_add_ of the products (formed beforehand) "
                     f"{queued_ms(add, BAG_GRAD_REPS) * 1e3:10.2f} us  write "
                     f"floor (a (V, d) fill of zeros) "
                     f"{queued_ms(fill, BAG_GRAD_REPS) * 1e3:10.2f} us")
        print(f"  {name} {label}: kernel {ms * 1e3:10.2f} us (device, queued "
              f"events)  bound {max(bound, flops_ms) * 1e3:9.2f} us "
              f"({rows[name]['bound_by']})  plain {plain_ms * 1e3:10.2f} us  "
              f"F.embedding_bag backward {lib_ms * 1e3:10.2f} us{extra}  "
              f"[{card}]")
    del out_t, out_w, terms, tab, wq
    stats["timed"] = rows


def din_train_steps(arch, params, batches, dev, card: str) -> dict:
    """DIN_TRAIN_STEPS train steps at full width, one batch each: losses,
    ms a step by CUDA events, peak memory and the launches a step."""
    import torch

    from repro_torch.kernels import embedding_bag, segment_reduce
    from repro_torch.optim import adamw_init

    step = arch.build_step("train_batch")
    state = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    embedding_bag.reset_launches()
    segment_reduce.reset_launches()
    losses, times = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, loss = step(params, state, batch)
        stop.record()
        losses.append(loss)
        times.append((start, stop))
    torch.cuda.synchronize()
    launches = {**{k: embedding_bag.LAUNCHES[k] for k in
                   ("embedding_bag", "embedding_bag_grad_table",
                    "embedding_bag_grad_weights")},
                **{k: segment_reduce.LAUNCHES[k] for k in
                   ("segment_reduce", "segment_reduce_grad")}}
    peak = torch.cuda.max_memory_allocated(dev)
    ms = [a.elapsed_time(b) for a, b in times]
    return {"losses": [float(x) for x in losses], "ms": ms,
            "launches": launches, "peak": peak, "held": held,
            "params": params, "state": state}


def phase16_din_train(dev, gen, card: str) -> tuple[list[dict], int, int]:
    """DIN training on the card at train_batch (B 65,536, L 100, the 10M x
    18 and 100k x 18 tables, float32): K5's backward against float64 plain
    at the path's shapes on the Zipf batch and on uniform ids, the other
    kernels of the path (K5's forward, segment_reduce) at theirs, two steps
    from one start with the same bits and no float scatter,
    DIN_TRAIN_STEPS steps timed with the device split, and
    ``launch/train --arch din`` on the card. Returns the backward's two
    rows of the ``kernels`` line and the launches of K5's forward and of
    segment_reduce in the timed steps."""
    import shutil

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import Prefetcher, RecsysStream
    from repro_torch.kernels import embedding_bag, ops, ref
    from repro_torch.launch import train
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw_init

    print(f"phase 16: DIN training (train_batch, K5's backward), card {card}")
    t_phase = time.perf_counter()
    arch = get_arch("din")
    cfg = arch.cfg
    B = arch.shapes["train_batch"]["batch"]
    L = cfg.seq_len
    t0 = time.perf_counter()
    params = arch.init_params(gen, dev)
    # batch 0 from the cell's entry point; the stream's later batches are
    # built on the pipeline's thread while the checks run
    stream = iter(RecsysStream(n_items=cfg.n_items, n_cats=cfg.n_cats,
                               seq_len=L, batch=B, seed=DIN_TRAIN_SEED))
    next(stream)
    later = Prefetcher(stream, depth=DIN_TRAIN_STEPS - 1)
    batches = [arch.make_inputs("train_batch", gen, dev, seed=DIN_TRAIN_SEED)]
    ids0 = batches[0]["hist_items"]
    hot = torch.bincount(ids0.reshape(-1).long(), minlength=cfg.n_items)
    print(f"  init and the first RecsysStream batch (seed {DIN_TRAIN_SEED}) "
          f"in {time.perf_counter() - t0:.2f}s: {int((hot > 0).sum())} "
          f"distinct items in {B * L} history positions, the hottest "
          f"{int(hot.max())} ({float(hot.max()) / (B * L):.4f})")
    del hot

    # the path's kernel calls, recorded from one step and checked
    step = arch.build_step("train_batch")
    start = [p.detach().clone() for p in tree_leaves(params)]
    recorder = float_scatter_recorder()
    with recorded_din_calls() as seen, recorder:
        params, state, loss = step(params, adamw_init(params), batches[0])
        torch.cuda.synchronize()
    first = [p.detach().clone() for p in tree_leaves(params)]
    with torch.no_grad():
        for p, s in zip(tree_leaves(params), start):
            p.copy_(s)
    params, again, loss2 = step(params, adamw_init(params), batches[0])
    same = bool(torch.equal(loss, loss2)) and all(
        torch.equal(a, b) for a, b in zip(first, tree_leaves(params))) and \
        all(torch.equal(a, b) for a, b in zip(state.m + state.v,
                                              again.m + again.v))
    moved = sum(int((a != b).sum()) for a, b in zip(first, start))
    print(f"  one step from the start: loss {float(loss):.6f}, {moved} of "
          f"{sum(p.numel() for p in start)} parameters moved; a second step "
          f"from the same start gives the same bits: {same}; float scatters "
          f"{sorted(set(recorder.seen))}; calls recorded: forward "
          f"{len(seen['forward'])}, backward {len(seen['backward'])}, "
          f"segment_reduce {len(seen['segment'])}")
    check(same, "DIN: a second train step from the same start gave other "
          "bits")
    check(not recorder.seen, f"DIN: float scatters ran in the train step: "
          f"{sorted(set(recorder.seen))}")
    check(moved > 0 and bool(torch.isfinite(loss)), "DIN: the step moved "
          "nothing or its loss is not finite")
    want = din_train_launches()
    check((len(seen["forward"]), len(seen["backward"]),
           len(seen["segment"])) == (want["embedding_bag"],
                                     want["embedding_bag_grad_table"],
                                     want["segment_reduce"]),
          "DIN: the step's kernel calls are not its structure's")
    del first, start, again, state, loss, loss2

    stats = {"table_err": 0.0, "weights_err": 0.0}
    torch.set_grad_enabled(False)
    # K5's forward at the train shape (the item and category bags)
    for table, ids, w in seen["forward"]:
        what = "items" if table.shape[0] == cfg.n_items else "cats"
        table, w = table.detach(), w.detach()
        out = embedding_bag.embedding_bag_cuda(table, ids, w)
        want = ref.embedding_bag_ref(table.double(), ids, w.double())
        limit = L * 2.0**-24 * ref.embedding_bag_ref(
            table.double().abs(), ids, w.double().abs())
        r = over_limit(out, want, limit)
        print(f"  embedding_bag train_batch {what}: B={ids.shape[0]} "
              f"L={ids.shape[1]} route {embedding_bag.route(ids.stride(0))} "
              f"err/limit={r:.4f} {'ok' if r <= 1 else 'FAIL'} (L 2^-24 "
              f"sum|w||row|)")
        check(r <= 1.0, f"embedding_bag at the train shape ({what}): error "
              f"above its limit")
        del out, want, limit
    # the backward: item table (timed) and category table, Zipf ids; then
    # the item table on uniform ids with the same weights and g
    rows = None
    for args, _ in sorted(seen["backward"], key=lambda c: -c[0][0].shape[0]):
        table, ids, w, g, order, keys, offsets = args
        what = "item table" if table.shape[0] == cfg.n_items else \
            "category table"
        table, w, g = table.detach(), w.detach(), g.detach()
        plan = ops.SegmentPlan(order, keys, offsets)
        bag_grad_check(f"{what}, Zipf ids", table, ids, w, g, plan, card,
                       stats, time_it=what == "item table")
        if what == "item table":
            rows = stats.pop("timed")
            uni = torch.randint(0, cfg.n_items, ids.shape, generator=gen,
                                device=gen.device,
                                dtype=torch.int32).to(dev)
            uplan = ops.bag_plan(uni, cfg.n_items)
            bag_grad_check(f"{what}, uniform ids", table, uni, w, g, uplan,
                           card, stats, time_it=False)
            del uni, uplan
    # segment_reduce at the path's shape: the history items' gather
    # backward (E = B L rows of 18 into 10M segments)
    values, order, keys, offsets, op = next(
        c for c in seen["segment"] if c[0].shape[0] == B * L
        and c[3].shape[0] == cfg.n_items + 1)
    segment_check("DIN item-table gather backward", values,
                  ops.SegmentPlan(order, keys, offsets), op, card,
                  {"max_abs_err": 0.0, "timed": []}, time_it=True)
    del seen, values, order, keys, offsets
    torch.set_grad_enabled(True)
    torch.cuda.empty_cache()

    # the timed steps
    t0 = time.perf_counter()
    batches += [{k: torch.from_numpy(v).to(dev) for k, v in next(later).items()}
                for _ in range(DIN_TRAIN_STEPS - 1)]
    later.close()
    print(f"  the stream's next {DIN_TRAIN_STEPS - 1} batches, built during "
          f"the checks, taken in {time.perf_counter() - t0:.2f}s")
    run = din_train_steps(arch, params, batches, dev, card)
    params = run["params"]
    flops, nbytes = arch.model_flops("train_batch"), \
        arch.model_bytes("train_batch")
    least = max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    steady = run["ms"][1:]
    mean_ms = sum(steady) / len(steady)
    per_step = {k: v / DIN_TRAIN_STEPS for k, v in run["launches"].items()}
    print(f"  {DIN_TRAIN_STEPS} train steps: losses "
          f"{[round(x, 6) for x in run['losses']]}; ms a step "
          f"{[round(x, 3) for x in run['ms']]} (mean of steps 2-"
          f"{DIN_TRAIN_STEPS} {mean_ms:.3f} ms); least {least:.3f} ms "
          f"({flops:.4e} flops at 67 TFLOP/s float32, {nbytes:.4e} bytes "
          f"at 3.35 TB/s; {least / mean_ms:.4f} of it); peak "
          f"{run['peak'] / 1e9:.2f} GB ({(run['peak'] - run['held']) / 1e9:.2f}"
          f" GB above the {run['held'] / 1e9:.2f} GB held before); launches "
          f"a step {per_step}  [{card}]")
    check(all(math.isfinite(x) for x in run["losses"]), "DIN: a non-finite "
          "loss")
    check(per_step == {k: float(v) for k, v in din_train_launches().items()},
          f"DIN: launches a step {per_step}, not {din_train_launches()}")
    batch = batches[-1]
    state = run["state"]
    del run
    din_profile("DIN train_batch step",
                lambda: arch.build_step("train_batch")(params, state, batch))
    launches = {k: per_step[k] * DIN_TRAIN_STEPS for k in per_step}
    del params, state, batches, batch
    torch.cuda.empty_cache()

    # the training entry point on the card: its main() as ``python -m
    # repro_torch.launch.train`` calls it (the loss check is its own)
    ckpt = ROOT / "build" / "phase16_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        summary = train.main([*DIN_CLI, "--ckpt-dir", str(ckpt), "--device",
                              "cuda"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"  launch/train {' '.join(DIN_CLI)}: {time.perf_counter() - t0:.1f}"
          f"s; mean loss of the first 10 steps {summary['first10']:.6f}, of "
          f"the last 10 {summary['last10']:.6f}; rescales "
          f"{summary['rescales']}, restored from {summary['restored_from']}")
    check(summary["last10"] < summary["first10"] and summary["rescales"] == 1,
          "launch/train --arch din: the loss did not improve or the failure "
          "was not injected")
    print(f"  phase 16 wall {time.perf_counter() - t_phase:.1f}s")
    out = []
    for name in ("embedding_bag_grad_table", "embedding_bag_grad_weights"):
        err = stats["table_err" if name.endswith("table") else "weights_err"]
        out.append({"name": name, "launches": int(launches[name]),
                    "max_abs_err": err, **rows[name]})
    return out, int(launches["embedding_bag"]), int(launches["segment_reduce"])


def main() -> int:
    # the port must not need JAX or the JAX package
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {ROOT / 'src'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.index import WalkIndex, walk_rows
    from repro_torch.kernels import (_build, ell_spmv, embedding_bag,
                                     endpoint_fold, ref, segment_reduce,
                                     walk_gather)
    from repro_torch.ppr import (ForaExecutor, ForaParams, LaneStreams,
                                 PprWorkload, forward_push, fora_fused, load,
                                 ppr_power_iteration, sample_walk_starts,
                                 small_test_graph)
    from repro_torch.ppr.forward_push import one_hot_seeds
    from repro_torch.ppr.graph import Graph, _resolve_push_layout
    from repro_torch.ppr.power_iteration import (default_iters,
                                                 power_iteration_coo)
    from repro_torch.ppr.random_walk import lane_weights, walk_length_for_tail
    from repro_torch import quickstart

    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    floors_build, floors_lib = start_floors_build()
    seg_build, seg_floors_lib = start_floors_build(SEGMENT_FLOORS_SRC)
    try:
        libs = _build.build()
    finally:
        floors_log, _ = floors_build.communicate()
        seg_log, _ = seg_build.communicate()
    check(floors_build.returncode == 0,
          f"nvcc failed for {FLOORS_SRC.name}:\n{floors_log}")
    check(seg_build.returncode == 0,
          f"nvcc failed for {SEGMENT_FLOORS_SRC.name}:\n{seg_log}")
    global SEGMENT_FLOORS_LIB
    SEGMENT_FLOORS_LIB = seg_floors_lib
    print(f"build: {sorted(libs)}, {FLOORS_SRC.name} and "
          f"{SEGMENT_FLOORS_SRC.name} in {time.perf_counter() - t0:.1f}s")
    for name in libs:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    # phases 1-5's kernels; phases 6 and 7 keep their own
    stats = {k: {"max_abs_err": 0.0, "ratio": 0.0}
             for k in ("ell_spmm", "ell_spmm_sliced", "walk_endpoint_gather",
                       "ell_spmv")}
    small = small_test_graph(n=2000)
    web = load("web-stanford", scale=1)
    print(f"graphs: {small.summary()} | {web.summary()} "
          f"max_in_degree={web.max_in_degree}")
    # phase 8's graph, built once: phases 1 and 5 hold K4 on its table
    t0 = time.perf_counter()
    pokec = small_test_graph(n=POKEC_N, avg_deg=POKEC_M / POKEC_N, seed=0)
    pokec_graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pokec_dg = pokec.device(dev)
    torch.cuda.synchronize()
    pokec_table_s = time.perf_counter() - t0
    pokec_t = (pokec_dg.in_neighbors, pokec_dg.in_mask, pokec_dg.in_weights)
    print(f"  pokec-order graph: n={pokec.n} m={pokec.m} max_in_degree="
          f"{pokec.max_in_degree}, layout {pokec_dg.layout}, push table "
          f"{tuple(pokec_t[0].shape)} {pokec_dg.ell_nbytes} bytes; host "
          f"build {pokec_graph_s:.2f}s graph + {pokec_table_s:.2f}s table "
          f"and upload")
    check(pokec.n == POKEC_N and pokec_dg.layout == "dense",
          "the Pokec-order graph must take the dense table")
    # the batch widths the paths launch each kernel with: K1 at the dense
    # path's sources, K2 at the executor's block and the FORA check's batch
    path_B = {"ell_spmm": {len(DENSE_SOURCES)},
              "ell_spmm_sliced": {ForaExecutor.block_size, CHECK_SOURCES}}

    def thr_of(graph, params=ForaParams(epsilon=0.5)):
        return torch.from_numpy(
            (params.resolve(graph).rmax
             * np.maximum(graph.out_degree, 1)).astype(np.float32)).to(dev)

    def table(graph, layout):
        lay = _resolve_push_layout(graph, layout)
        t = [torch.from_numpy(a).to(dev) for a in
             (lay.neighbors, lay.mask, lay.weights)]
        rm = None if lay.row_map is None else \
            torch.from_numpy(lay.row_map).to(dev)
        return t, rm, thr_of(graph)

    def sliced(graph, width, pad_multiple=8):
        sl = graph.ell_in_sliced(width=width, pad_multiple=pad_multiple)
        t = [torch.from_numpy(a).to(dev) for a in
             (sl.neighbors, sl.mask, sl.weights)]
        return t, torch.from_numpy(sl.row_map).to(dev), thr_of(graph)

    def plain(nbr, msk, w, rm, x, thr):
        """The kernel's plain version, or None for rm on a dense table."""
        if rm is None:
            return ref.ell_spmm_ref(nbr, msk, x, w, thr)
        return ref.ell_spmm_sliced_ref(nbr, msk, x, w, thr, rm)

    dense_t, _, dense_thr = table(small, "auto")
    check(dense_t[0].shape[0] == small.n, "small_test_graph must be dense")
    web_t, web_rm, web_thr = table(web, "auto")
    check(web_rm is not None, "web-stanford must take the sliced table")
    print(f"tables: dense {tuple(dense_t[0].shape)}, web-stanford sliced "
          f"{tuple(web_t[0].shape)} ({web_t[0].numel() * 9 / 2**20:.1f} MiB)")

    def compare(name, kernel, tables, rm, x, thr, label):
        """Hold one kernel launch against the float64 plain version."""
        nbr, msk, w = tables
        torch.cuda.synchronize()
        out = kernel()
        torch.cuda.synchronize()
        want = plain(nbr, msk, *f64(w), rm, *f64(x, thr))
        check(out.shape == want.shape, f"{name} {label}: shape "
              f"{tuple(out.shape)} != {tuple(want.shape)}")
        check(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite")
        err, ratio = err_ratio(out, want, RTOL)
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["ratio"] = max(st["ratio"], ratio)
        check(bool(torch.equal(out, kernel())),
              f"{name} {label}: a second launch gave other bits")
        ok = ratio <= 1.0
        print(f"  {name:16s} {label:34s} max_abs_err={err:.3e} "
              f"max|want|={float(want.abs().max()):.3e} "
              f"err/limit={ratio:.4f} {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label}: error {err} above rtol {RTOL} "
              f"+ {ATOL_FRAC} * max|want| (ratio {ratio})")

    def must_refuse(name, tables, rm, broken_mask, zero_rows, label):
        """The tolerance must be tight enough to see a broken kernel: the
        plain version with ``broken_mask`` for the table's mask, or with
        the real rows ``zero_rows`` zeroed, must fail the check."""
        nbr, msk, w = tables
        x = mass_rows(gen, 1, int(zero_rows.shape[0]), dev)
        want = plain(nbr, msk, w.double(), rm, x.double(), None)
        broken = plain(nbr, broken_mask, w, rm, x, None)
        broken = broken.masked_fill(zero_rows[None], 0.0)
        _, ratio = err_ratio(broken, want, RTOL)
        print(f"  {name:16s} {'broken: ' + label:34s} err/limit="
              f"{ratio:.4g} {'refused' if ratio > 1 else 'PASSED'}")
        check(ratio > 1.0, f"{name}: the check passes a broken kernel "
              f"({label})")

    print("phase 1: kernels against their plain versions on the card "
          f"(rtol {RTOL}, atol {ATOL_FRAC} * max|want|, float64 plain)")
    # K1's and K4's row plans, built once a table as DeviceGraph builds them
    dense_plan = ell_spmv.dense_plan(dense_t[1])
    pokec_plan = pokec_dg.in_plan
    print(f"  row plans: dense path {dense_plan.lanes} lanes a row, pokec "
          f"{pokec_plan.lanes} (mean extent "
          f"{float(pokec_plan.extent.double().mean()):.3f}, max "
          f"{int(pokec_plan.extent.max())}); K1's frontier route at B = 1 "
          f"from n = {ell_spmv.FRONTIER_MIN_N}: "
          f"{ell_spmv.frontier_group(small.n, 1)} node(s) a bit (dense "
          f"path; 0 the plain route), "
          f"{ell_spmv.frontier_group(pokec.n, 1)} (pokec)")
    check(bool(torch.equal(pokec_plan.extent.long(), pokec_t[1].sum(dim=1))),
          "pokec: a row's extent is not its live count")
    for B in sorted(path_B["ell_spmm"] | {1, 8, 33, 64}):
        for fused in (False, True):
            x = mass_rows(gen, B, small.n, dev)
            thr = dense_thr if fused else None
            compare("ell_spmm",
                    lambda: ell_spmv.ell_spmm_cuda(*dense_t, x, thr,
                                                   dense_plan),
                    dense_t, None, x, thr, f"small n=2000 B={B} thr={fused}")
    # a kernel that loses one neighbour of every row
    no_rows = torch.zeros(small.n, dtype=torch.bool, device=dev)
    short = dense_t[1].clone()
    short[:, 0] = False
    must_refuse("ell_spmm", dense_t, None, short, no_rows,
                "first cell of each row dropped")
    # K1 at the shapes phase 8 gives it: the Pokec-order table at the
    # executor's block (the frontier route) and the FORA check's batch,
    # phase 8's threshold
    pokec_thr = thr_of(pokec, ForaParams(epsilon=0.5,
                                         rmax_scale=POKEC_RMAX_SCALE))
    for B in sorted({ForaExecutor.block_size, POKEC_SOURCES}):
        for fused in (False, True):
            x = mass_rows(gen, B, pokec.n, dev)
            thr = pokec_thr if fused else None
            compare("ell_spmm",
                    lambda: ell_spmv.ell_spmm_cuda(*pokec_t, x, thr,
                                                   pokec_plan),
                    pokec_t, None, x, thr, f"pokec B={B} thr={fused}")
    # and on real push residuals, where the frontier bitmap skips sources
    pokec_src = int(PprWorkload(pokec, POKEC_QUERIES, seed=0).sources[0])
    pokec_rmax = ForaParams(epsilon=0.5, rmax_scale=POKEC_RMAX_SCALE) \
        .resolve(pokec).rmax
    residuals = push_residuals(pokec_t, pokec_dg.out_degree, pokec_plan,
                               pokec_src, pokec_rmax, RESIDUAL_SWEEPS)
    for sweeps, x in residuals.items():
        share = float((x[0] > pokec_thr).double().mean())
        compare("ell_spmm",
                lambda: ell_spmv.ell_spmm_cuda(*pokec_t, x, pokec_thr,
                                               pokec_plan),
                pokec_t, None, x, pokec_thr,
                f"pokec residual sweep {sweeps} ({share:.3f})")
    short = pokec_t[1].clone()
    short[:, 0] = False
    must_refuse("ell_spmm", pokec_t, None, short,
                torch.zeros(pokec.n, dtype=torch.bool, device=dev),
                "pokec: first cell of each row dropped")
    del short
    # broken versions of the row plan and of the threshold pass: every
    # row's extent one short, the threshold read at the row, not the
    # source, and (the frontier route) a bitmap that drops one word
    x = mass_rows(gen, 1, pokec.n, dev)
    want = ref.ell_spmm_ref(pokec_t[0], pokec_t[1], x.double(),
                            pokec_t[2].double(), pokec_thr.double())
    group = ell_spmv.frontier_group(pokec.n, 1)
    word = int(torch.nonzero(x[0] > pokec_thr)[0]) // (32 * group)
    dropped = x.clone()
    dropped[0, word * 32 * group:(word + 1) * 32 * group] = 0.0
    for label, broken in (
            ("extent one short", ref.ell_spmm_ref(
                pokec_t[0], extent_cut(pokec_t[1], pokec_plan.extent - 1),
                x, pokec_t[2], pokec_thr)),
            ("threshold at the row", row_threshold(
                pokec_t[0], pokec_t[1], x, pokec_t[2], pokec_thr)),
            (f"bitmap word {word} dropped", ref.ell_spmm_ref(
                *pokec_t[:2], dropped, pokec_t[2], pokec_thr))):
        _, ratio = err_ratio(broken, want, RTOL)
        print(f"  {'ell_spmm':16s} {'broken: ' + label:34s} err/limit="
              f"{ratio:.4g} {'refused' if ratio > 1 else 'PASSED'}")
        check(ratio > 1.0, f"ell_spmm: the check passes a broken kernel "
              f"({label})")
    del dropped, want
    # K1 and K4 on tables that are not left-packed (the plan's extents,
    # random masks, a row whose only live cell is its last column, rows
    # with none), at every K of the sweep, n not a multiple of the rows a
    # warp takes; and a table past 2^19 nodes (two nodes a bitmap bit)
    edge_tables = {K_e: edge_table(gen, EDGE_N, K_e, dev) for K_e in EDGE_KS}
    for K_e, (nbr_e, msk_e, w_e) in edge_tables.items():
        plan_e = ell_spmv.dense_plan(msk_e)
        thr_e = torch.full((EDGE_N,), 0.5 / EDGE_N, device=dev)
        for B in EDGE_BS:
            for fused in (False, True):
                x = mass_rows(gen, B, EDGE_N, dev)
                thr = thr_e if fused else None
                compare("ell_spmm",
                        lambda: ell_spmv.ell_spmm_cuda(nbr_e, msk_e, w_e, x,
                                                       thr, plan_e),
                        (nbr_e, msk_e, w_e), None, x, thr,
                        f"edge K={K_e} B={B} thr={fused}")
        # the frontier route, which the rule gives only larger tables
        x = mass_rows(gen, 1, EDGE_N, dev)
        compare("ell_spmm",
                lambda: k1_on_route((nbr_e, msk_e, w_e), plan_e, x, thr_e,
                                    ell_spmv.bitmap_group(EDGE_N)).t(),
                (nbr_e, msk_e, w_e), None, x, thr_e,
                f"edge K={K_e} B=1 thr=True frontier")
    half = small_test_graph(n=HALF_N, avg_deg=6, seed=2)
    half_dg = half.device(dev)
    half_t = (half_dg.in_neighbors, half_dg.in_mask, half_dg.in_weights)
    half_thr = thr_of(half)
    x = mass_rows(gen, 1, half.n, dev)
    compare("ell_spmm",
            lambda: ell_spmv.ell_spmm_cuda(*half_t, x, half_thr,
                                           half_dg.in_plan),
            half_t, None, x, half_thr,
            f"n={half.n} B=1 thr ({ell_spmv.frontier_group(half.n, 1)} "
            f"nodes a bit)")
    del half, half_dg, half_t, half_thr
    # K2's fold structure, built once for the table as DeviceGraph builds it
    web_fold = ell_spmv.sliced_fold(web_rm, web.n, web_t[0].shape[1])
    item_rows = web_fold.items.numel() - web_fold.hub_items
    hubs = web_fold.hubs.numel()
    print(f"  K2 fold of the web-stanford table: {web.n - item_rows - hubs}"
          f" short rows (<= {web_fold.short_slices} slices), {item_rows} "
          f"warp-item rows, {hubs} hubs in {web_fold.hub_items} chunks of "
          f"{web_fold.chunk_slices} slices")
    for B in sorted(path_B["ell_spmm_sliced"] | {1, 8, 64}):
        for fused in (False, True):
            x = mass_rows(gen, B, web.n, dev)
            thr = web_thr if fused else None
            compare("ell_spmm_sliced",
                    lambda: ell_spmv.ell_spmm_sliced_cuda(*web_t, web_rm, x,
                                                          thr, web_fold),
                    web_t, web_rm, x, thr, f"web-stanford B={B} thr={fused}")
    # folds that lose part of a row: the last slice of every row that has
    # more than one, or every row with fewer than 256 in-edges; and one
    # broken version a path of the fold: the short rows' in-warp fold
    # losing each slice's second half (its second lane), a warp-item row
    # losing its last slice, a hub losing its last slice or its last chunk
    last = torch.ones_like(web_rm, dtype=torch.bool)
    last[:-1] = web_rm[1:] != web_rm[:-1]
    multi = torch.zeros_like(last)
    multi[1:] = web_rm[1:] == web_rm[:-1]
    no_rows = torch.zeros(web.n, dtype=torch.bool, device=dev)
    must_refuse("ell_spmm_sliced", web_t, web_rm,
                web_t[1] & ~(last & multi)[:, None], no_rows,
                "last slice of multi-slice rows")
    must_refuse("ell_spmm_sliced", web_t, web_rm, web_t[1],
                torch.from_numpy(web.in_degree < 256).to(dev),
                "rows of in-degree < 256 zeroed")
    for label, broken in fold_breaks(web_t[1], web_rm, web_fold):
        must_refuse("ell_spmm_sliced", web_t, web_rm, broken, no_rows,
                    label)
    # sliced edge cases: rows without a virtual row, W = 1, a single
    # virtual row, and padding rows (row_map == n) that must be dropped
    hub = small_test_graph(n=300, avg_deg=3.0, seed=3)
    cases = [("small W=8 (deg-0 rows)", sliced(small, 8)),
             ("W=1", sliced(hub, 1, 1))]
    one = Graph.from_edges(5, np.array([0, 1, 2, 3]), np.array([4, 4, 4, 4]))
    cases.append(("single virtual row", sliced(one, 8)))
    (nbr_s, msk_s, w_s), rm_s, thr_s = sliced(small, 8)
    pad, width = 37, nbr_s.shape[1]
    nbr_p = torch.cat([nbr_s, torch.randint(
        0, small.n, (pad, width), generator=gen, device=dev,
        dtype=torch.int32)])
    msk_p = torch.cat([msk_s, torch.ones((pad, width), dtype=torch.bool,
                                         device=dev)])
    w_p = torch.cat([w_s, torch.ones((pad, width), device=dev)])
    rm_p = torch.cat([rm_s, torch.full((pad,), small.n, dtype=torch.int32,
                                       device=dev)])
    cases.append(("padding rows row_map=n", ((nbr_p, msk_p, w_p), rm_p,
                                             thr_s)))
    for label, ((nbr, msk, w), rm, thr) in cases:
        n = int(thr.shape[0])
        for B in (1, 3):
            x = mass_rows(gen, B, n, dev)
            compare("ell_spmm_sliced",
                    lambda: ell_spmv.ell_spmm_sliced_cuda(nbr, msk, w, rm, x,
                                                          thr),
                    (nbr, msk, w), rm, x, thr, f"{label} B={B}")
    # a padding row must not leak into the real rows
    x = mass_rows(gen, 1, small.n, dev)
    y_pad = ell_spmv.ell_spmm_sliced_cuda(nbr_p, msk_p, w_p, rm_p, x)
    y_ref = ell_spmv.ell_spmm_sliced_cuda(nbr_s, msk_s, w_s, rm_s, x)
    check(bool(torch.equal(y_pad, y_ref)), "padding rows changed output")

    # K3 on endpoint tables of both index paths' shapes
    def gather_check(label, args, extra_bad=()):
        """Hold one K3 launch against the float64 plain version, repeat it
        bitwise, and require the limit to refuse each (name, weights)
        broken version in ``extra_bad``."""
        etab, budget, starts, weights = args
        st = stats["walk_endpoint_gather"]
        torch.cuda.synchronize()
        out = walk_gather.walk_endpoint_gather_cuda(*args)
        torch.cuda.synchronize()
        want = ref.walk_endpoint_gather_ref(etab, budget, starts,
                                            weights.double())
        check(out.shape == want.shape and bool(torch.isfinite(out).all()),
              f"walk_endpoint_gather {label}: bad output")
        err, ratio = err_ratio(out, want, RTOL)
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["ratio"] = max(st["ratio"], ratio)
        check(bool(torch.equal(out, walk_gather.walk_endpoint_gather_cuda(
            *args))), f"walk_endpoint_gather {label}: a second launch gave "
              "other bits")
        print(f"  walk_endpoint_gather {label:40s} max_abs_err={err:.3e} "
              f"max|want|={float(want.abs().max()):.3e} err/limit="
              f"{ratio:.4f} {'ok' if ratio <= 1 else 'FAIL'}")
        check(ratio <= 1.0, f"walk_endpoint_gather {label}: error {err} "
              f"above the limit (ratio {ratio})")
        for bad, (bt, bb, bs, bw) in extra_bad:
            broken = ref.walk_endpoint_gather_ref(bt, bb, bs, bw)
            _, r = err_ratio(broken, want, RTOL)
            print(f"  walk_endpoint_gather {'broken: ' + bad:40s} "
                  f"err/limit={r:.4g} {'refused' if r > 1 else 'PASSED'}")
            check(r > 1.0, f"walk_endpoint_gather: the check passes a "
                  f"broken gather ({bad})")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for pname, (n_k, W_k) in (("dense", (small.n, DENSE_INDEX_WIDTH)),
                              ("paper", (web.n, PAPER_INDEX_WIDTH))):
        etab = torch.randint(0, n_k, (n_k, W_k), generator=gen, device=dev,
                              dtype=torch.int32)
        full = torch.full((n_k,), W_k, dtype=torch.int32, device=dev)
        retired = full.clone()
        rows = torch.randperm(n_k, generator=gen, device=dev)[:n_k // 3]
        retired[rows] = torch.randint(0, W_k + 1, (rows.numel(),),
                                      generator=gen, device=dev,
                                      dtype=torch.int32)
        Ls = {1, 130, 4096} | ({W_k} if pname == "dense" else set())
        for B in (1, 3, 8):
            for L in sorted(Ls):
                starts = torch.randint(0, n_k, (B, L), generator=gen,
                                       device=dev, dtype=torch.int32)
                w = torch.rand((B, L), generator=gen, device=dev)
                for bname, bud in (("full", full), ("retired", retired)):
                    bad = ()
                    if bname == "retired" and B in (1, 8) and L >= 4096:
                        cells, _ = walk_gather.fold_plan(n_k, B, sms)
                        bad = (("budget ignored", (etab, full, starts, w)),
                               ("last lane of each cell dropped",
                                (etab, bud, starts, drop_last_lane(
                                    etab, bud, starts, w))),
                               (f"last lane of each {cells}-cell range "
                                f"dropped", (etab, bud, starts,
                                             drop_last_of_range(
                                                 etab, bud, starts, w,
                                                 cells))))
                    gather_check(f"{pname} n={n_k} W={W_k} B={B} L={L} "
                                 f"{bname}", (etab, bud, starts, w), bad)
        # the hub: every lane of every row ends at one node
        etab.fill_(n_k // 2)
        for L in sorted(Ls - {1, 130}):
            starts = torch.randint(0, n_k, (1, L), generator=gen, device=dev,
                                   dtype=torch.int32)
            w = torch.rand((1, L), generator=gen, device=dev)
            gather_check(f"{pname} hub W={W_k} B=1 L={L}",
                         (etab, full, starts, w))
        del etab
    # K4 over the sweep's shapes and the dense tables of phases 2 and 8
    def spmv_check(label, tables, x, broken=()):
        """Hold one K4 launch against the float64 plain version, repeat it
        bitwise, and require the limit to refuse each (name, mask) broken
        version in ``broken``."""
        nbr, msk, w = tables
        st = stats["ell_spmv"]
        torch.cuda.synchronize()
        out = ell_spmv.ell_spmv_cuda(nbr, msk, w, x)
        torch.cuda.synchronize()
        want = ref.ell_spmv_ref(nbr, msk, x.double(), w.double())
        check(out.shape == want.shape and bool(torch.isfinite(out).all()),
              f"ell_spmv {label}: bad output")
        err, ratio = err_ratio(out, want, RTOL)
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["ratio"] = max(st["ratio"], ratio)
        check(bool(torch.equal(out, ell_spmv.ell_spmv_cuda(nbr, msk, w, x))),
              f"ell_spmv {label}: a second launch gave other bits")
        print(f"  {'ell_spmv':16s} {label:34s} max_abs_err={err:.3e} "
              f"max|want|={float(want.abs().max()):.3e} "
              f"err/limit={ratio:.4f} {'ok' if ratio <= 1 else 'FAIL'}")
        check(ratio <= 1.0, f"ell_spmv {label}: error {err} above the limit "
              f"(ratio {ratio})")
        for bad, bmask in broken:
            _, r = err_ratio(ref.ell_spmv_ref(nbr, bmask, x.double(),
                                              w.double()), want, RTOL)
            print(f"  {'ell_spmv':16s} {'broken: ' + bad:34s} err/limit="
                  f"{r:.4g} {'refused' if r > 1 else 'PASSED'}")
            check(r > 1.0, f"ell_spmv: the check passes a broken kernel "
                  f"({bad}, {label})")

    for n_s, K_s in SPMV_SWEEP:
        # nonnegative weights, non-zero under a false mask too
        nbr = torch.randint(0, n_s, (n_s, K_s), generator=gen, device=dev,
                            dtype=torch.int32)
        msk = torch.rand((n_s, K_s), generator=gen, device=dev) < 0.7
        msk[0] = False                         # a row with no live cell
        w = torch.rand((n_s, K_s), generator=gen, device=dev)
        x = torch.rand(n_s, generator=gen, device=dev)
        spmv_check(f"sweep n={n_s} K={K_s}", (nbr, msk, w), x,
                   broken=[("mask ignored", torch.ones_like(msk)),
                           ("last cell of each row dropped",
                            drop_last_cell(msk))])
        check(float(ell_spmv.ell_spmv_cuda(nbr, msk, w, x)[0]) == 0.0,
              "ell_spmv: a row with no live cell is not 0")
    for K_e, (nbr_e, msk_e, w_e) in edge_tables.items():
        spmv_check(f"edge K={K_e}", (nbr_e, msk_e, w_e),
                   mass_rows(gen, 1, EDGE_N, dev)[0])
        y_e = ell_spmv.ell_spmv_cuda(nbr_e, msk_e, w_e,
                                     torch.ones(EDGE_N, device=dev))
        check(float(y_e[0]) == 0.0 and float(y_e[EDGE_N - 1]) == 0.0,
              f"ell_spmv edge K={K_e}: a row with no live cell is not 0")
    del edge_tables
    for label, tables, plan in (
            (f"dense path n={small.n} K={dense_t[0].shape[1]}", dense_t,
             dense_plan),
            (f"pokec n={pokec.n} K={pokec_t[0].shape[1]}", pokec_t,
             pokec_plan)):
        spmv_check(label, tables, mass_rows(gen, 1, tables[0].shape[0],
                                            dev)[0],
                   broken=[("last cell of each row dropped",
                            drop_last_cell(tables[1])),
                           ("extent one short",
                            extent_cut(tables[1], plan.extent - 1))])

    # K5 on ids outside [0, V), against the plain version (NaN equal NaN),
    # on route G (as given) and route S (the row as 3 bags' history)
    tab = torch.randn((4, 3), generator=gen, device=dev)
    for ids_l in ([[0, -1]], [[0, 5]]):
        row = torch.tensor(ids_l, dtype=torch.int32, device=dev)
        for way, ids in (("G", row), ("S", row.expand(3, -1))):
            w = torch.rand(ids.shape, generator=gen, device=dev)
            out = embedding_bag.embedding_bag_cuda(tab, ids, w)
            want = ref.embedding_bag_ref(tab.double(), ids, w.double())
            nan_ok = bool(torch.equal(torch.isnan(out), torch.isnan(want)))
            fin = ~torch.isnan(want)
            err = float((out.double() - want)[fin].abs().max()) \
                if bool(fin.any()) else 0.0
            limit = RTOL * float(want[fin].abs().max()) \
                if bool(fin.any()) else 0.0
            print(f"  {'embedding_bag':16s} route {way} ids {str(ids_l):22s}"
                  f" out={out.cpu().numpy().round(6).tolist()} want="
                  f"{want.cpu().numpy().round(6).tolist()} "
                  f"{'ok' if nan_ok and err <= limit else 'FAIL'}")
            check(nan_ok and err <= limit,
                  f"embedding_bag route {way} ids {ids_l}: {out} against "
                  f"{want}")
    for name, st in stats.items():
        print(f"  {name}: max_abs_err {st['max_abs_err']:.3e}, largest "
              f"err/limit {st['ratio']:.4f}")

    # lane streams: the same draws on the card and on the CPU
    lanes = torch.randperm(1 << 20, generator=torch.Generator().manual_seed(
        1))[:1 << 16]
    n_steps = walk_length_for_tail(0.2)
    streams = LaneStreams(5)
    on_card = torch.stack(list(streams.steps(lanes.to(dev), n_steps)))
    on_cpu = torch.stack(list(streams.steps(lanes, n_steps)))
    check(bool(torch.equal(on_card.cpu(), on_cpu)),
          "lane streams differ between the card and the CPU")
    print(f"  lane streams: {tuple(on_cpu.shape)} draws of lanes in "
          f"[0, 2^20) equal on the card and the CPU")

    launches = {}
    print("phase 2: dense path, fora_fused on small_test_graph(n=2000)")
    dg = small.device("cuda")
    check(dg.layout == "dense", f"expected dense, got {dg.layout}")
    srcs = np.array(DENSE_SOURCES)
    ell_spmv.reset_launches()
    exact = ppr_power_iteration(small, srcs, device="cuda")
    oracle_k4 = ell_spmv.LAUNCHES["ell_spmv"]
    print(f"  exact PPR through K4: {oracle_k4} launches (want "
          f"{default_iters()} steps x {len(srcs)} sources)")
    check(oracle_k4 == default_iters() * len(srcs),
          f"the dense path's oracle launched K4 {oracle_k4} times")
    ell_spmv.reset_launches()
    res = fora_fused(dg, srcs, ForaParams(epsilon=0.5), seed=0)
    pi = res.pi.cpu().numpy()
    launches["ell_spmm"] = ell_spmv.LAUNCHES["ell_spmm"]
    mask = exact >= 1.0 / small.n
    rel = float((np.abs(pi - exact)[mask] / exact[mask]).max())
    print(f"  push sweeps={int(res.push_iters)} walk lanes="
          f"{res.walks_budget} max rel err={rel:.4f} "
          f"row sums={np.round(pi.sum(axis=1), 5).tolist()} "
          f"launches={dict(ell_spmv.LAUNCHES)}")
    check(pi.shape == (len(srcs), small.n) and np.isfinite(pi).all(),
          "dense path: bad output")
    check(np.allclose(pi.sum(axis=1), 1.0, atol=1e-3),
          "dense path: rows do not sum to 1")
    check(rel < 0.5, f"dense path: FORA rel err {rel} >= eps")
    check(launches["ell_spmm"] > 0, "dense path never launched K1")

    print("phase 3: paper path, ForaExecutor -> dna_real on the "
          "full-size web-stanford stand-in")
    ell_spmv.reset_launches()
    endpoint_fold.reset_launches()
    t0 = time.perf_counter()
    out = quickstart.run(scale=1, num_queries=256,
                         check_sources=CHECK_SOURCES, device="cuda",
                         log=lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["ell_spmm_sliced"] = ell_spmv.LAUNCHES["ell_spmm_sliced"]
    FOLD_LAUNCHES["phase 3 paper path"] = endpoint_fold.LAUNCHES[
        "endpoint_fold"]
    print(f"  paper path: {json.dumps(out)}")
    print(f"  wall {wall:.1f}s launches={dict(ell_spmv.LAUNCHES)}, "
          f"endpoint fold {FOLD_LAUNCHES['phase 3 paper path']}")
    check(out["graph"]["n"] == 281903, "not the full-size graph")
    check(out["layout"] == "sliced", "paper path must be sliced")
    check(out["accepted"], "dna_real result not accepted")
    check(out["fora_max_rel_err"] < 0.5,
          f"FORA rel err {out['fora_max_rel_err']} >= eps")
    check(launches["ell_spmm_sliced"] > 0, "paper path never launched K2")
    check(FOLD_LAUNCHES["phase 3 paper path"] > 0,
          "paper path never launched the endpoint fold")
    print(f"  exact PPR on the sliced table (COO loop): K4 launches "
          f"{ell_spmv.LAUNCHES['ell_spmv']}")
    check(ell_spmv.LAUNCHES["ell_spmv"] == 0,
          "the sliced table's oracle launched K4")
    # the oracle's steps fold through segment_reduce: the same bits twice
    osrcs = PprWorkload(web, 256, seed=0).sources[:CHECK_SOURCES]
    segment_reduce.reset_launches()
    t0 = time.perf_counter()
    with recorded_segments(last=True) as oracle_step:
        oracle = power_iteration_coo(web, osrcs, 0.2, default_iters(), dev)
        torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    oracle_launches = segment_reduce.LAUNCHES["segment_reduce"]
    again = power_iteration_coo(web, osrcs, 0.2, default_iters(), dev)
    same = bool(torch.equal(oracle, again))
    print(f"  sliced oracle ({CHECK_SOURCES} sources, {default_iters()} "
          f"steps): {oracle_s:.2f}s, segment_reduce launches "
          f"{oracle_launches}; a second run gives the same bits: {same}")
    check(same, "the sliced power iteration gave other bits on a second run")
    check(oracle_launches == default_iters(),
          "the sliced oracle did not fold through segment_reduce each step")
    del oracle, again
    values, plan, op = oracle_step[0]
    segment_check(f"sliced oracle web-stanford last step, {CHECK_SOURCES} "
                  f"sources", values, plan, op, card,
                  {"max_abs_err": 0.0, "timed": []}, time_it=True,
                  floors_lib=SEGMENT_FLOORS_LIB)
    del oracle_step, values, plan
    profile_queries(web, 8)

    print("phase 4: index paths (FORA+), K3 on the walk index")
    params = ForaParams(epsilon=0.5)
    rp = params.resolve(web)

    def rows_match(graph, idx, label):
        """Rows {0, 7, the top in-degree hub, n-1} of ``idx`` rebuilt on
        the CPU on the same lane streams must equal the card's."""
        cpu = graph.device("cpu")
        nodes = torch.tensor(sorted({0, 7, int(np.argmax(graph.in_degree)),
                                     graph.n - 1}))
        rows = walk_rows((cpu.edge_dst, cpu.out_offsets, cpu.out_degree),
                         nodes, idx.streams, idx.width, alpha=idx.alpha,
                         num_steps=idx.num_steps)
        check(bool(torch.equal(rows, idx.endpoints[nodes.to(dev)].cpu())),
              f"{label}: index rows differ between the card and the CPU")
        print(f"  {label}: rows {nodes.tolist()} rebuilt on the CPU equal "
              f"the card's")

    def rel_err(pi, exact, n):
        mask = exact >= 1.0 / n
        return float((np.abs(pi - exact)[mask] / exact[mask]).max())

    # dense path: the executor's index covers its whole walk budget
    walk_gather.reset_launches()
    ell_spmv.reset_launches()
    dex = ForaExecutor(workload=PprWorkload(small, 64, seed=0),
                       params=params, index_budget=DENSE_INDEX_WIDTH,
                       device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dex.warmup()
    torch.cuda.synchronize()
    print(f"  dense: warmup with index build {time.perf_counter() - t0:.2f}s"
          f", index {dex.walk_index.nbytes / 2**20:.1f} MiB, walk budget "
          f"{dex.current_walk_budget()}, coverage {dex.index_coverage}")
    check(dex.index_coverage == 1.0,
          f"dense index covers {dex.index_coverage} of the walk budget")
    dstats = dex(list(range(64)))
    res = fora_fused(dg, srcs, params, num_walks=dex.current_walk_budget(),
                     index=dex.walk_index, device="cuda")
    pi = res.pi.cpu().numpy()
    rel = rel_err(pi, exact, small.n)
    launches["dense_index"] = walk_gather.LAUNCHES["walk_endpoint_gather"]
    push_launches = dict(ell_spmv.LAUNCHES)
    print(f"  dense: 64 queries, per query mean {dstats.t_avg * 1e3:.3f} ms "
          f"max {dstats.t_max * 1e3:.3f} ms; FORA max rel err {rel:.4f}; "
          f"K3 launches {launches['dense_index']}, push {push_launches}")
    check(np.isfinite(pi).all() and np.allclose(pi.sum(axis=1), 1.0,
                                                atol=1e-3),
          "dense index path: bad output")
    check(rel < 0.5, f"dense index path: FORA rel err {rel} >= eps")
    check(launches["dense_index"] > 0, "dense index path never launched K3")
    check(push_launches["ell_spmm"] > 0, "dense index path never launched K1")
    rows_match(small, dex.walk_index, "dense index")
    dense_L = min(dex.walk_index.width, dex.current_walk_budget())

    # the paper graph's index, built once and timed; the paper index path,
    # the profile and the retired-rows run all serve from it
    web_dg = web.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    widx = WalkIndex.build(web_dg, width=PAPER_INDEX_WIDTH, alpha=rp.alpha,
                           walk_tail=rp.walk_tail, seed=0)
    torch.cuda.synchronize()
    print(f"  paper index build: {time.perf_counter() - t0:.2f}s, "
          f"{widx.nbytes / 2**30:.3f} GiB ({widx.nbytes} bytes), width "
          f"{widx.width}, {web.n} x {widx.width} x {widx.num_steps} "
          f"lane-steps")
    rows_match(web, widx, "paper index")

    # paper path: 256 queries through the index into dna_real
    walk_gather.reset_launches()
    ell_spmv.reset_launches()
    t0 = time.perf_counter()
    iout = quickstart.run(scale=1, num_queries=256,
                          check_sources=CHECK_SOURCES, device="cuda",
                          walk_index=widx, log=lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    launches["walk_endpoint_gather"] = \
        walk_gather.LAUNCHES["walk_endpoint_gather"]
    push_launches = dict(ell_spmv.LAUNCHES)
    print(f"  paper index path: {json.dumps(iout)}")
    print(f"  wall {time.perf_counter() - t0:.1f}s, K3 launches "
          f"{launches['walk_endpoint_gather']}, push {push_launches}; "
          f"per query mean/max: index "
          f"{iout['per_query_ms_mean']:.3f}/{iout['per_query_ms_max']:.3f} "
          f"ms, live (phase 3) {out['per_query_ms_mean']:.3f}/"
          f"{out['per_query_ms_max']:.3f} ms")
    check(iout["graph"]["n"] == 281903, "not the full-size graph")
    check(iout["accepted"], "index path: dna_real result not accepted")
    check(iout["fora_max_rel_err"] < 0.5,
          f"index path: FORA rel err {iout['fora_max_rel_err']} >= eps")
    check(launches["walk_endpoint_gather"] > 0,
          "paper index path never launched K3")
    check(push_launches["ell_spmm_sliced"] > 0,
          "paper index path never launched K2")
    full_budget = widx.budget.clone()
    profile_queries(web, 8, walk_index=widx)

    # retired rows: the partial branch walks every lane live as well; last,
    # since the index stays partial
    pick = torch.randperm(web.n, generator=gen, device=dev)[:web.n // 3]
    widx.retire(pick.cpu().numpy(), budget=PAPER_INDEX_WIDTH // 3)
    check(widx.partial, "retired index is not partial")
    psrcs = PprWorkload(web, 256, seed=0).sources[:CHECK_SOURCES]
    pexact = ppr_power_iteration(web, psrcs, device="cuda")
    walk_gather.reset_launches()
    ell_spmv.reset_launches()
    res = fora_fused(web_dg, psrcs, params, num_walks=iout["walk_lanes"],
                     index=widx, device="cuda")
    pi = res.pi.cpu().numpy()
    rel = rel_err(pi, pexact, web.n)
    launches["retired_index"] = walk_gather.LAUNCHES["walk_endpoint_gather"]
    push_launches = dict(ell_spmv.LAUNCHES)
    print(f"  retired third of the rows to budget {PAPER_INDEX_WIDTH // 3}: "
          f"FORA max rel err {rel:.4f} over {CHECK_SOURCES} sources, K3 "
          f"launches {launches['retired_index']}, push {push_launches}")
    check(np.isfinite(pi).all() and rel < 0.5,
          f"retired index path: FORA rel err {rel} >= eps")
    check(launches["retired_index"] > 0, "retired index run never "
          "launched K3")
    check(push_launches["ell_spmm_sliced"] > 0, "retired index run never "
          "launched K2")

    print(f"phase 5: kernel times (device time by torch.profiler; events = "
          f"host pace of back-to-back calls), card {card}")

    def timed(name, nbr, msk, w, rm, thr, x, label, reps=200, fold=None,
              plan=None):
        n, B = x.shape[1], x.shape[0]
        is_sliced = rm is not None
        if is_sliced:
            kern = lambda: ell_spmv.ell_spmm_sliced_cuda(  # noqa: E731
                nbr, msk, w, rm, x, thr, fold)
        else:
            kern = lambda: ell_spmv.ell_spmm_cuda(  # noqa: E731
                nbr, msk, w, x, thr, plan)
        a = csr_of(nbr, msk, w, rm, n)
        xT = x.t().contiguous()
        lib = lambda: torch.sparse.mm(a, xT)  # noqa: E731
        _, lib_ratio = err_ratio(lib().t(), plain(nbr, msk, *f64(w), rm,
                                                  *f64(x, None)),
                                 LIBRARY_RTOL)
        check(lib_ratio <= 1.0, f"library yardstick disagrees for {name}")
        split = device_split_us(kern, reps)
        ms = sum(split.values()) / 1e3
        plain_ms = device_ms(lambda: plain(nbr, msk, w, rm, x, thr),
                             max(5, reps // 20))
        lib_ms = device_ms(lib, reps)
        ev_ms = events_ms(kern, reps)
        bound, by = spmm_cost(int(msk.sum()), n, B, nbr.shape[0],
                              thr is not None, is_sliced)
        print(f"    {name} device time by kernel: " + ", ".join(
            f"{k[:48]} {us:.2f} us" for k, us in split.items()))
        print(f"  {name:16s} {label:38s} kernel {ms * 1e3:9.2f} us "
              f"(events {ev_ms * 1e3:9.2f} us)  bound "
              f"{bound * 1e3:8.2f} us ({by})  plain {plain_ms * 1e3:10.2f}"
              f" us  torch.sparse.mm {lib_ms * 1e3:9.2f} us  [{card}]")
        return ms, plain_ms, bound, by, lib_ms

    # host cost of one launch through ctypes, beside the wrapper's
    x3 = mass_rows(gen, 3, small.n, dev)
    lib = ell_spmv._lib()
    xm3, y3 = torch.empty((small.n, 3), device=dev), \
        torch.empty((small.n, 3), device=dev)
    raw = [t.data_ptr() for t in (*dense_t, dense_plan.extent, x3,
                                  dense_thr, xm3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        lib.ell_spmm_dense_launch(
            *raw, None, y3.data_ptr(), x3.stride(0), x3.stride(1), small.n,
            small.n, dense_t[0].shape[1], 3, dense_plan.lanes.bit_length() - 1,
            -1, stream)
    torch.cuda.synchronize()
    raw_us = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(1000):
        ell_spmv.ell_spmm_cuda(*dense_t, x3, dense_thr, dense_plan)
    torch.cuda.synchronize()
    wrap_us = (time.perf_counter() - t0) * 1e3
    print(f"  host: raw ctypes launch {raw_us:.2f} us/call, checked "
          f"wrapper {wrap_us:.2f} us/call (n=2000, B=3, host clock)")
    # K1 at the dense path's shape, K2 at the paper path's (the executor's
    # block), both with the fused threshold as the push runs them
    k1 = timed("ell_spmm", *dense_t, None, dense_thr,
               mass_rows(gen, len(DENSE_SOURCES), small.n, dev),
               f"dense path n=2000 B={len(DENSE_SOURCES)}", plan=dense_plan)
    # x as the push passes it: the transpose of an (n, B) residual
    k2 = timed("ell_spmm_sliced", *web_t, web_rm, web_thr,
               mass_rows(gen, ForaExecutor.block_size, web.n, dev),
               f"paper path web-stanford B={ForaExecutor.block_size}",
               fold=web_fold)
    for B in (CHECK_SOURCES, 8, 64):
        timed("ell_spmm_sliced", *web_t, web_rm, web_thr,
              mass_rows(gen, B, web.n, dev).t().contiguous().t(),
              f"web-stanford B={B}", reps=50, fold=web_fold)
    # K1 where phase 8 launches it: the Pokec-order table at B = 1 (a FORA
    # query's push: the frontier route), phase 8's threshold; x of mass
    # rows, most of it above the threshold
    timed("ell_spmm", *pokec_t, None, pokec_thr,
          mass_rows(gen, 1, pokec.n, dev),
          f"pokec n={pokec.n} K={pokec_t[0].shape[1]} B=1 thr", reps=50,
          plan=pokec_plan)
    uni = small_test_graph(n=web.n, avg_deg=web.m / web.n, seed=1)
    uni_t, _, uni_thr = table(uni, "dense")
    uni_plan = ell_spmv.dense_plan(uni_t[1])
    for B in (1, 64):
        timed("ell_spmm", *uni_t, None, uni_thr,
              mass_rows(gen, B, uni.n, dev),
              f"uniform n={uni.n} K={uni_t[0].shape[1]} B={B}", reps=50,
              plan=uni_plan)

    def timed_spmv(tables, plan, label, reps=200):
        """K4 on a dense table at B = 1, as the power iteration runs it:
        beside spmm_cost's bound at B = 1, the float32 plain version and
        ``torch.sparse.mm`` of the same table on an (n, 1) column."""
        nbr, msk, w = tables
        n = nbr.shape[0]
        x = mass_rows(gen, 1, n, dev)[0]
        kern = lambda: ell_spmv.ell_spmv_cuda(  # noqa: E731
            nbr, msk, w, x, plan)
        plain_f = lambda: ref.ell_spmv_ref(nbr, msk, x, w)  # noqa: E731
        a = csr_of(nbr, msk, w, None, n)
        xc = x[:, None].contiguous()
        lib = lambda: torch.sparse.mm(a, xc)  # noqa: E731
        _, lib_ratio = err_ratio(lib()[:, 0], ref.ell_spmv_ref(
            nbr, msk, x.double(), w.double()), LIBRARY_RTOL)
        check(lib_ratio <= 1.0, "library yardstick disagrees for K4")
        ms = device_ms(kern, reps)
        plain_ms = device_ms(plain_f, max(5, reps // 20))
        lib_ms = device_ms(lib, reps)
        ev_ms = events_ms(kern, reps)
        bound, by = spmm_cost(int(msk.sum()), n, 1, n, False, False)
        print(f"  {'ell_spmv':16s} {label:38s} kernel {ms * 1e3:9.2f} us "
              f"(events {ev_ms * 1e3:9.2f} us)  bound "
              f"{bound * 1e3:8.2f} us ({by}; whole table "
              f"{(nbr.numel() * 9 + 8 * n) / HBM_BYTES_PER_S * 1e6:.2f} us)"
              f"  plain {plain_ms * 1e3:10.2f} us  torch.sparse.mm "
              f"{lib_ms * 1e3:9.2f} us  [{card}]")
        del a
        return ms, plain_ms, bound, by, lib_ms

    k4 = timed_spmv(pokec_t, pokec_plan,
                    f"pokec n={pokec.n} K={pokec_t[0].shape[1]} B=1")
    timed_spmv(dense_t, dense_plan,
               f"dense path n={small.n} K={dense_t[0].shape[1]} B=1")
    floors(floors_lib, pokec_t, pokec_plan, k4, card)
    timed_residuals(pokec_t, pokec_plan, pokec_thr, residuals, card)
    # K1's two routes over one query's push from node 0, the measure of
    # the route rule (ell_spmv.FRONTIER_MIN_N): the dense (index) path's
    # table, uniform tables at Pokec's mean degree, the uniform table above
    # and phase 8's, each at its path's push threshold (phase 8's for the
    # Pokec-order table, FORA's default for the rest)
    pokec_params = ForaParams(epsilon=0.5, rmax_scale=POKEC_RMAX_SCALE)
    route_cases = [("dense path", small, dense_t, dense_plan,
                    ForaParams(epsilon=0.5))]
    for n_r in ROUTE_SIZES:
        g_r = small_test_graph(n=n_r, avg_deg=POKEC_M / POKEC_N, seed=3)
        t_r = table(g_r, "dense")[0]
        route_cases.append(("uniform", g_r, t_r, ell_spmv.dense_plan(t_r[1]),
                            ForaParams(epsilon=0.5)))
    route_cases += [("uniform", uni, uni_t, uni_plan, ForaParams(epsilon=0.5)),
                    ("pokec", pokec, pokec_t, pokec_plan, pokec_params)]
    for label, g_r, t_r, plan_r, params_r in route_cases:
        res_r = push_residuals(
            t_r, torch.from_numpy(g_r.out_degree).to(dev), plan_r, 0,
            params_r.resolve(g_r).rmax)
        timed_push_routes(label, t_r, plan_r, thr_of(g_r, params_r), res_r,
                          card, reps=3 if g_r.n > 1 << 20 else 20)
        del res_r
    del route_cases

    def timed_gather(idx, budget, graph, dgraph, L, label, reps=200):
        """K3 at a path's shape: the index's table, and starts and weights
        of one real query (a push from node 0, starts sampled from its
        residual as the fused query samples them)."""
        seeds = one_hot_seeds([0], graph.n, dev)
        push = forward_push(dgraph.in_neighbors, dgraph.in_mask,
                            dgraph.in_weights, dgraph.out_degree, seeds,
                            alpha=rp.alpha,
                            rmax=params.resolve(graph).rmax,
                            row_map=dgraph.in_row_map)
        u = torch.rand((1, L), generator=gen, device=dev)
        starts, r_sum = sample_walk_starts(push.r, u)
        starts = starts.contiguous()
        w = lane_weights(r_sum, L).contiguous()
        args = (idx.endpoints, budget, starts, w)
        kern = lambda: walk_gather.walk_endpoint_gather_cuda(  # noqa: E731
            *args)
        plain = lambda: ref.walk_endpoint_gather_ref(*args)  # noqa: E731
        # the library yardstick: one index_add_ of the (cell, weight) pairs
        # already gathered, the gather itself left out
        lane = torch.arange(L, device=dev)
        s64 = starts.long()
        cell = idx.endpoints[s64, lane[None]].long().reshape(-1)
        wv = torch.where(lane[None] < budget[s64], w, 0.0).reshape(-1)
        lib = lambda: torch.zeros(  # noqa: E731
            graph.n, device=dev).index_add_(0, cell, wv)

        def lib_gather():
            # the same with the gather: the endpoints' advanced indexing,
            # the budget mask and index_add_, as PyTorch calls
            s = starts.long()
            e = idx.endpoints[s, lane[None]].long().reshape(-1)
            m = torch.where(lane[None] < budget[s], w, 0.0).reshape(-1)
            return torch.zeros(graph.n, device=dev).index_add_(0, e, m)

        want = ref.walk_endpoint_gather_ref(*args[:3], w.double())
        for yard in (lib, lib_gather):
            _, lib_ratio = err_ratio(yard()[None], want, LIBRARY_RTOL)
            check(lib_ratio <= 1.0, "library yardstick disagrees for K3")
        split = device_split_us(kern, reps)
        ms = sum(split.values()) / 1e3
        plain_ms = device_ms(plain, max(5, reps // 20))
        lib_ms = device_ms(lib, reps)
        lib_gather_ms = device_ms(lib_gather, reps)
        ev_ms = events_ms(kern, reps)
        bound, by = gather_cost(1, L, graph.n, idx.width)
        print("    K3 device time by kernel: " + ", ".join(
            f"{name[:40]} {us:.2f} us" for name, us in split.items()))
        print(f"  {'walk_endpoint_gather':20s} {label:34s} kernel "
              f"{ms * 1e3:9.2f} us (events {ev_ms * 1e3:9.2f} us)  bound "
              f"{bound * 1e3:8.2f} us ({by})  plain {plain_ms * 1e3:10.2f} us"
              f"  index_add_ (gather excluded) {lib_ms * 1e3:9.2f} us  "
              f"gather + mask + index_add_ {lib_gather_ms * 1e3:9.2f} us  "
              f"[{card}]")
        return ms, plain_ms, bound, by, lib_ms

    timed_gather(dex.walk_index, dex.walk_index.budget, small, dg, dense_L,
                 f"dense path n=2000 B=1 L={dense_L}")
    k3 = timed_gather(widx, full_budget, web, web_dg, PAPER_INDEX_WIDTH,
                      f"paper path web-stanford B=1 L={PAPER_INDEX_WIDTH}")
    del widx, dex, web_dg, dg
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    k6 = phase6_lm(dev, gen, card)
    print(f"  phase 6 wall {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k5 = phase7_din(dev, gen, card)
    print(f"  phase 7 wall {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches["ell_spmv"] = phase8_pokec(pokec, pokec_dg, dev, card)
    print(f"  phase 8 wall {time.perf_counter() - t0:.1f}s (graph and "
          f"table built before phase 1 in {pokec_graph_s + pokec_table_s:.1f}"
          f"s)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fold_row = phase9_engine(web, small, dev, gen, card)
    print(f"  phase 9 wall {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase10_dyn(web, dev, card)
    print(f"  phase 10 wall {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    stats["ell_spmm_sliced"]["max_abs_err"] = max(
        stats["ell_spmm_sliced"]["max_abs_err"],
        phase11_daemon(web, dev, gen, card))
    torch.cuda.empty_cache()
    for name, err in phase12_sharded(web, pokec, small, dev, gen, card,
                                     psrcs, pexact).items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    del web, pokec, pokec_dg, small
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    family_launches, family_err = phase13_family(dev, gen, card)
    k6["launches"] += family_launches
    k6["max_abs_err"] = max(k6["max_abs_err"], family_err)
    print(f"  phase 13 wall {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    segment_row = phase14_gnn(dev, gen, card)
    torch.cuda.empty_cache()
    grad_row, train_launches = phase15_gnn_train(dev, gen, card)
    segment_row["launches"] += train_launches + oracle_launches
    torch.cuda.empty_cache()
    bag_grad_rows, din_bag, din_segment = phase16_din_train(dev, gen, card)
    k5["launches"] += din_bag
    segment_row["launches"] += din_segment
    # the fold's launches on every path that drove it (counts zeroed before
    # each, read after)
    fold_row["launches"] = sum(FOLD_LAUNCHES.values())
    fold_row["launches_by_path"] = dict(FOLD_LAUNCHES)
    print(f"endpoint fold launches by path: {FOLD_LAUNCHES}")

    summary = []
    for name, (ms, plain_ms, bound, by, lib_ms) in (
            ("ell_spmm", k1), ("ell_spmm_sliced", k2),
            ("walk_endpoint_gather", k3), ("ell_spmv", k4)):
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms})
    for row in (k6, k5, fold_row, segment_row, grad_row, *bag_grad_rows):
        summary.append({"name": row["name"], "route": "cuda",
                        "source": SOURCES[row["name"]],
                        "replaces": REPLACES[row["name"]],
                        **{k: v for k, v in row.items() if k != "name"}})
    print(json.dumps({"kernels": summary, "not_ported": NOT_PORTED}))

    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
