"""Dispatch between each kernel and its plain version.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. There is no other route:
a CUDA call whose kernel does not build or launch raises. The same holds
for the backwards that training takes through :func:`segment_reduce`,
:func:`gather_rows`, :func:`embedding_bag` and :func:`flash_attention`:
on the card they are the port's kernels, never a plain version,
``index_add_`` or another float fold on atomics.
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from dataclasses import dataclass

import torch

from . import ref
from .ell_spmv import (DensePlan, SlicedFold, ell_spmm_cuda,
                       ell_spmm_sliced_cuda, ell_spmv_cuda)
from .embedding_bag import embedding_bag_cuda, embedding_bag_grad_cuda
from .endpoint_fold import endpoint_fold_cuda
from .flash_attention import flash_attention_cuda
from .flash_attention_bwd import flash_attention_bwd_cuda
from .segment_reduce import segment_reduce_cuda, segment_reduce_grad_cuda
from .walk_gather import walk_endpoint_gather_cuda


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def ell_spmv(neighbors: torch.Tensor, mask: torch.Tensor,
             weights: torch.Tensor, x: torch.Tensor, *,
             plan: DensePlan | None = None) -> torch.Tensor:
    """One-vector (n,) pull-form SpMV over the dense (n, K) table: with the
    in-neighbour table and w = 1/deg_out(src), ``P^T x``. ``plan`` is the
    table's row plan for the kernel; the plain version needs none."""
    if _on_cuda(x):
        return ell_spmv_cuda(neighbors, mask, weights, x, plan)
    return ref.ell_spmv_ref(neighbors, mask, x.to(torch.float32),
                            weights.to(torch.float32))


def ell_spmm(neighbors: torch.Tensor, mask: torch.Tensor,
             weights: torch.Tensor, x: torch.Tensor, *,
             threshold: torch.Tensor | None = None,
             plan: DensePlan | None = None) -> torch.Tensor:
    """Batched (B, n) pull-form SpMM over the dense (n, K) table;
    ``threshold`` fuses FORA's push condition into the gather. ``plan`` is
    the table's row plan for the kernel; the plain version needs none."""
    if _on_cuda(x):
        return ell_spmm_cuda(neighbors, mask, weights, x, threshold, plan)
    return ref.ell_spmm_ref(neighbors, mask, x, weights, threshold)


def ell_spmm_sliced(neighbors: torch.Tensor, mask: torch.Tensor,
                    weights: torch.Tensor, row_map: torch.Tensor,
                    x: torch.Tensor, *,
                    threshold: torch.Tensor | None = None,
                    fold: SlicedFold | None = None) -> torch.Tensor:
    """Sliced-ELL batched SpMM: virtual rows (n_virtual, W) folded onto the
    real rows through the ascending ``row_map``. ``fold`` is the table's
    fold structure for the kernel; the plain version needs none."""
    if _on_cuda(x):
        return ell_spmm_sliced_cuda(neighbors, mask, weights, row_map, x,
                                    threshold, fold)
    return ref.ell_spmm_sliced_ref(neighbors, mask, x, weights, threshold,
                                   row_map)


def replicate(t: torch.Tensor | None, devices: Sequence[torch.device]
              ) -> tuple[torch.Tensor | None, ...]:
    """``t`` on each of ``devices`` (a shard's device each): ``t`` itself
    where it lies, else one copy a distinct device; None stays None."""
    on = {d: t if t is None or t.device == d else t.to(d)
          for d in dict.fromkeys(devices)}
    return tuple(on[d] for d in devices)


def ell_spmm_shard(neighbors: Sequence[torch.Tensor],
                   mask: Sequence[torch.Tensor],
                   weights: Sequence[torch.Tensor], x: torch.Tensor, *,
                   threshold: torch.Tensor | None = None,
                   plans: Sequence[DensePlan] | None = None) -> torch.Tensor:
    """Node-sharded dense SpMM, one process driving every shard: shard s
    holds the (rows_local, K) block s of the destination rows on its own
    device, with global gather ids. Each block is one :func:`ell_spmm` on
    its shard's device (x and ``threshold`` copied there once a call where
    they lie elsewhere), then the (B, rows_local) blocks are put together
    in shard order, the JAX package's tiled all-gather, and the row
    padding is cut off. Returns (B, n) on x's device; each row has the sum
    its shard computed, so the call repeats bit for bit."""
    n = x.shape[1]
    if not len(neighbors) == len(mask) == len(weights) or \
            (plans is not None and len(plans) != len(neighbors)):
        raise ValueError("one table block (and plan) a shard")
    devs = [nbr.device for nbr in neighbors]
    xs, ts = replicate(x, devs), replicate(threshold, devs)
    blocks = []
    for s, nbr in enumerate(neighbors):
        y = ell_spmm(nbr, mask[s], weights[s], xs[s], threshold=ts[s],
                     plan=None if plans is None else plans[s])
        blocks.append(y.to(x.device).t())              # (rows_local, B)
    if sum(b.shape[0] for b in blocks) < n:
        raise ValueError(f"the blocks hold {sum(b.shape[0] for b in blocks)}"
                         f" rows for n={n}")
    return torch.cat(blocks)[:n].t()


def ell_spmm_sliced_shard(neighbors: Sequence[torch.Tensor],
                          mask: Sequence[torch.Tensor],
                          weights: Sequence[torch.Tensor],
                          row_map: Sequence[torch.Tensor], x: torch.Tensor,
                          *, threshold: torch.Tensor | None = None,
                          folds: Sequence[SlicedFold] | None = None
                          ) -> torch.Tensor:
    """Node-sharded sliced SpMM, one process driving every shard: shard s
    holds a block of the virtual rows with its own ascending ``row_map``
    block (and fold structure) on its own device. Each block is one
    :func:`ell_spmm_sliced` onto the full (B, n) frame on its shard's
    device (x and ``threshold`` copied there once a call where they lie
    elsewhere), and the frames are summed in shard order on x's device,
    the JAX package's psum. A real row whose slices two shards hold is
    summed in two parts; every sum has one order, so the call repeats bit
    for bit. Returns (B, n)."""
    if not len(neighbors) == len(mask) == len(weights) == len(row_map) or \
            (folds is not None and len(folds) != len(neighbors)):
        raise ValueError("one table block, row_map (and fold) a shard")
    devs = [nbr.device for nbr in neighbors]
    xs, ts = replicate(x, devs), replicate(threshold, devs)
    total = None
    for s, nbr in enumerate(neighbors):
        part = ell_spmm_sliced(nbr, mask[s], weights[s], row_map[s], xs[s],
                               threshold=ts[s],
                               fold=None if folds is None else folds[s])
        part = part.to(x.device)
        total = part if total is None else total + part
    return total


def walk_endpoint_gather(endpoints: torch.Tensor, budget: torch.Tensor,
                         starts: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """The index-backed walk phase: each lane's stored endpoint
    ``endpoints[starts[b,i], i]`` gets its weight, where the start node's
    ``budget`` covers the lane (the live walk owns the others). (B, n)."""
    if _on_cuda(starts):
        return walk_endpoint_gather_cuda(endpoints, budget, starts, weights)
    return ref.walk_endpoint_gather_ref(endpoints, budget, starts, weights)


def endpoint_fold(pos: torch.Tensor, weights: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The live walk phase's fold: each lane's weight added at its endpoint
    ``pos``, (B, n) from pos and weights (B, W). On the card an integer
    sum on a scale fixed by each row (``ref.endpoint_fold_fixed_ref``'s
    bits), so a row has the same bits on every call, in any batch."""
    if _on_cuda(weights):
        return endpoint_fold_cuda(pos.to(torch.int32).contiguous(),
                                  weights.contiguous(), n)
    return ref.endpoint_fold_ref(pos, weights, n)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor | None,
                        dout: torch.Tensor, *, causal: bool = True,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's backward: (dQ, dK, dV) given the forward's output ``o``, its
    logsumexp ``lse`` (B, Sq, Hq) and the output's gradient ``dout``. On
    the card ``csrc/flash_attention_bwd.cu``, which needs the logsumexp;
    the plain version (``ref.flash_attention_bwd_ref``) forms its own."""
    if _on_cuda(q):
        if lse is None:
            raise ValueError("K6's backward on the card needs the forward's "
                             "logsumexp")
        return flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal=causal,
                                        q_offset=q_offset)
    return ref.flash_attention_bwd_ref(q, k, v, o, dout, causal=causal,
                                       q_offset=q_offset)


class _FlashAttention(torch.autograd.Function):
    """K6 with its backward (:func:`flash_attention_bwd`), for training. On
    the card the forward also writes each row's logsumexp, which it keeps
    with q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        lse = None
        if _on_cuda(q):
            out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                            q_offset=q_offset,
                                            return_lse=True)
        else:
            out = ref.flash_attention_ref(q, k, v, causal=causal,
                                          q_offset=q_offset)
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, Dh) over k, v (B, Skv, Hkv, Dh) with GQA
    folding and, if ``causal``, the mask at global query positions
    ``q_offset + i``. Output in q's dtype. Differentiable in q, k and v
    where autograd asks (training): the backward is
    :func:`flash_attention_bwd`. A call that needs no gradient (serving) is
    K6's forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, int(q_offset))
    if _on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)


def _bag(table: torch.Tensor, ids: torch.Tensor,
         weights: torch.Tensor) -> torch.Tensor:
    if _on_cuda(table):
        return embedding_bag_cuda(table, ids, weights)
    return ref.embedding_bag_ref(table, ids, weights)


def embedding_bag_grad(table: torch.Tensor, ids: torch.Tensor,
                       weights: torch.Tensor, g: torch.Tensor,
                       plan: "SegmentPlan | None", *, table_grad: bool = True,
                       weights_grad: bool = True
                       ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """K5's backward: (dT (V, d), dw (B, L)) given the output's gradient g
    (B, d), each None where not asked for (``ref.embedding_bag_grad_ref``'s
    function). On the card ``csrc/embedding_bag_grad.cu`` over ``plan``,
    the plan of the ids (:func:`bag_plan`), which the table's gradient
    needs there; the plain version needs none."""
    if _on_cuda(table):
        order = keys = offsets = None
        if table_grad:
            if plan is None or plan.order is None:
                raise ValueError("K5's table gradient on the card needs the "
                                 "plan of the ids")
            order, keys, offsets = plan.order, plan.keys, plan.offsets
        return embedding_bag_grad_cuda(
            table.contiguous(), ids, weights.contiguous(), g.contiguous(),
            order, keys, offsets, table_grad=table_grad,
            weights_grad=weights_grad)
    return ref.embedding_bag_grad_ref(table, ids, weights, g,
                                      table_grad=table_grad,
                                      weights_grad=weights_grad)


class _EmbeddingBag(torch.autograd.Function):
    """K5 with its backward (:func:`embedding_bag_grad`), for training. It
    keeps the table, the ids and the weights, and the plan of the ids."""

    @staticmethod
    def forward(ctx, table, ids, weights, plan):
        ctx.plan = plan
        ctx.save_for_backward(table, ids, weights)
        return _bag(table, ids, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        d_table, d_w = embedding_bag_grad(
            table, ids, weights, g, ctx.plan,
            table_grad=ctx.needs_input_grad[0],
            weights_grad=ctx.needs_input_grad[2])
        return d_table, None, d_w, None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, *,
                  plan: "SegmentPlan | None" = None) -> torch.Tensor:
    """Weighted bag sum ``out[b] = sum_l weights[b,l] * table[ids[b,l]]``:
    (B, d) from table (V, d), ids and weights (B, L). Differentiable in the
    table and the weights where autograd asks (:func:`embedding_bag_grad`);
    on the card a table that needs a gradient needs ``plan``, the plan of
    the ids (:func:`bag_plan`), built once a batch; without it the
    backward raises there. A call that needs no gradient (serving) is K5
    alone."""
    if not torch.is_grad_enabled() or not (table.requires_grad
                                           or weights.requires_grad):
        return _bag(table, ids, weights)
    return _EmbeddingBag.apply(table, ids, weights, plan)


@dataclass(frozen=True)
class SegmentPlan:
    """Where each segment's rows lie, built once per index and reused by
    every reduction over it (a GNN's layers and aggregators).

    The plan's positions are the edges in segment order: ``keys`` (E,)
    int32 is the stable sort of the index, clamped to [-1, S] (-1 and S:
    an index outside [0, S), in no segment), and segment s is the
    positions ``offsets[s]:offsets[s+1]`` (``offsets`` (S + 1,) int32), in
    ascending edge id. ``order`` (E,) int32 is the sort's permutation:
    position p holds the row ``order[p]`` of the values (the gathered
    route), and ``index`` (E,) int32 is the index itself, each edge's
    segment in edge order (the backward writes the gradient by it), or
    None where no backward over the gathered route needs it. A plan whose
    ``order`` is None (:meth:`contiguous`) is of values that the caller
    has laid out in plan order already, row p at position p: the kernels
    then read and write rows as one stream, and the keys serve for both.

    The kernels over it (``csrc/segment_reduce.cu``, ``segment_grad.cu``)
    replace XLA's ``jax.ops.segment_sum/max/min`` and their autodiff
    (``repro/models/gnn/common.py:44-61``; no TPU kernel). Bytes bound them
    on the H100, and the plan is laid out for that: the keys let them cut
    the positions into runs of equal length, one a group of lanes,
    whatever the segments' lengths, and fold the parts of a segment that
    crosses runs by a fixed tree (its geometry depends on E and d alone,
    not on the plan); the contiguous view lets them stream rows without
    the order; the index lets the backward write the gradient in edge
    order as one stream."""

    order: torch.Tensor | None
    keys: torch.Tensor
    offsets: torch.Tensor
    index: torch.Tensor | None = None

    @property
    def num_segments(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def num_positions(self) -> int:
        return self.keys.shape[0]

    @property
    def counts(self) -> torch.Tensor:
        """(S,) int32 edges a segment: ``segment_sum`` of ones, exactly."""
        return self.offsets[1:] - self.offsets[:-1]

    def contiguous(self) -> "SegmentPlan":
        """The same segments over values laid out in plan order (row p of
        the values at position p, e.g. ``x[plan.order]``): no order."""
        return SegmentPlan(None, self.keys, self.offsets)

    def rows(self) -> torch.Tensor:
        """(E,) the row of each position: ``order``, or 0..E-1."""
        if self.order is not None:
            return self.order
        return torch.arange(self.num_positions, dtype=torch.int32,
                            device=self.keys.device)


def segment_plan(index: torch.Tensor, num_segments: int, *,
                 keep_index: bool = True) -> SegmentPlan:
    """The :class:`SegmentPlan` of an integer index (E,) over
    ``num_segments`` segments, on the index's device, with torch ops alone:
    a stable ``torch.sort`` (its keys kept, clamped to [-1, S]) and
    ``torch.searchsorted`` for the offsets (no ``bincount``, which reads
    the largest value back to the host). No host sync. ``keep_index``
    keeps the index (as int32; the tensor itself where it is one) for the
    backward of a reduction over the plan; a plan that only serves a
    gather's backward (a forward sum) need not keep it."""
    if index.dim() != 1 or index.dtype.is_floating_point:
        raise ValueError(f"index must be a 1-D integer tensor, got "
                         f"{index.dtype} {tuple(index.shape)}")
    if num_segments < 1:
        raise ValueError(f"need num_segments >= 1, got {num_segments}")
    dev = index.device
    S = num_segments
    if index.dtype not in (torch.int32, torch.int64):
        index = index.long()
    keys, order = torch.sort(index, stable=True)
    bounds = torch.arange(S + 1, device=dev, dtype=keys.dtype)
    offsets = torch.searchsorted(keys, bounds).to(torch.int32)
    kept = None
    if keep_index:
        kept = (index if index.dtype == torch.int32
                else index.clamp(-1, S).to(torch.int32)).contiguous()
    return SegmentPlan(order.to(torch.int32), keys.clamp(-1, S).to(
        torch.int32), offsets, kept)


def bag_plan(ids: torch.Tensor, num_rows: int) -> SegmentPlan:
    """The plan of a bag's ids (B, L) over a table of ``num_rows`` rows,
    for K5's table gradient (:func:`embedding_bag`): the plan of the flat
    ids read as K5 reads them, an id in [-V, 0) as row id + V, so that the
    card's gradient names the rows the forward read."""
    flat = ids.reshape(-1)
    return segment_plan(torch.where(flat < 0, flat + num_rows, flat),
                        num_rows, keep_index=False)


def _segment_rows(values: torch.Tensor, plan: SegmentPlan,
                  op: str) -> torch.Tensor:
    """The reduction of contiguous (E, d) rows: (S, d)."""
    if _on_cuda(values):
        return segment_reduce_cuda(values, plan.order, plan.keys,
                                   plan.offsets, op)
    return ref.segment_reduce_ref(values, plan.rows(), plan.offsets, op)


def segment_reduce_grad(g_out: torch.Tensor, values: torch.Tensor | None,
                        out: torch.Tensor | None, plan: SegmentPlan,
                        op: str) -> torch.Tensor:
    """The gradient (E, d) of the reduction of (E, d) ``values`` over the
    plan, given its output ``out`` (S, d) and that output's gradient
    ``g_out``: ``ref.segment_reduce_grad_ref``'s rule (a sum's rows copied
    to the segment's edges, a max's or min's split equally among the tied
    edges column by column, 0 for an edge in no segment). ``values`` and
    ``out`` are read for max and min only."""
    if _on_cuda(g_out):
        return segment_reduce_grad_cuda(g_out, values, out, plan.order,
                                        plan.keys, plan.index, plan.offsets,
                                        op)
    return ref.segment_reduce_grad_ref(g_out, values, out, plan.rows(),
                                       plan.offsets, op)


class _SegmentReduce(torch.autograd.Function):
    """The reduction with its backward (:func:`segment_reduce_grad`). It
    keeps the values and the output for max and min, nothing for a sum."""

    @staticmethod
    def forward(ctx, values, plan, op):
        out = _segment_rows(values, plan, op)
        ctx.plan, ctx.op = plan, op
        if op != "sum":
            ctx.save_for_backward(values, out)
        return out

    @staticmethod
    def backward(ctx, g_out):
        values, out = ctx.saved_tensors if ctx.op != "sum" else (None, None)
        return (segment_reduce_grad(g_out.contiguous(), values, out,
                                    ctx.plan, ctx.op), None, None)


def segment_reduce(values: torch.Tensor, plan: SegmentPlan,
                   op: str) -> torch.Tensor:
    """``op`` in {"sum", "max", "min"} of values (E,) or (E, d) over the
    plan's segments: (S,) or (S, d), as ``jax.ops.segment_<op>`` gives it
    (an empty segment 0, -inf or +inf). On the card in one summation order
    a cell, fixed by the plan, so a second call gives the same bits.
    Differentiable in ``values``: the backward is
    :func:`segment_reduce_grad` over the same plan."""
    flat = values.reshape(values.shape[0],
                          math.prod(values.shape[1:])).contiguous()
    out = _SegmentReduce.apply(flat, plan, op)
    return out.reshape((plan.num_segments,) + tuple(values.shape[1:]))


class _GatherRows(torch.autograd.Function):
    """``x[index]`` whose backward is a segment sum over the plan of the
    index: one more launch of the forward kernel, in one summation order,
    instead of ``index_select``'s ``index_add_``."""

    @staticmethod
    def forward(ctx, x, index, plan):
        ctx.plan, ctx.shape = plan, x.shape
        return torch.index_select(x, 0, index)

    @staticmethod
    def backward(ctx, g):
        # the fold is float32: rows of another float type are widened for
        # it and the sums rounded back (a no-op for float32)
        rows = g.reshape(g.shape[0], math.prod(g.shape[1:])).contiguous()
        summed = _segment_rows(rows.float(), ctx.plan, "sum")[:ctx.shape[0]]
        return summed.to(g.dtype).reshape(ctx.shape), None, None


def gather_rows(x: torch.Tensor, index: torch.Tensor,
                plan: SegmentPlan) -> torch.Tensor:
    """Rows ``x[index]`` (one ``index_select``) with a gradient that is
    ``segment_reduce(g, plan, "sum")`` cut to x's rows (taken in float32
    for rows of another float type, then rounded to it). ``plan`` is the
    plan of ``index`` over at least x.shape[0] segments, built once per
    index and batch, or of an index that differs from it only on rows
    whose gradient is exactly zero (the masked edges a model multiplies by
    0, sent to a trash segment past x's rows)."""
    if plan.num_segments < x.shape[0] or \
            plan.num_positions != index.shape[0]:
        raise ValueError(f"the plan ({plan.num_segments} segments of "
                         f"{plan.num_positions} entries) is not of an index "
                         f"of {index.shape[0]} rows into {x.shape[0]}")
    return _GatherRows.apply(x, index, plan)


# ---------------------------------------------------------------------------
# dynamic-graph delta application: plain torch on the residency's device,
# as the JAX package leaves them to XLA (no Pallas kernel). The host hands
# over only the small per-batch delta arrays; the O(table) rewrite happens
# where the table lives. Free and padding slots carry the sentinel row_map
# or src value n, which every consumer drops: K2 reads rows only up to its
# fold's row_ptr[n], the plain sliced version drops row_map >= n, and the
# walks read the CSR view through out_offsets.


def _pair_keys(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """int64 key a * (n + 1) + b of each pair: ascending in (a, b) for a, b
    in [0, n], negative for a pair holding -1."""
    return a.long() * (n + 1) + b.long()


def _member(keys: torch.Tensor, sorted_keys: torch.Tensor) -> torch.Tensor:
    """``keys`` found in the ascending ``sorted_keys`` (bool, keys' shape)."""
    if sorted_keys.numel() == 0:
        return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    at = torch.searchsorted(sorted_keys, keys.reshape(-1))
    at = at.clamp(max=sorted_keys.numel() - 1)
    return (sorted_keys[at] == keys.reshape(-1)).reshape(keys.shape)


def push_delta_apply(neighbors: torch.Tensor, mask: torch.Tensor,
                     row_map: torch.Tensor, inv_out: torch.Tensor,
                     add_nbr: torch.Tensor, add_mask: torch.Tensor,
                     add_rm: torch.Tensor, rem_src: torch.Tensor,
                     rem_dst: torch.Tensor, deg_nodes: torch.Tensor,
                     deg_inv: torch.Tensor, cursor: int):
    """Apply one edge-update batch to the sliced pull-form push table.

    State (capacity C >= used rows, ascending ``row_map`` with sentinel-n
    free rows at the tail): ``neighbors``/``mask`` (C, W), ``row_map``
    (C,), ``inv_out`` (n,) float32 = 1/max(deg_out, 1). Delta: ``add_*``
    (A, W)/(A,) new virtual rows written at row ``cursor`` (padding rows:
    mask False, row_map n); ``rem_src``/``rem_dst`` (R,) removed edges
    (padding -1); ``deg_nodes``/``deg_inv`` (R2,) the host's new inverse
    out-degrees (padding index n). A removed edge (u, v) clears every cell
    of row v that names u, found by a sorted-key lookup of each cell's
    (row, neighbour) pair; the added rows are written; a stable sort by
    ``row_map`` restores the ascending contract; and the weights are
    re-derived as ``inv_out[neighbors] * mask``, the gather-multiply the
    host's table build runs, so unchanged cells keep their bits. Returns
    (neighbors, mask, weights, row_map, inv_out), new tensors."""
    n = inv_out.shape[0]
    ext = torch.cat([inv_out, inv_out.new_zeros(1)])
    ext.index_copy_(0, deg_nodes.long().clamp(0, n), deg_inv)
    inv_out = ext[:n]
    gone = torch.sort(_pair_keys(rem_dst, rem_src, n)).values
    mask = mask & ~_member(_pair_keys(row_map[:, None], neighbors, n), gone)
    neighbors = neighbors.clone()
    row_map = row_map.clone()
    A = add_rm.shape[0]
    neighbors[cursor:cursor + A] = add_nbr
    mask[cursor:cursor + A] = add_mask
    row_map[cursor:cursor + A] = add_rm
    order = torch.argsort(row_map, stable=True)
    neighbors = neighbors[order]
    mask = mask[order]
    row_map = row_map[order]
    weights = inv_out[neighbors.long()] * mask
    return neighbors, mask, weights, row_map, inv_out


def walk_delta_apply(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                     alive: torch.Tensor, add_src: torch.Tensor,
                     add_dst: torch.Tensor, add_alive: torch.Tensor,
                     rem_src: torch.Tensor, rem_dst: torch.Tensor,
                     cursor: int, n: int):
    """Apply one edge-update batch to the CSR walk view.

    State (capacity E >= live edges): ``edge_src``/``edge_dst`` (E,) int32
    and the ``alive`` (E,) mask. Removed edges are tombstoned in place
    (sorted-key lookup of each slot's (src, dst) pair), additions written
    at slot ``cursor`` (padding slots: src n, alive False). One stable sort
    by (src, or n for a dead slot; dst) regroups the live edges exactly as
    ``Graph.from_edges`` lays them out, grouped by source and
    destination-ascending within it, with dead and spare slots past the
    live prefix: the live (src, dst) pairs are distinct, so that order is
    unique and the live prefix equals a fresh build's arrays. Returns
    (edge_src, edge_dst, alive, out_offsets (n+1,), out_degree (n,))."""
    gone = torch.sort(_pair_keys(rem_src, rem_dst, n)).values
    alive = alive & ~_member(_pair_keys(edge_src, edge_dst, n), gone)
    edge_src = edge_src.clone()
    edge_dst = edge_dst.clone()
    A = add_src.shape[0]
    edge_src[cursor:cursor + A] = add_src
    edge_dst[cursor:cursor + A] = add_dst
    alive[cursor:cursor + A] = add_alive
    key_src = torch.where(alive, edge_src, n)
    order = torch.argsort(_pair_keys(key_src, edge_dst, n), stable=True)
    edge_src = edge_src[order]
    edge_dst = edge_dst[order]
    alive = alive[order]
    degree = torch.zeros(n + 1, dtype=torch.int32, device=edge_src.device)
    degree.index_add_(0, edge_src.long().clamp(0, n), alive.to(torch.int32))
    out_degree = degree[:n]
    out_offsets = torch.zeros(n + 1, dtype=torch.int32,
                              device=edge_src.device)
    out_offsets[1:] = torch.cumsum(out_degree, 0)
    return edge_src, edge_dst, alive, out_offsets, out_degree
