"""Plain PyTorch versions of the port's kernels.

They define what each kernel computes, with the argument order of
``repro.kernels.ref``. The CPU path of :mod:`repro_torch.kernels.ops` runs
them, and the tests and ``chip_smoke.py`` hold the CUDA kernels against
them on the same inputs.
"""

from __future__ import annotations

import math

import torch


def ell_spmv_ref(neighbors: torch.Tensor, mask: torch.Tensor, x: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Pull-form ELL SpMV: ``y[i] = sum_j mask[i,j] * w[i,j] *
    x[neighbors[i,j]]``. neighbors/mask/weights are (n, K), x is (n,);
    returns (n,) in x's dtype. Over the in-neighbour table with w =
    1/deg_out(src) this is P^T x, one step of exact power iteration."""
    gathered = x[neighbors.long()]                # (n, K)
    w = mask.to(x.dtype)
    if weights is not None:
        w = w * weights.to(x.dtype)
    return (w * gathered).sum(dim=1)


def ell_spmm_ref(neighbors: torch.Tensor, mask: torch.Tensor, x: torch.Tensor,
                 weights: torch.Tensor | None = None,
                 threshold: torch.Tensor | None = None) -> torch.Tensor:
    """Batched pull-form ELL SpMM:

        y[b, i] = sum_j mask[i,j] * w[i,j] * f(x[b, neighbors[i,j]])

    with f the identity, or, given ``threshold`` (n,), FORA's fused push
    selection f(v) = v * [v > threshold[src]]. neighbors/mask/weights are
    (rows, K); x is (B, n). Returns (B, rows).
    """
    idx = neighbors.long()
    gathered = x[:, idx]                          # (B, rows, K)
    if threshold is not None:
        thr = threshold[idx]                      # (rows, K) per-source bound
        gathered = torch.where(gathered > thr[None], gathered, 0.0)
    w = mask.to(x.dtype)
    if weights is not None:
        w = w * weights.to(x.dtype)
    return torch.einsum("nk,bnk->bn", w, gathered)


def ell_spmm_sliced_ref(neighbors: torch.Tensor, mask: torch.Tensor,
                        x: torch.Tensor, weights: torch.Tensor | None = None,
                        threshold: torch.Tensor | None = None,
                        row_map: torch.Tensor | None = None) -> torch.Tensor:
    """Sliced-ELL SpMM: the per-virtual-row partials of
    :func:`ell_spmm_ref`, folded onto the real rows through ``row_map``
    (n_virtual,), ascending. Virtual rows whose ``row_map`` is outside
    [0, n) are padding and dropped, as ``segment_sum`` drops them.
    Returns (B, n).
    """
    if row_map is None:
        raise ValueError("row_map is required for the sliced version")
    partials = ell_spmm_ref(neighbors, mask, x, weights, threshold)
    n = x.shape[1]
    keep = (row_map >= 0) & (row_map < n)
    out = torch.zeros((x.shape[0], n), dtype=partials.dtype,
                      device=partials.device)
    return out.index_add_(1, row_map[keep].long(), partials[:, keep])


def walk_endpoint_gather_ref(endpoints: torch.Tensor, budget: torch.Tensor,
                             starts: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Index-backed walk aggregation: lane i of row b reads the stored
    endpoint ``endpoints[starts[b,i], i]`` and adds its weight there,
    provided the start node's stored budget covers the lane:

        out[b, t] = sum_i w[b,i] * [i < budget[starts[b,i]]]
                                 * [endpoints[starts[b,i], i] == t]

    endpoints (n, W) int32, budget (n,) int32, starts (B, L <= W) int32,
    weights (B, L). Returns (B, n) in the weights' dtype (float32 on the
    path; the card check runs it in float64).
    """
    n = endpoints.shape[0]
    B, L = starts.shape
    lane = torch.arange(L, device=starts.device)
    s = starts.long()
    e = endpoints[s, lane[None, :]].long()                  # (B, L)
    valid = lane[None, :] < budget[s]
    w = torch.where(valid, weights, 0.0)
    flat = e + torch.arange(B, device=e.device)[:, None] * n
    out = torch.zeros(B * n, dtype=weights.dtype, device=weights.device)
    return out.index_add_(0, flat.reshape(-1), w.reshape(-1)).view(B, n)


def endpoint_fold_ref(pos: torch.Tensor, weights: torch.Tensor,
                      n: int) -> torch.Tensor:
    """The live walk-endpoint fold: ``out[b, t] = sum_i w[b,i] *
    [pos[b,i] == t]``, each lane's weight added at its endpoint. pos and
    weights (B, W); returns (B, n) in the weights' dtype. ``index_add_``,
    as the JAX package's ``segment_sum``; on the CPU it adds a row's lanes
    in lane order."""
    B = pos.shape[0]
    flat = pos.long() + torch.arange(B, device=pos.device)[:, None] * n
    out = torch.zeros(B * n, dtype=weights.dtype, device=weights.device)
    out.index_add_(0, flat.reshape(-1), weights.reshape(-1))
    return out.view(B, n)


def endpoint_fold_fixed_ref(pos: torch.Tensor, weights: torch.Tensor, n: int,
                            *, scale_cut: int = 0) -> torch.Tensor:
    """The card's endpoint fold (``csrc/endpoint_fold.cu``) in torch, step
    for step, so that it gives the kernel's bits: pos (B, W) and float32
    weights (B, W) to (B, n) float32. A lane takes part where its weight is
    above 0 and its pos in [0, n). Each row's scale is 2^s, s = 188 -
    ceil(log2 W) - E, E the biased exponent of its largest participating
    weight; a lane adds round-half-even(float64(w) * 2^s) as an int64 to
    its cell, and a cell's sum Q gives float32(float64(Q) * 2^-s). The
    integer sum is exact in any order, so the lane order plays no part.
    ``scale_cut`` takes that many bits off every scale (a coarser fold, for
    the checks that must refuse one); 0 is the kernel's. For tests and
    ``chip_smoke.py``: the port's CPU path keeps ``endpoint_fold_ref``."""
    B, W = pos.shape
    p = pos.long()
    w = weights.to(torch.float32)
    keep = (w > 0) & (p >= 0) & (p < n)
    bits = torch.where(keep, w.view(torch.int32), 0).amax(dim=1)
    shift = 188 - (W - 1).bit_length() - (bits >> 23).long() - scale_cut
    scale = ((shift + 1023) << 52).view(torch.float64)[:, None]
    inverse = ((1023 - shift) << 52).view(torch.float64)[:, None]
    q = torch.where(keep, torch.round(w.double() * scale), 0.0).long()
    rows = torch.arange(B, device=p.device)[:, None]
    flat = torch.where(keep, p, 0) + rows * n
    sums = torch.zeros(B * n, dtype=torch.int64, device=p.device)
    sums.index_add_(0, flat.reshape(-1), q.reshape(-1))
    return (sums.view(B, n).double() * inverse).float()


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v with GQA head folding: query head h reads
    KV head ``h // (Hq // Hkv)``. q (B, Sq, Hq, Dh); k, v (B, Skv, Hkv, Dh).
    With ``causal``, query i (at global position ``q_offset + i``) sees the
    keys at positions <= its own; a masked score is -1e30, as in the JAX
    package. Keys past ``Skv`` do not exist here: a caller's padding is
    sliced off, which is what masking it amounts to. Scores, softmax and the
    value sum run in float32, or float64 for float64 inputs (the card check
    runs it so); the output has q's dtype.
    """
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    group = Hq // Hkv
    kr = k.to(acc).repeat_interleave(group, dim=2)
    vr = v.to(acc).repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), kr) / math.sqrt(Dh)
    if causal:
        qi = torch.arange(Sq, device=q.device) + q_offset
        ki = torch.arange(k.shape[1], device=q.device)
        s = torch.where(qi[:, None] >= ki[None, :], s,
                        torch.tensor(-1e30, dtype=acc, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            dout: torch.Tensor, *, causal: bool = True,
                            q_offset: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradients (dQ, dK, dV) of :func:`flash_attention_ref` given its
    output ``o`` and the output's gradient ``dout``, by the formulas K6's
    backward runs: with S = q k^T / sqrt(Dh) (masked as the forward masks
    it), lse its row logsumexp, P = exp(S - lse) (0 where masked) and D =
    rowsum(dout o o),

        dV = P^T dout,  dS = P o (dout V^T - D),
        dQ = dS K / sqrt(Dh),  dK = dS^T Q / sqrt(Dh),

    a KV head's dK and dV summed over its query heads. In float32, or
    float64 for float64 inputs; each gradient in its input's dtype."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qa, ga = q.to(acc), dout.to(acc)
    kr = k.to(acc).repeat_interleave(group, dim=2)
    vr = v.to(acc).repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qa, kr) * scale
    seen = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        qi = torch.arange(Sq, device=q.device) + q_offset
        seen = qi[:, None] >= torch.arange(k.shape[1], device=q.device)
    s = torch.where(seen, s, torch.tensor(-1e30, dtype=acc, device=q.device))
    p = torch.where(seen, torch.exp(s - torch.logsumexp(s, -1, keepdim=True)),
                    torch.zeros((), dtype=acc, device=q.device))
    dsum = (ga * o.to(acc)).sum(-1).transpose(1, 2)[..., None]   # (B,H,Sq,1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", ga, vr) - dsum)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qa) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, ga)
    Skv = k.shape[1]
    dk = dk.reshape(B, Skv, Hkv, group, Dh).sum(3)
    dv = dv.reshape(B, Skv, Hkv, group, Dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """EmbeddingBag(sum): ``out[b] = sum_l w[b,l] * table[ids[b,l]]``.
    table (V, d), ids (B, L) int32, weights (B, L) or None (all ones).
    Returns (B, d) in the table's dtype: DIN's weighted history pooling.
    Ids are read as the JAX package's ``jnp.take`` reads them: an id in
    [-V, 0) is row id + V, and a bag holding an id outside [-V, V) comes
    out NaN in every column."""
    V = table.shape[0]
    idx = ids.long()
    bad = ((idx < -V) | (idx >= V)).any(dim=1, keepdim=True)     # (B, 1)
    rows = table[idx.clamp(-V, V - 1)]             # (B, L, d); -V.. wraps
    if weights is None:
        out = rows.sum(dim=1)
    else:
        out = torch.einsum("bl,bld->bd", weights.to(table.dtype), rows)
    return out.masked_fill(bad, float("nan"))


def embedding_bag_grad_ref(table: torch.Tensor, ids: torch.Tensor,
                           weights: torch.Tensor, g: torch.Tensor, *,
                           table_grad: bool = True, weights_grad: bool = True
                           ) -> tuple[torch.Tensor | None,
                                      torch.Tensor | None]:
    """The gradient of :func:`embedding_bag_ref` given the output's
    gradient ``g`` (B, d): (dT (V, d), dw (B, L)) in the table's dtype,
    each None where not asked for,

        dT[v] = sum over (b, l) with ids[b,l] = v of w[b,l] * g[b]
        dw[b,l] = <table[ids[b,l]], g[b]>

    dT dense, 0 on the rows no id names. Ids are read as the forward
    reads them: an id in [-V, 0) is row id + V; an id outside [-V, V)
    adds nothing to dT and gets a NaN dw (``jnp.take``'s NaN fill and its
    dropped scatter)."""
    V, d = table.shape
    idx = ids.long()
    idx = torch.where(idx < 0, idx + V, idx)
    inside = (idx >= 0) & (idx < V)
    gt = g.to(table.dtype)
    d_table = d_w = None
    if weights_grad:
        rows = table[idx.clamp(0, V - 1)]                         # (B, L, d)
        d_w = torch.einsum("bld,bd->bl", rows, gt).masked_fill(
            ~inside, float("nan"))
    if table_grad:
        terms = weights.to(table.dtype)[..., None] * gt[:, None, :]
        keep = inside.reshape(-1)
        d_table = torch.zeros((V, d), dtype=table.dtype, device=table.device)
        d_table.index_add_(0, idx.reshape(-1)[keep],
                           terms.reshape(-1, d)[keep])
    return d_table, d_w


_SEGMENT_IDENTITY = {"sum": 0.0, "max": -math.inf, "min": math.inf}


def segment_ranges_ref(values: torch.Tensor, order: torch.Tensor,
                       starts: torch.Tensor, ends: torch.Tensor,
                       op: str) -> torch.Tensor:
    """``out[s] = op over p in [starts[s], ends[s]) of values[order[p]]``,
    the rows taken in p order: (S,) + values.shape[1:] in the values' dtype,
    an empty range giving 0 (sum), -inf (max) or +inf (min). A sum is
    ``index_add_`` over the rows in p order (on the CPU a left fold from
    0); max and min are ``scatter_reduce``."""
    if op not in _SEGMENT_IDENTITY:
        raise ValueError(f"op must be one of {sorted(_SEGMENT_IDENTITY)}, "
                         f"got {op!r}")
    dev = values.device
    S = starts.shape[0]
    lengths = (ends.long() - starts.long()).clamp_min(0)
    seg = torch.repeat_interleave(torch.arange(S, device=dev), lengths)
    first = torch.repeat_interleave(
        starts.long() - (torch.cumsum(lengths, 0) - lengths), lengths)
    pos = torch.arange(seg.shape[0], device=dev) + first
    rows = values[order[pos].long()]
    out = torch.full((S,) + tuple(values.shape[1:]), _SEGMENT_IDENTITY[op],
                     dtype=values.dtype, device=dev)
    if op == "sum":
        return out.index_add_(0, seg, rows)
    idx = seg.view((-1,) + (1,) * (values.dim() - 1)).expand_as(rows)
    return out.scatter_reduce_(0, idx, rows, "amax" if op == "max" else "amin")


def segment_reduce_ref(values: torch.Tensor, order: torch.Tensor,
                       offsets: torch.Tensor, op: str) -> torch.Tensor:
    """The segment reduction of a plan: ``out[s] = op over e in
    order[offsets[s]:offsets[s+1]] of values[e]``, values (E,) or (E, d),
    order (E,) and offsets (S + 1,) integer (``ops.SegmentPlan``). With the
    plan of an index (order its stable sort) this is
    ``jax.ops.segment_<op>(values, index, num_segments=S)``: each segment's
    rows in ascending edge id, an index outside [0, S) in no segment, an
    empty segment 0 (sum), -inf (max) or +inf (min). Returns (S,) +
    values.shape[1:] in the values' dtype (float32 on the path; the card
    check runs it in float64)."""
    return segment_ranges_ref(values, order, offsets[:-1], offsets[1:], op)


def segment_reduce_grad_ref(g_out: torch.Tensor, values: torch.Tensor | None,
                            out: torch.Tensor | None, order: torch.Tensor,
                            offsets: torch.Tensor, op: str) -> torch.Tensor:
    """The gradient of :func:`segment_reduce_ref` with respect to its
    values, given the output's gradient ``g_out`` (S,) + row shape: (E,) +
    row shape in g_out's dtype. An edge e of segment s gets

    * ``sum``: ``g_out[s]``;
    * ``max``/``min``: ``g_out[s] * (1 / ties[s])`` where ``values[e] ==
      out[s]``, else 0, column by column, with ``ties[s]`` the segment's
      edges equal to ``out[s]`` in that column, plus one where ``out[s]`` is
      the op's identity (-inf, +inf): ``jax.grad`` of
      ``jax.ops.segment_max/min``, whose scatter counts its initial value
      among the ties and multiplies by the reciprocal;

    and an edge in no segment (its index outside [0, S)) gets 0. ``values``
    and ``out`` (the forward's output) are read for max and min only. A
    gather ``x[index]``'s gradient is ``segment_reduce_ref(g, plan of
    index, "sum")``."""
    if op not in _SEGMENT_IDENTITY:
        raise ValueError(f"op must be one of {sorted(_SEGMENT_IDENTITY)}, "
                         f"got {op!r}")
    dev = g_out.device
    E, S = order.shape[0], offsets.shape[0] - 1
    lengths = (offsets[1:].long() - offsets[:-1].long()).clamp_min(0)
    seg = torch.repeat_interleave(torch.arange(S, device=dev), lengths)
    rows = order[int(offsets[0]):int(offsets[0]) + seg.shape[0]].long()
    grad = torch.zeros((E,) + tuple(g_out.shape[1:]), dtype=g_out.dtype,
                       device=dev)
    if op == "sum":
        grad[rows] = g_out[seg]
        return grad
    hit = values[rows] == out[seg]
    ties = torch.zeros(out.shape, dtype=torch.int64, device=dev)
    ties.index_add_(0, seg, hit.long())
    ties = ties + (out == _SEGMENT_IDENTITY[op]).long()
    share = g_out * (1.0 / ties.clamp_min(1).to(g_out.dtype))
    grad[rows] = torch.where(hit, share[seg], 0.0)
    return grad
