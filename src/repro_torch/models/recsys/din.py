"""DIN, Deep Interest Network (arXiv:1706.06978), for serving and training:
the port of ``repro/models/recsys/din.py``.

Embedding dim 18, user history of 100 items, attention MLP 80-40, main MLP
200-80, target attention. Each history item is an (item, category) pair
whose embedding is the two rows concatenated. The interest vector is the
history's embeddings weighted by the attention MLP (no softmax, as in the
paper) and summed: a weighted embedding bag, which K5 computes on the card
through ``kernels.ops.embedding_bag``, one bag over the item table and one
over the category table.

Batch layout (tensors on one device):
    hist_items (B, L) int32 | hist_cats (B, L) | hist_mask (B, L) bool |
    target_item (B,) | target_cat (B,) | label (B,) float (training)

Serving entry points: ``score`` (pointwise CTR) and ``score_candidates``
(one user against N candidates, in blocks of candidates: batched work, no
loop over candidates). Training: ``loss_fn`` (BCE with logits, mean over
the batch), differentiable in every parameter, the two tables included,
once the module is made trainable (``requires_grad_``). Its gathers are
``ops.gather_rows`` and its pooling ``ops.embedding_bag`` over the plans
of the batch's ids (:func:`batch_plans`, one a id tensor), so that on the
card every gradient into a table is a fixed-order fold by id
(``segment_reduce`` and K5's backward), never a float scatter. Training
takes ids in [0, n_items) and [0, n_cats).

Parameters are a :class:`DIN` module: ``item_emb`` (n_items, d),
``cat_emb`` (n_cats, d) and the two MLPs as
:class:`~repro_torch.models.common.MLP`. :func:`params_from_numpy` loads
the JAX ``init`` pytree into it.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch
from torch import nn

from ..._device import resolve_device
from ...kernels import ops
from ..common import MLP, act_fn, embed_init, mlp_init, tensor_from_numpy


@dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 1_000_000
    n_cats: int = 10_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple[int, ...] = (80, 40)
    mlp: tuple[int, ...] = (200, 80)
    dtype: str = "float32"

    @property
    def d_pair(self) -> int:
        return 2 * self.embed_dim       # item ++ category


class DIN(nn.Module):
    """DIN's parameters on one device: the two embedding tables and the
    attention and main MLPs, frozen until ``requires_grad_(True)`` (the
    train step's)."""

    def __init__(self, item_emb: torch.Tensor, cat_emb: torch.Tensor,
                 attn: MLP, mlp: MLP):
        super().__init__()
        self.item_emb = nn.Parameter(item_emb, requires_grad=False)
        self.cat_emb = nn.Parameter(cat_emb, requires_grad=False)
        self.attn = attn
        self.mlp = mlp


def init(cfg: DINConfig, generator: torch.Generator,
         device: str | torch.device = "cuda") -> DIN:
    """Random parameters: the JAX package's initialisers, drawn from
    ``generator`` (not its values: the generators differ)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_pair
    # attention MLP input: [hist, target, hist - target, hist * target]
    return DIN(embed_init(generator, cfg.n_items, cfg.embed_dim, dt, dev),
               embed_init(generator, cfg.n_cats, cfg.embed_dim, dt, dev),
               mlp_init(generator, [4 * d, *cfg.attn_mlp, 1], dt, device=dev),
               mlp_init(generator, [3 * d, *cfg.mlp, 1], dt, device=dev))


def params_from_numpy(tree: Mapping, cfg: DINConfig,
                      device: str | torch.device = "cuda") -> DIN:
    """``repro.models.recsys.din.init``'s pytree as numpy arrays -> a
    :class:`DIN` on ``device`` (the MLPs' lists of {"w", "b"} become
    :class:`~repro_torch.models.common.MLP` modules)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)

    def mlp(layers) -> MLP:
        return MLP([tensor_from_numpy(layer["w"], dev, dt)
                    for layer in layers],
                   [tensor_from_numpy(layer["b"], dev, dt)
                    for layer in layers])

    return DIN(tensor_from_numpy(tree["item_emb"], dev, dt),
               tensor_from_numpy(tree["cat_emb"], dev, dt),
               mlp(tree["attn"]), mlp(tree["mlp"]))


@dataclass(frozen=True)
class BatchPlans:
    """The segment plans of one batch's ids (``ops.segment_plan`` of each
    id tensor, flattened, over its table's rows; ``ops.bag_plan`` of the
    histories, the pooling's bags), built once a batch: the gathers'
    backwards and K5's backward fold the tables' gradients over them. The
    history plans serve both the history gather and the pooling."""

    hist_items: ops.SegmentPlan
    hist_cats: ops.SegmentPlan
    target_item: ops.SegmentPlan
    target_cat: ops.SegmentPlan


def batch_plans(cfg: DINConfig, batch: dict) -> BatchPlans:
    """The :class:`BatchPlans` of ``batch`` (ids in [0, n_items) and
    [0, n_cats)), on the ids' device, with no host sync."""
    def plan(key: str, rows: int) -> ops.SegmentPlan:
        return ops.segment_plan(batch[key].reshape(-1), rows,
                                keep_index=False)

    return BatchPlans(ops.bag_plan(batch["hist_items"], cfg.n_items),
                      ops.bag_plan(batch["hist_cats"], cfg.n_cats),
                      plan("target_item", cfg.n_items),
                      plan("target_cat", cfg.n_cats))


def _pair_embed(params: DIN, items: torch.Tensor, cats: torch.Tensor,
                plans: tuple[ops.SegmentPlan, ops.SegmentPlan] | None = None
                ) -> torch.Tensor:
    """(...) ids -> (..., 2 * embed_dim). With the plans of (items, cats)
    the rows come through ``ops.gather_rows``, whose gradient is a segment
    sum over the plan; without, by indexing (serving)."""
    if plans is None:
        return torch.cat([params.item_emb[items.long()],
                          params.cat_emb[cats.long()]], dim=-1)
    shape = tuple(items.shape)
    item_e = ops.gather_rows(params.item_emb, items.reshape(-1), plans[0])
    cat_e = ops.gather_rows(params.cat_emb, cats.reshape(-1), plans[1])
    return torch.cat([item_e, cat_e], dim=-1).reshape(shape + (-1,))


def _pool(params: DIN, w: torch.Tensor, items: torch.Tensor,
          cats: torch.Tensor,
          plans: tuple[ops.SegmentPlan, ops.SegmentPlan] | None = None
          ) -> torch.Tensor:
    """sum_l w[b,l] * pair_embed(items[b,l], cats[b,l]): the two halves of
    the pair embedding pooled separately (K5 twice), then joined. ids may
    be a broadcast view (row stride 0). ``plans``: of (items, cats), for
    the tables' gradients."""
    item_plan, cat_plan = plans if plans is not None else (None, None)
    return torch.cat([ops.embedding_bag(params.item_emb, items, w,
                                        plan=item_plan),
                      ops.embedding_bag(params.cat_emb, cats, w,
                                        plan=cat_plan)], dim=-1)


def _interest(params: DIN, hist_e: torch.Tensor, hist_mask: torch.Tensor,
              target_e: torch.Tensor, hist_items: torch.Tensor,
              hist_cats: torch.Tensor,
              plans: tuple[ops.SegmentPlan, ops.SegmentPlan] | None = None
              ) -> torch.Tensor:
    """DIN target attention: weights from the attention MLP, no softmax
    (paper §4.3 keeps raw weights to preserve interest intensity), then the
    weighted bag sum over the history. hist_e (B, L, d) is the gathered
    history, which the MLP's features need; the sum gathers its rows
    again inside K5 from ``hist_items``/``hist_cats`` (B, L)."""
    t = target_e[..., None, :].expand(hist_e.shape)
    feats = torch.cat([hist_e, t, hist_e - t, hist_e * t], dim=-1)
    w = params.attn(feats, "sigmoid")[..., 0]                     # (B, L)
    w = w * hist_mask.to(w.dtype)
    return _pool(params, w, hist_items, hist_cats, plans)


def _logits(params: DIN, batch: dict,
            plans: BatchPlans | None = None) -> torch.Tensor:
    """Pointwise CTR logits (B,), under autograd where it is on."""
    hp = None if plans is None else (plans.hist_items, plans.hist_cats)
    tp = None if plans is None else (plans.target_item, plans.target_cat)
    hist_e = _pair_embed(params, batch["hist_items"], batch["hist_cats"], hp)
    target_e = _pair_embed(params, batch["target_item"], batch["target_cat"],
                           tp)
    interest = _interest(params, hist_e, batch["hist_mask"], target_e,
                         batch["hist_items"], batch["hist_cats"], hp)
    feats = torch.cat([interest, target_e, interest * target_e], dim=-1)
    return params.mlp(feats, "sigmoid")[..., 0]


@torch.no_grad()
def score(params: DIN, cfg: DINConfig, batch: dict) -> torch.Tensor:
    """Pointwise CTR logits (B,)."""
    return _logits(params, batch)


def loss_fn(params: DIN, cfg: DINConfig, batch: dict,
            plans: BatchPlans | None = None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch["label"]``,
    in the JAX package's stable form max(z, 0) - z y + log1p(exp(-|z|)).
    Where a table needs a gradient, the batch's plans (``plans``, or
    :func:`batch_plans` built here) carry its gathers and pooling."""
    if plans is None and torch.is_grad_enabled() and (
            params.item_emb.requires_grad or params.cat_emb.requires_grad):
        plans = batch_plans(cfg, batch)
    return bce_with_logits(_logits(params, batch, plans), batch["label"])


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean of max(z, 0) - z y + log1p(exp(-|z|)) in float32."""
    z = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return (torch.clamp_min(z, 0) - z * y
            + torch.log1p(torch.exp(-z.abs()))).mean()


def _interest_factored(params: DIN, hist_e: torch.Tensor,
                       hist_mask: torch.Tensor, t_e: torch.Tensor,
                       hist_items: torch.Tensor,
                       hist_cats: torch.Tensor) -> torch.Tensor:
    """The attention MLP's first layer split by its input blocks,
    W1 = [Wh; Wt; Wd; Wp], so that

        z = h @ (Wh + Wd) + t @ (Wt - Wd) + (h * t) @ Wp + b1

    where h @ (Wh + Wd) is computed once per history and t @ (Wt - Wd) once
    per candidate; only the bilinear term is per (candidate, item). Equal
    to :func:`_interest`. hist_e (L, d); t_e (blk, d); hist_items and
    hist_cats (L,). Returns (blk, d)."""
    act = act_fn("sigmoid")
    mlp = params.attn
    d = hist_e.shape[-1]
    W1, b1 = mlp.weights[0], mlp.biases[0]
    Wh, Wt, Wd, Wp = W1[:d], W1[d:2 * d], W1[2 * d:3 * d], W1[3 * d:]
    A = hist_e @ (Wh + Wd)                        # (L, H1) once per history
    Tt = t_e @ (Wt - Wd)                          # (blk, H1) once per cand
    P = torch.einsum("bd,ldh->blh", t_e,
                     torch.einsum("ld,dh->ldh", hist_e, Wp))
    z = act(A[None] + Tt[:, None] + P + b1)       # (blk, L, H1)
    n = len(mlp.weights)
    for i in range(1, n - 1):
        z = act(z @ mlp.weights[i] + mlp.biases[i])
    w = (z @ mlp.weights[-1] + mlp.biases[-1])[..., 0]          # (blk, L)
    w = w * hist_mask.to(w.dtype)[None]
    blk, L = w.shape
    return _pool(params, w, hist_items[None].expand(blk, L),
                 hist_cats[None].expand(blk, L))


@torch.no_grad()
def score_candidates(params: DIN, cfg: DINConfig, batch: dict, *,
                     block: int = 8192, factored: bool = False
                     ) -> torch.Tensor:
    """One user against N candidates. batch: hist_items, hist_cats,
    hist_mask (1, L); cand_items, cand_cats (N,). Scores candidates in
    blocks of ``block`` (the last one padded with id 0, as the JAX package
    pads); ``factored=True`` uses :func:`_interest_factored`. Returns
    (N,)."""
    hist_items = batch["hist_items"][0]
    hist_cats = batch["hist_cats"][0]
    hist_mask = batch["hist_mask"][0]
    hist_e = _pair_embed(params, hist_items, hist_cats)        # (L, d)
    cand_items, cand_cats = batch["cand_items"], batch["cand_cats"]
    n = cand_items.shape[0]
    L = hist_items.shape[0]
    nblk = -(-n // block)
    pad = nblk * block - n
    ci = torch.nn.functional.pad(cand_items, (0, pad))
    cc = torch.nn.functional.pad(cand_cats, (0, pad))
    out = torch.empty(nblk * block, dtype=hist_e.dtype, device=hist_e.device)
    for i in range(nblk):
        items = ci[i * block:(i + 1) * block]
        cats = cc[i * block:(i + 1) * block]
        t_e = _pair_embed(params, items, cats)                 # (blk, d)
        if factored:
            interest = _interest_factored(params, hist_e, hist_mask, t_e,
                                          hist_items, hist_cats)
        else:
            he = hist_e[None].expand((block,) + hist_e.shape)
            interest = _interest(params, he, hist_mask[None], t_e,
                                 hist_items[None].expand(block, L),
                                 hist_cats[None].expand(block, L))
        feats = torch.cat([interest, t_e, interest * t_e], dim=-1)
        out[i * block:(i + 1) * block] = \
            params.mlp(feats, "sigmoid")[..., 0]
    return out[:n]
