"""GCN (Kipf & Welling, arXiv:1609.02907), the port of
``repro/models/gnn/gcn.py``: the gcn-cora config, 2 layers, d=16,
symmetric normalisation, the neighbour sum through ``ops.segment_reduce``.

``apply`` and ``loss_fn`` are the forward half of the JAX package's train
step. Its ``loss_fn_owner_computes`` (a ``shard_map`` over a ``data``
mesh) is not ported: the port has no data mesh yet.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..._device import resolve_device
from ..common import ParamTree, mlp_init
from .common import (GraphBatch, gather, masked_edges, mlp_param_count,
                     scatter_sum, segment_plan, sym_norm_coeff,
                     tree_from_numpy)


@dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 1433
    n_classes: int = 7
    dropout: float = 0.5       # applied only in a train step with rng
    dtype: str = "float32"

    @property
    def dims(self) -> list[int]:
        return ([self.d_in] + [self.d_hidden] * (self.n_layers - 1)
                + [self.n_classes])


def init(cfg: GCNConfig, generator: torch.Generator,
         device: str | torch.device = "cuda") -> ParamTree:
    """{"layers": MLP} of ``dense_init`` weights and zero biases."""
    return ParamTree({"layers": mlp_init(generator, cfg.dims,
                                         getattr(torch, cfg.dtype),
                                         device=resolve_device(device))})


def params_from_numpy(tree: Mapping, cfg: GCNConfig,
                      device: str | torch.device = "cuda") -> ParamTree:
    """``repro.models.gnn.gcn.init``'s pytree as numpy arrays -> the port's
    parameters (its list of {"w", "b"} layers becomes an MLP)."""
    return tree_from_numpy(tree, device, getattr(torch, cfg.dtype))


def param_count(cfg: GCNConfig) -> int:
    return mlp_param_count(cfg.dims)


def apply(params: ParamTree, cfg: GCNConfig,
          batch: GraphBatch) -> torch.Tensor:
    """(N, n_classes) logits. The neighbour sum of a layer is one segment
    reduction over the masked destinations' plan (n + 1 segments, the
    trash row cut off: a masked edge has weight 0, so this is the JAX
    package's sum over ``dst``); the degrees are the plans' counts."""
    n = batch.node_feat.shape[0]
    src = batch.edge_index[0]
    msrc, mdst = masked_edges(batch.edge_index, batch.edge_mask, n)
    dst_plan = segment_plan(mdst, n + 1)
    src_plan = segment_plan(msrc, n + 1)
    coeff = sym_norm_coeff(batch.edge_index, batch.edge_mask, n, dst_plan,
                           src_plan)[:, None]
    layers = params["layers"]
    h = batch.node_feat
    last = len(layers.weights) - 1
    for i, (w, b) in enumerate(zip(layers.weights, layers.biases)):
        h = h @ w + b                          # XW first (d_in -> d_hidden)
        msg = gather(h, src) * coeff
        h = scatter_sum(msg, dst_plan)[:n] + h  # A_norm + I (self loop)
        if i < last:
            h = F.relu(h)
    return h


def loss_of(logits: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Masked mean negative log-likelihood of the labels, in float32."""
    mask = batch.node_mask.to(torch.float32)
    logp = F.log_softmax(logits.float(), dim=-1)
    labels = batch.labels.long().clamp_min(0)[:, None]
    nll = -torch.gather(logp, 1, labels)[:, 0]
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def loss_fn(params: ParamTree, cfg: GCNConfig,
            batch: GraphBatch) -> torch.Tensor:
    return loss_of(apply(params, cfg, batch), batch)
