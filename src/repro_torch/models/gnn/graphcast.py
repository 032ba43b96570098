"""GraphCast-style encode-process-decode mesh GNN (arXiv:2212.12794), the
port of ``repro/models/gnn/graphcast.py``: 16 processor layers,
d_hidden=512, sum aggregation, n_vars=227 outputs. The batch's
edge_index is the mesh (the JAX package's DESIGN.md §6).

Each processor block is an interaction network with residuals:

    e' = e + MLP_e([e, h_src, h_dst])
    h' = h + MLP_h([h, sum_j e'_j->i])

with a LayerNorm after every MLP. The sum is one ``ops.segment_reduce``
a block over the masked destinations' plan (n + 1 segments, built once).

In training, the gathers ``h[src]`` and ``h[dst]`` take the plans of the
masked sources and destinations (a masked edge's update is multiplied by
0, so its rows carry zero gradient), and each processor block is
recomputed in the backward (``torch.utils.checkpoint``) instead of
keeping its activations: about 5-6 GB a block on minibatch_lg, 16 blocks
of which do not fit one 80 GB card. The recompute runs the same
deterministic kernels, so it changes no number.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from ..._device import resolve_device
from ..common import ParamTree, layer_norm, mlp_apply, mlp_init
from .common import (GraphBatch, gather, masked_edges, mlp_param_count,
                     scatter_sum, segment_plan, tree_from_numpy)


@dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    d_in: int = 227            # n_vars
    d_edge_in: int = 4         # displacement features (or zeros if absent)
    n_out: int = 227
    mesh_refinement: int = 6   # provenance metadata
    dtype: str = "float32"


def _mlp_ln_dims(cfg: GraphCastConfig) -> dict[str, list[int]]:
    d = cfg.d_hidden
    return {"edge": [3 * d, d, d], "node": [2 * d, d, d],
            "node_enc": [cfg.d_in, d, d], "edge_enc": [cfg.d_edge_in, d, d]}


def _mlp_ln_init(generator, dims, dt, dev) -> dict:
    return {"mlp": mlp_init(generator, dims, dt, device=dev),
            "ln_w": torch.ones(dims[-1], dtype=dt, device=dev),
            "ln_b": torch.zeros(dims[-1], dtype=dt, device=dev)}


def _mlp_ln(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    y = mlp_apply(p["mlp"], x, act)
    return layer_norm(y, p["ln_w"], p["ln_b"])


def init(cfg: GraphCastConfig, generator: torch.Generator,
         device: str | torch.device = "cuda") -> ParamTree:
    dt, dev = getattr(torch, cfg.dtype), resolve_device(device)
    dims = _mlp_ln_dims(cfg)
    layers = [{"edge": _mlp_ln_init(generator, dims["edge"], dt, dev),
               "node": _mlp_ln_init(generator, dims["node"], dt, dev)}
              for _ in range(cfg.n_layers)]
    return ParamTree({
        "node_enc": _mlp_ln_init(generator, dims["node_enc"], dt, dev),
        "edge_enc": _mlp_ln_init(generator, dims["edge_enc"], dt, dev),
        "layers": layers,
        "decoder": mlp_init(generator, [cfg.d_hidden, cfg.d_hidden,
                                        cfg.n_out], dt, device=dev)})


def params_from_numpy(tree: Mapping, cfg: GraphCastConfig,
                      device: str | torch.device = "cuda") -> ParamTree:
    """``repro.models.gnn.graphcast.init``'s pytree as numpy arrays -> the
    port's parameters."""
    return tree_from_numpy(tree, device, getattr(torch, cfg.dtype))


def param_count(cfg: GraphCastConfig) -> int:
    dims = _mlp_ln_dims(cfg)
    d = cfg.d_hidden
    ln = 2 * d
    return (cfg.n_layers * (mlp_param_count(dims["edge"])
                            + mlp_param_count(dims["node"]) + 2 * ln)
            + mlp_param_count(dims["node_enc"])
            + mlp_param_count(dims["edge_enc"]) + 2 * ln
            + mlp_param_count([d, d, cfg.n_out]))


def apply(params: ParamTree, cfg: GraphCastConfig,
          batch: GraphBatch) -> torch.Tensor:
    n = batch.node_feat.shape[0]
    m = batch.edge_index.shape[1]
    src, dst = batch.edge_index[0], batch.edge_index[1]
    emask = batch.edge_mask.to(batch.node_feat.dtype)[:, None]

    h = _mlp_ln(params["node_enc"], batch.node_feat)
    if batch.edge_feat is not None:
        ef = batch.edge_feat
    else:
        ef = torch.zeros((m, cfg.d_edge_in), dtype=batch.node_feat.dtype,
                         device=batch.node_feat.device)
    e = _mlp_ln(params["edge_enc"], ef)
    msrc, mdst = masked_edges(batch.edge_index, batch.edge_mask, n)
    plan = segment_plan(mdst, n + 1)
    src_plan = segment_plan(msrc, n + 1)

    def block(layer, e, h):
        e_in = torch.cat([e, gather(h, src, src_plan), gather(h, dst, plan)],
                         dim=-1)
        e = e + _mlp_ln(layer["edge"], e_in) * emask
        agg = scatter_sum(e * emask, plan)[:n]
        return e, h + _mlp_ln(layer["node"], torch.cat([h, agg], -1))

    remat = torch.is_grad_enabled() and h.requires_grad
    for layer in params["layers"]:
        if remat:
            e, h = checkpoint(block, layer, e, h, use_reentrant=False,
                              preserve_rng_state=False)    # draws nothing
        else:
            e, h = block(layer, e, h)
    return mlp_apply(params["decoder"], h, "silu")      # (N, n_vars)


def loss_of(pred: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """MSE against labels when they are (N, n_out), else against zeros."""
    labels = batch.labels
    target = labels if (labels is not None and labels.dim() == 2) \
        else torch.zeros_like(pred)
    mask = batch.node_mask.to(torch.float32)[:, None]
    err = torch.square((pred - target).float()) * mask
    return err.sum() / torch.clamp_min(mask.sum() * pred.shape[-1], 1.0)


def loss_fn(params: ParamTree, cfg: GraphCastConfig,
            batch: GraphBatch) -> torch.Tensor:
    return loss_of(apply(params, cfg, batch), batch)
