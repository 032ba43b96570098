"""PNA, Principal Neighbourhood Aggregation (arXiv:2004.05718), the port of
``repro/models/gnn/pna.py``: 4 layers, d_hidden=75, aggregators {mean,
max, min, std}, scalers {identity, amplification, attenuation}. Each
layer:

    m_ij   = M(h_i, h_j)                        (pre-MLP on messages)
    agg    = [mean|max|min|std]_j m_ij          (4 aggregators)
    scaled = [1, log(d+1)/δ, δ/log(d+1)] ⊗ agg  (3 scalers -> 12 channels)
    h_i'   = U(h_i, scaled)                     (post-MLP + residual)

δ is the mean log-degree of the training graph (a config constant here).
Masked edges go to a trash node n, the four aggregators reduce over n + 1
segments through one shared plan, and the trash row is cut off, as in the
JAX package. In training, the gathers ``h[src]`` and ``h[dst]`` take the
plans of the masked sources and destinations (a masked edge's message is
multiplied by 0, so its rows carry zero gradient), and the std's clamp
passes half the gradient at exactly 0, as ``jnp.maximum`` does.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch

from ..._device import resolve_device
from ..common import ParamTree, mlp_apply, mlp_init
from .common import (GraphBatch, gather, in_degree, masked_edges,
                     mlp_param_count, scatter_max, scatter_mean, scatter_min,
                     segment_plan, tree_from_numpy)
from .gcn import loss_of


@dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 1433
    n_classes: int = 7
    delta: float = 2.5           # mean log-degree normaliser
    dtype: str = "float32"

    @property
    def n_channels(self) -> int:
        return 4 * 3             # aggregators x scalers


def _mlp_dims(cfg: PNAConfig) -> dict[str, list[int]]:
    d = cfg.d_hidden
    return {"msg": [2 * d, d], "upd": [d + cfg.n_channels * d, d],
            "encoder": [cfg.d_in, d], "decoder": [d, cfg.n_classes]}


def init(cfg: PNAConfig, generator: torch.Generator,
         device: str | torch.device = "cuda") -> ParamTree:
    dt, dev = getattr(torch, cfg.dtype), resolve_device(device)
    dims = _mlp_dims(cfg)
    layers = [{"msg": mlp_init(generator, dims["msg"], dt, device=dev),
               "upd": mlp_init(generator, dims["upd"], dt, device=dev)}
              for _ in range(cfg.n_layers)]
    return ParamTree({
        "encoder": mlp_init(generator, dims["encoder"], dt, device=dev),
        "layers": layers,
        "decoder": mlp_init(generator, dims["decoder"], dt, device=dev)})


def params_from_numpy(tree: Mapping, cfg: PNAConfig,
                      device: str | torch.device = "cuda") -> ParamTree:
    """``repro.models.gnn.pna.init``'s pytree as numpy arrays -> the port's
    parameters."""
    return tree_from_numpy(tree, device, getattr(torch, cfg.dtype))


def param_count(cfg: PNAConfig) -> int:
    dims = _mlp_dims(cfg)
    return (cfg.n_layers * (mlp_param_count(dims["msg"])
                            + mlp_param_count(dims["upd"]))
            + mlp_param_count(dims["encoder"])
            + mlp_param_count(dims["decoder"]))


def apply(params: ParamTree, cfg: PNAConfig,
          batch: GraphBatch) -> torch.Tensor:
    n = batch.node_feat.shape[0]
    src, dst = batch.edge_index[0], batch.edge_index[1]
    emask = batch.edge_mask.to(batch.node_feat.dtype)[:, None]
    valid = batch.edge_mask[:, None]
    h = mlp_apply(params["encoder"], batch.node_feat, "relu", final_act=True)

    msrc, mdst = masked_edges(batch.edge_index, batch.edge_mask, n)
    plan = segment_plan(mdst, n + 1)        # all four aggregators' plan
    src_plan = segment_plan(msrc, n + 1)    # the h[src] gather's gradient
    log_deg = torch.log1p(in_degree(plan, n))[:, None]
    amp = log_deg / cfg.delta
    att = cfg.delta / torch.clamp_min(log_deg, 1e-2)
    neg = torch.finfo(h.dtype).min

    for layer in params["layers"]:
        m = mlp_apply(layer["msg"],
                      torch.cat([gather(h, src, src_plan),
                                 gather(h, dst, plan)], -1),
                      "relu", final_act=True) * emask
        # masked aggregations (trash-node trick for max/min neutrality)
        mean_a = scatter_mean(m, plan)[:n]
        sum_sq = scatter_mean(m * m, plan)[:n]
        # jnp.maximum(x, 0.) (repro/models/gnn/pna.py:78) passes half the
        # gradient at x == 0 and clamp_min all of it; 0.5 (x + |x|) has
        # clamp_min's bits and JAX's gradient
        var = sum_sq - mean_a * mean_a
        std_a = torch.sqrt(0.5 * (var + torch.abs(var)) + 1e-5)
        max_a = scatter_max(torch.where(valid, m, neg), plan)[:n]
        max_a = torch.where(torch.isfinite(max_a), max_a, 0.0)
        min_a = scatter_min(torch.where(valid, m, -neg), plan)[:n]
        min_a = torch.where(torch.isfinite(min_a), min_a, 0.0)
        aggs = torch.cat([mean_a, max_a, min_a, std_a], dim=-1)  # (N, 4d)
        scaled = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)
        h = h + mlp_apply(layer["upd"], torch.cat([h, scaled], -1), "relu")
    return mlp_apply(params["decoder"], h, "relu")


def loss_fn(params: ParamTree, cfg: PNAConfig,
            batch: GraphBatch) -> torch.Tensor:
    return loss_of(apply(params, cfg, batch), batch)
