"""DimeNet, directional message passing (arXiv:2003.03123), the port of
``repro/models/gnn/dimenet.py``: 6 interaction blocks, d_hidden=128,
n_bilinear=8, n_spherical=7, n_radial=6. Messages live on edges; each
block aggregates over (k->j->i) triplets with a spherical-radial basis of
the angle at j.

The host code is the port's own copy of the JAX module's (spherical Bessel
roots by bisection, the triplet builder with its static budget), so that
nothing of the JAX package is imported. ``build_triplets`` is vectorised
with numpy and gives the JAX loop's arrays, in its order. A triplet whose
``idx_ji`` lies outside [0, M) is padding: the triplet sum drops it, as
``segment_sum`` drops an index out of range, and the angle's gather reads
a clamped index, as a JAX gather does.

In training, the two gathers by ``idx_kj`` take its plan over the M edges,
so their gradient is a segment sum; the basis values depend on the
positions alone and enter the parameters' gradient as constants.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..._device import resolve_device
from ..common import ParamTree, dense_init, mlp_apply, mlp_init
from .common import (GraphBatch, gather, masked_edges, mlp_param_count,
                     scatter_sum, segment_plan, tree_from_numpy)

# ---------------------------------------------------------------------------
# spherical Bessel machinery (no scipy)


def _spherical_jn(l: int, x: np.ndarray) -> np.ndarray:
    """j_l(x) by upward recurrence (fine for l <= 7 and x > ~l)."""
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        j0 = np.where(x != 0, np.sin(x) / x, 1.0)
        if l == 0:
            return j0
        j1 = np.where(x != 0, np.sin(x) / x**2 - np.cos(x) / x, 0.0)
        if l == 1:
            return j1
        jm, jc = j0, j1
        for ell in range(1, l):
            jn = (2 * ell + 1) / x * jc - jm
            jm, jc = jc, jn
        return np.where(x != 0, jc, 0.0)


@lru_cache(maxsize=None)
def bessel_roots(n_spherical: int, n_radial: int) -> np.ndarray:
    """First n_radial positive roots of j_l for l = 0..n_spherical-1."""
    roots = np.zeros((n_spherical, n_radial))
    for l in range(n_spherical):
        found: list[float] = []
        lo = 1e-6 + l  # roots of j_l start after ~l
        x = lo
        step = 0.1
        prev = _spherical_jn(l, np.array([x]))[0]
        while len(found) < n_radial:
            x += step
            cur = _spherical_jn(l, np.array([x]))[0]
            if prev * cur < 0:                      # bracketed: bisect
                a, b = x - step, x
                for _ in range(80):
                    mid = 0.5 * (a + b)
                    fm = _spherical_jn(l, np.array([mid]))[0]
                    if fm * _spherical_jn(l, np.array([a]))[0] <= 0:
                        b = mid
                    else:
                        a = mid
                found.append(0.5 * (a + b))
            prev = cur
        roots[l] = found
    return roots


def _legendre(l: int, x: torch.Tensor) -> torch.Tensor:
    """P_l(cos angle) by recurrence (Y_l^0 up to normalisation)."""
    p0 = torch.ones_like(x)
    if l == 0:
        return p0
    p1 = x
    for ell in range(1, l):
        p0, p1 = p1, ((2 * ell + 1) * x * p1 - ell * p0) / (ell + 1)
    return p1


def envelope(u: torch.Tensor, p: int = 6) -> torch.Tensor:
    """Smooth cutoff polynomial (DimeNet eq. 8), zero outside u>=1."""
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    u = torch.clamp_min(u, 1e-2)
    val = 1.0 / u + a * u ** (p - 1) + b * u ** p + c * u ** (p + 1)
    return torch.where(u < 1.0, val, 0.0)


def radial_basis(d: torch.Tensor, cutoff: float,
                 n_radial: int) -> torch.Tensor:
    """DimeNet RBF (canonical form): envelope(u) * sin(n*pi*u), u = d/c.
    envelope ~ 1/u near zero, so the product stays finite (limit n*pi)."""
    n = torch.arange(1, n_radial + 1, dtype=d.dtype, device=d.device)
    u = torch.clamp(d[:, None] / cutoff, 1e-2, 1.0)
    return envelope(u) * torch.sin(n * np.pi * u) * np.sqrt(2.0 / cutoff)


def _jl_jnp(l: int, x: torch.Tensor) -> torch.Tensor:
    # Upward recurrence divides by x each order, unstable and overflowing
    # below x ~ 0.1 for l <= 7. Clamp: j_l(x < 0.1) is O(x^l) ~ 0 anyway,
    # and the envelope already suppresses the tiny-distance regime.
    x = torch.clamp_min(x, 0.1)
    j0 = torch.sin(x) / x
    if l == 0:
        return j0
    j1 = torch.sin(x) / x**2 - torch.cos(x) / x
    if l == 1:
        return j1
    jm, jc = j0, j1
    for ell in range(1, l):
        jm, jc = jc, (2 * ell + 1) / x * jc - jm
    return jc


def spherical_basis(d: torch.Tensor, angle: torch.Tensor, cutoff: float,
                    n_spherical: int, n_radial: int) -> torch.Tensor:
    """a_SBF(d, angle): (T, n_spherical * n_radial)."""
    roots = torch.from_numpy(bessel_roots(n_spherical, n_radial)).to(
        device=d.device, dtype=d.dtype)                  # (L, N)
    u = torch.clamp(d / cutoff, 1e-2, 1.0)
    cos_a = torch.cos(angle)
    out = []
    for l in range(n_spherical):
        jl = _jl_jnp(l, roots[l][None, :] * u[:, None])  # (T, N)
        yl = _legendre(l, cos_a)[:, None]
        out.append(jl * yl)
    return torch.cat(out, dim=-1) * envelope(u)[:, None]


# ---------------------------------------------------------------------------
# triplets


def build_triplets(edge_index: np.ndarray, n: int,
                   max_triplets: int | None = None,
                   seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (idx_kj, idx_ji) pairs: edge k->j feeding edge j->i, k != i.

    Returns int32 arrays of length T (subsampled to the budget, with the
    JAX package's seeded draw, where there are more). The order is the JAX
    loop's: edges j->i ascending, and for each the edges into j ascending.
    """
    src = np.asarray(edge_index[0]).astype(np.int64)
    dst = np.asarray(edge_index[1]).astype(np.int64)
    m = src.size
    by_dst = np.argsort(dst, kind="stable")          # edges into each node
    size = max(int(dst.max(initial=-1)), int(src.max(initial=-1))) + 1
    indeg = np.bincount(dst, minlength=size)
    first = np.zeros(size + 1, np.int64)
    np.cumsum(indeg, out=first[1:])
    counts = indeg[src]                               # edges into j, per e_ji
    ji = np.repeat(np.arange(m, dtype=np.int64), counts)
    rank = np.arange(ji.size, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    kj = by_dst[first[src[ji]] + rank]
    keep = src[kj] != dst[ji]
    kj_a = kj[keep].astype(np.int32)
    ji_a = ji[keep].astype(np.int32)
    if max_triplets is not None and kj_a.size > max_triplets:
        rng = np.random.default_rng(seed)
        sel = rng.choice(kj_a.size, size=max_triplets, replace=False)
        kj_a, ji_a = kj_a[sel], ji_a[sel]
    return kj_a, ji_a


@dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_out: int = 1              # per-graph energy-style target
    dtype: str = "float32"


def init(cfg: DimeNetConfig, generator: torch.Generator,
         device: str | torch.device = "cuda") -> ParamTree:
    dt, dev = getattr(torch, cfg.dtype), resolve_device(device)
    d, nb = cfg.d_hidden, cfg.n_bilinear
    n_sbf = cfg.n_spherical * cfg.n_radial
    g = generator
    blocks = [{
        "w_rbf": dense_init(g, cfg.n_radial, d, dt, dev),
        "w_sbf": dense_init(g, n_sbf, nb, dt, dev),
        "bilinear": (torch.randn((d, nb, d), generator=g, device=g.device)
                     * 0.05).to(device=dev, dtype=dt),
        "upd": mlp_init(g, [2 * d, d, d], dt, device=dev),
    } for _ in range(cfg.n_blocks)]
    return ParamTree({
        "embed_rbf": dense_init(g, cfg.n_radial, d, dt, dev),
        "embed_msg": mlp_init(g, [d, d], dt, device=dev),
        "blocks": blocks,
        "out_rbf": dense_init(g, cfg.n_radial, d, dt, dev),
        "out_mlp": mlp_init(g, [d, d, cfg.n_out], dt, device=dev),
    })


def params_from_numpy(tree: Mapping, cfg: DimeNetConfig,
                      device: str | torch.device = "cuda") -> ParamTree:
    """``repro.models.gnn.dimenet.init``'s pytree as numpy arrays -> the
    port's parameters."""
    return tree_from_numpy(tree, device, getattr(torch, cfg.dtype))


def param_count(cfg: DimeNetConfig) -> int:
    d, nb, R = cfg.d_hidden, cfg.n_bilinear, cfg.n_radial
    block = (R * d + cfg.n_spherical * R * nb + d * nb * d
             + mlp_param_count([2 * d, d, d]))
    return (cfg.n_blocks * block + R * d + mlp_param_count([d, d]) + R * d
            + mlp_param_count([d, d, cfg.n_out]))


def bilinear(m_kj: torch.Tensor, weight: torch.Tensor,
             g_sbf: torch.Tensor) -> torch.Tensor:
    """``einsum("td,dbe,tb->te", m_kj, weight, g_sbf)`` as n_bilinear
    products of (T, d) by (d, d), each scaled by its column of g_sbf and
    added in b order: no (T, n_bilinear, d) tensor."""
    out = None
    for b in range(weight.shape[1]):
        term = (m_kj @ weight[:, b, :]) * g_sbf[:, b:b + 1]
        out = term if out is None else out + term
    return out


def apply(params: ParamTree, cfg: DimeNetConfig, batch: GraphBatch,
          triplets: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Directional message passing over edges; triplets = (idx_kj, idx_ji).
    Returns (num_graphs, n_out) with ``graph_ids``, else (1, n_out)."""
    if batch.positions is None:
        raise ValueError("DimeNet needs positions")
    n = batch.node_feat.shape[0]
    m_edges = batch.edge_index.shape[1]
    src, dst = batch.edge_index[0], batch.edge_index[1]
    pos = batch.positions
    vec = gather(pos, dst) - gather(pos, src)               # (M, 3)
    dist = torch.linalg.norm(vec + 1e-12, dim=-1)
    rbf = radial_basis(dist, cfg.cutoff, cfg.n_radial)      # (M, R)

    idx_kj, idx_ji = triplets
    # angle at j between k->j and j->i
    v1 = -gather(vec, idx_kj)
    v2 = gather(vec, idx_ji.clamp(0, m_edges - 1))
    cos_t = (v1 * v2).sum(-1) / torch.clamp_min(
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1), 1e-9)
    angle = torch.arccos(torch.clamp(cos_t, -1.0, 1.0))
    sbf = spherical_basis(gather(dist, idx_kj), angle, cfg.cutoff,
                          cfg.n_spherical, cfg.n_radial)    # (T, L*R)

    ji_plan = segment_plan(idx_ji, m_edges)     # the triplet sum's plan
    kj_plan = segment_plan(idx_kj, m_edges)     # the gathers' gradient
    _, mdst = masked_edges(batch.edge_index, batch.edge_mask, n)
    dst_plan = segment_plan(mdst, n + 1)
    emask = batch.edge_mask.to(rbf.dtype)[:, None]
    msg = mlp_apply(params["embed_msg"], rbf @ params["embed_rbf"], "silu",
                    final_act=True) * emask                 # (M, d)
    for blk in params["blocks"]:
        g_rbf = rbf @ blk["w_rbf"]                          # (M, d)
        g_sbf = sbf @ blk["w_sbf"]                          # (T, nb)
        m_kj = (gather(msg, idx_kj, kj_plan)
                * gather(g_rbf, idx_kj, kj_plan))          # (T, d)
        inter = bilinear(m_kj, blk["bilinear"], g_sbf)      # (T, d)
        agg = scatter_sum(inter, ji_plan)                   # sum over k
        msg = msg + mlp_apply(blk["upd"], torch.cat([msg, agg], -1),
                              "silu") * emask

    # per-node output: sum incoming messages modulated by rbf
    contrib = msg * (rbf @ params["out_rbf"])
    node_h = scatter_sum(contrib * emask, dst_plan)[:n]
    per_node = mlp_apply(params["out_mlp"], node_h, "silu")  # (N, n_out)
    if batch.graph_ids is not None:
        return scatter_sum(per_node,
                           segment_plan(batch.graph_ids, batch.num_graphs))
    return per_node.sum(dim=0, keepdim=True)


def loss_of(pred: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """MSE against labels of pred's rank, else against zeros."""
    labels = batch.labels
    target = labels if (labels is not None and labels.dim() == pred.dim()) \
        else torch.zeros_like(pred)
    return torch.mean(torch.square((pred - target).float()))


def loss_fn(params: ParamTree, cfg: DimeNetConfig, batch: GraphBatch,
            triplets: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    return loss_of(apply(params, cfg, batch, triplets), batch)
