"""Architecture definitions and their shape cells, for the serving kinds
and the GNNs' and DIN's training: the port of ``repro/configs/base.py``.

Each architecture registers an ``ArchDef`` that can, for each shape cell
of a serving kind (``prefill``, ``decode``, ``serve``, ``retrieval``):

* build the step function (``build_step``);
* make concrete, seeded inputs of the cell's shapes on a device
  (``make_inputs``, the counterpart of the JAX package's abstract inputs:
  the port has no dry-run), cut in batch, sequence or candidates where the
  caller asks;
* run its reduced smoke configuration end to end (``infer_run``, the
  inference half of the JAX package's ``smoke_run``);
* count a cell's useful operations and bytes (``model_flops``,
  ``model_bytes``: the JAX package's accounting, for the serving kinds),
  which give a step's least time on a card.

The GNN family's cells are of the train kind: ``GNNArch.build_step``
returns the JAX package's train step (the loss's gradient under autograd,
then AdamW), and ``GNNArch.forward_step`` its forward half; DIN's
``train_batch`` cell the same through ``DINArch.build_step``, and the
LMs' ``train_4k``, dense and MoE, through ``LMArch.build_step`` (with
the reference's ``grad_accum`` micro-batches and per-layer remat).
Meshes and partition specs come with later slices.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..data import RecsysStream, TokenStream, minibatch_stream
from ..models import dimenet, gcn, graphcast, pna, transformer
from ..models.gnn.common import GraphBatch, random_graph_batch
from ..models.common import tree_leaves
from ..models.recsys import din
from ..optim import AdamWConfig, adamw_update, global_norm
from ..ppr.datasets import load
from ..ppr.graph import Graph

# the JAX package's attention key block (LMConfig.attn_block_kv), which its
# prefill byte count re-reads the keys and values by
_JAX_ATTN_BLOCK_KV = 1024

LM_SHAPES: dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1),
}

DIN_SHAPES: dict[str, dict] = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, candidates=1_000_000),
}


def _cut(shape: dict, cuts: dict[str, int], allowed: tuple[str, ...]
         ) -> dict:
    bad = set(cuts) - set(allowed)
    if bad:
        raise ValueError(f"cannot cut {sorted(bad)}; cuts are {allowed}")
    return {**shape, **{k: int(v) for k, v in cuts.items()}}


def _randint(generator: torch.Generator, high: int, shape: tuple[int, ...],
             device: torch.device) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=generator,
                         device=generator.device,
                         dtype=torch.int32).to(device)


class ArchDef:
    arch_id: str = ""
    shapes: dict[str, dict] = {}

    def kind(self, shape_id: str) -> str:
        return self.shapes[shape_id]["kind"]

    def config(self, smoke: bool = False) -> Any:
        return self.smoke_cfg if smoke else self.cfg

    def init_params(self, generator: torch.Generator,
                    device: str | torch.device = "cuda",
                    smoke: bool = False) -> Any:
        raise NotImplementedError

    def build_step(self, shape_id: str, *, smoke: bool = False,
                   **options: Any) -> Callable:
        """Step function (params, batch) -> outputs of a serving kind."""
        raise NotImplementedError

    def make_inputs(self, shape_id: str, generator: torch.Generator,
                    device: str | torch.device = "cuda", *,
                    smoke: bool = False, **cuts: int) -> dict[str, Any]:
        raise NotImplementedError

    def infer_run(self, generator: torch.Generator,
                  device: str | torch.device = "cuda") -> dict[str, float]:
        """The smoke configuration's serving steps with real tensors;
        returns finite scalars."""
        raise NotImplementedError

    def model_flops(self, shape_id: str, **cuts: int) -> float:
        """Useful operations of one step of the cell (cut as
        ``make_inputs`` cuts it), as the JAX package counts them."""
        raise NotImplementedError

    def model_bytes(self, shape_id: str, **cuts: int) -> float:
        """Bytes one step of the cell moves, as the JAX package counts
        them."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# LM family


class LMArch(ArchDef):
    shapes = LM_SHAPES

    def __init__(self, arch_id: str, cfg: transformer.LMConfig,
                 smoke_cfg: transformer.LMConfig,
                 opt: AdamWConfig = AdamWConfig(), grad_accum: int = 1):
        self.arch_id = arch_id
        self.cfg = cfg
        self.smoke_cfg = smoke_cfg
        self.opt = opt
        # micro-batches a train step sums its gradients over, in order:
        # peak activation memory divides by it (the reference's HBM-fit
        # lever), for one gradient-sized accumulator
        self.grad_accum = grad_accum

    def init_params(self, generator, device="cuda", smoke=False):
        return transformer.init(self.config(smoke), generator, device)

    def build_step(self, shape_id, *, smoke=False, **options):
        """Serving kinds: prefill(params, batch) -> (last logits, cache),
        decode(params, batch) -> (logits, cache). The train kind:
        train_step(params, opt_state, batch) -> (params, opt_state, loss),
        the JAX package's: ``grad_accum`` micro-batches of the batch's
        tokens and labels (``transformer.value_and_grad`` each, each layer
        recomputed in the backward where ``cfg.remat``), their gradients
        and losses summed in order and divided by ``grad_accum``, then
        :func:`~repro_torch.optim.adamw_update` with the arch's ``opt``,
        which writes the new parameters and moments into the ones given.
        An MoE LM's loss adds its routers' aux loss times
        ``router_aux_weight``, as the reference's does."""
        cfg = self.config(smoke)
        kind = self.kind(shape_id)
        if options:
            raise ValueError(f"no options for {kind}: {sorted(options)}")
        if kind == "train":
            opt, accum = self.opt, self.grad_accum
            if accum < 1:
                raise ValueError(f"grad_accum must be >= 1, got {accum}")

            def train_step(params, opt_state, batch):
                tokens, labels = batch["tokens"], batch["labels"]
                B = tokens.shape[0]
                if B % accum:
                    raise ValueError(f"batch {B} is not a multiple of "
                                     f"grad_accum {accum}")
                mb = B // accum
                loss, grads = transformer.value_and_grad(
                    params, cfg, tokens[:mb], labels[:mb])
                if accum > 1:
                    total = torch.zeros((), dtype=torch.float32,
                                        device=loss.device) + loss
                    for i in range(1, accum):
                        part = slice(i * mb, (i + 1) * mb)
                        loss_i, grads_i = transformer.value_and_grad(
                            params, cfg, tokens[part], labels[part])
                        for g, g_i in zip(grads, grads_i):
                            g.add_(g_i)
                        total = total + loss_i
                        del grads_i
                    grads = tuple(g / accum for g in grads)
                    loss = total / accum
                params, opt_state, _ = adamw_update(opt, params, grads,
                                                    opt_state)
                return params, opt_state, loss
            return train_step
        if kind == "prefill":
            def prefill(params, batch):
                return transformer.prefill_step(params, cfg, batch["tokens"])
            return prefill

        def decode(params, batch):
            return transformer.decode_step(params, cfg, batch["token"],
                                           batch["kv_cache"],
                                           batch["cache_len"])
        return decode

    def make_inputs(self, shape_id, generator, device="cuda", *, smoke=False,
                    seed: int | None = None, **cuts):
        """prefill: tokens (B, S). decode: one token (B, 1) against an
        S-long cache of random keys and values, written at the last slot
        (``cache_len = S - 1``). train: tokens and labels (B, S), the first
        batch of the JAX package's token stream (``TokenStream``: Zipf(1.2)
        tokens with EOS sprinkled, labels the next token) of seed ``seed``
        (None: drawn from ``generator``). Cuts: ``batch``, ``seq``."""
        s = _cut(self.shapes[shape_id], cuts, ("batch", "seq"))
        cfg = self.config(smoke)
        dev = resolve_device(device)
        B, S = s["batch"], s["seq"]
        if s["kind"] == "train":
            if seed is None:
                seed = int(torch.randint(0, 2**31 - 1, (1,),
                                         generator=generator))
            batch = next(iter(TokenStream(vocab=cfg.vocab, seq_len=S,
                                          batch=B, seed=seed)))
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in batch.items()}
        if s["kind"] == "prefill":
            return {"tokens": _randint(generator, cfg.vocab, (B, S), dev)}
        cache = transformer.make_kv_cache(cfg, B, S, device=dev)
        for i in range(cfg.n_layers):      # layer by layer: the draw is f32
            cache[i] = torch.randn(cache.shape[1:], generator=generator,
                                   device=generator.device).to(cache)
        return {"token": _randint(generator, cfg.vocab, (B, 1), dev),
                "kv_cache": cache, "cache_len": S - 1}

    def model_flops(self, shape_id, **cuts):
        s = _cut(self.shapes[shape_id], cuts, ("batch", "seq"))
        cfg = self.cfg
        train = s["kind"] == "train"
        tokens = s["batch"] * (s["seq"] if s["kind"] != "decode" else 1)
        # 2 N a token forward; training 6 N (2 forward + 4 backward)
        flops = (6.0 if train else 2.0) * cfg.flops_param_count * tokens
        if s["kind"] != "decode":
            # causal attention scores and values: 12 B S^2/2 H Dh a layer
            # (x3 for training's backward)
            flops += (s["batch"] * s["seq"] ** 2 * cfg.n_heads * cfg.head_dim
                      * 2 * cfg.n_layers) * (3.0 if train else 1.0)
        return flops

    def model_bytes(self, shape_id, **cuts):
        s = _cut(self.shapes[shape_id], cuts, ("batch", "seq"))
        cfg = self.cfg
        B, S, L = s["batch"], s["seq"], cfg.n_layers
        weights = 2.0 * cfg.param_count                 # bf16
        kv = L * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        if s["kind"] == "train":
            # weights read forward, again by the remat and the backward,
            # bf16 gradients written and read, float32 moments read and
            # written (20 bytes a parameter); the layers' checkpointed
            # streams, the keys and values re-read a query block, and the
            # logits thrice
            act = B * S * cfg.d_model * 2.0
            nq = -(-S // _JAX_ATTN_BLOCK_KV)
            return (5 * weights + 20.0 * cfg.param_count + 15.0 * L * act
                    + nq * kv + 3.0 * B * S * cfg.vocab * 2)
        if s["kind"] == "prefill":
            act = B * S * cfg.d_model * 2.0             # one activation
            nq = -(-S // _JAX_ATTN_BLOCK_KV)
            return weights + 6.0 * L * act + kv + nq * kv + B * cfg.vocab * 4
        # decode: every weight and the whole cache read once
        return weights + kv + B * cfg.vocab * 4

    def infer_run(self, generator, device="cuda"):
        cfg = self.smoke_cfg
        dev = resolve_device(device)
        params = self.init_params(generator, dev, smoke=True)
        B, S = 2, 32
        batch = self.make_inputs("prefill_32k", generator, dev, smoke=True,
                                 batch=B, seq=S)
        logits, kv = self.build_step("prefill_32k", smoke=True)(params, batch)
        cache = transformer.make_kv_cache(cfg, B, S + 8, device=dev)
        cache[:, :, :, :S] = kv
        lg, _ = self.build_step("decode_32k", smoke=True)(
            params, {"token": batch["tokens"][:, :1], "kv_cache": cache,
                     "cache_len": S})
        out = {"prefill_logit_mean": float(logits.mean()),
               "decode_logit_mean": float(lg.mean())}
        if not all(math.isfinite(v) for v in out.values()):
            raise RuntimeError(f"{self.arch_id}: non-finite {out}")
        return out


# ---------------------------------------------------------------------------
# RecSys family (DIN)


class DINArch(ArchDef):
    shapes = DIN_SHAPES

    def __init__(self, arch_id: str, cfg: din.DINConfig,
                 smoke_cfg: din.DINConfig):
        self.arch_id = arch_id
        self.cfg = cfg
        self.smoke_cfg = smoke_cfg

    def init_params(self, generator, device="cuda", smoke=False):
        return din.init(self.config(smoke), generator, device)

    def build_step(self, shape_id, *, smoke=False, **options):
        """The train kind: train_step(params, opt_state, batch) -> (params,
        opt_state, loss), the JAX package's (``value_and_grad`` of
        ``din.loss_fn``, then AdamW): :meth:`grad_step`, then
        :func:`~repro_torch.optim.adamw_update` with the option ``opt``
        (default ``AdamWConfig()``), which writes the new parameters and
        moments into the ones given; ``opt_state`` is ``adamw_init(params)``
        at the start. Options of the retrieval kind: ``block`` (candidates
        a block, default 8,192) and ``factored`` (the algebraically
        factored attention MLP, default off), as ``din.score_candidates``
        takes them."""
        cfg = self.config(smoke)
        kind = self.kind(shape_id)
        if kind == "train":
            bad = set(options) - {"opt"}
            if bad:
                raise ValueError(f"unknown train options {sorted(bad)}")
            opt = options.get("opt", AdamWConfig())
            grad_step = self.grad_step(shape_id, smoke=smoke)

            def train_step(params, opt_state, batch):
                loss, grads = grad_step(params, batch)
                params, opt_state, _ = adamw_update(opt, params, grads,
                                                    opt_state)
                return params, opt_state, loss
            return train_step
        if kind == "serve":
            if options:
                raise ValueError(f"no options for serve: {sorted(options)}")

            def serve(params, batch):
                return din.score(params, cfg, batch)
            return serve
        bad = set(options) - {"block", "factored"}
        if bad:
            raise ValueError(f"unknown retrieval options {sorted(bad)}")

        def retrieval(params, batch):
            return din.score_candidates(params, cfg, batch, **options)
        return retrieval

    def grad_step(self, shape_id: str = "train_batch", *,
                  smoke: bool = False) -> Callable:
        """fn(params, batch) -> (loss, grads): ``din.loss_fn`` and its
        gradient in every parameter, a tuple in the JAX pytree's leaf order
        (``tree_leaves``: attn, cat_emb, item_emb, mlp), as
        ``jax.value_and_grad`` gives them. The module is made trainable
        (``requires_grad_``), the tables included; the batch's plans are
        built once (``din.batch_plans``), and on the card the tables'
        gradients are ``segment_reduce`` (the gathers' backward) and K5's
        backward over them."""
        if self.kind(shape_id) != "train":
            raise ValueError(f"{shape_id} is not a train cell")
        cfg = self.config(smoke)

        def loss_and_grads(params, batch):
            params.requires_grad_(True)
            leaves = tree_leaves(params)
            plans = din.batch_plans(cfg, batch)
            with torch.enable_grad():
                loss = din.loss_fn(params, cfg, batch, plans)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            return loss.detach(), grads
        return loss_and_grads

    def forward_step(self, shape_id: str = "train_batch", *,
                     smoke: bool = False) -> Callable:
        """fn(params, batch) -> (logits, loss): the forward half of the
        train step, no gradient kept."""
        if self.kind(shape_id) != "train":
            raise ValueError(f"{shape_id} is not a train cell")
        cfg = self.config(smoke)

        def forward(params, batch):
            logits = din.score(params, cfg, batch)
            return logits, din.bce_with_logits(logits, batch["label"])
        return forward

    def make_inputs(self, shape_id, generator, device="cuda", *, smoke=False,
                    seed: int | None = None, **cuts):
        """Histories of L = seq_len (item, category) pairs, each user's
        valid prefix of a length drawn from [1, L] (``hist_mask``).
        serve: B users and a target each. retrieval: one user and N
        candidates. train: one batch of the JAX package's own training
        stream (``RecsysStream``: Zipf(1.3) item ids, categories the item
        ids mod n_cats, a label correlated with the history's overlap with
        the target's category) at the cell's batch, of seed ``seed`` (None:
        drawn from ``generator``). Cuts: ``batch``, ``candidates``."""
        s = _cut(self.shapes[shape_id], cuts, ("batch", "candidates"))
        cfg = self.config(smoke)
        dev = resolve_device(device)
        if s["kind"] == "train":
            if seed is None:
                seed = int(_randint(generator, 2**31 - 1, (1,),
                                    torch.device("cpu"))[0])
            host = next(iter(RecsysStream(
                n_items=cfg.n_items, n_cats=cfg.n_cats, seq_len=cfg.seq_len,
                batch=s["batch"], seed=seed)))
            return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        if seed is not None:
            raise ValueError("seed is for the train kind")
        B, L = s["batch"], cfg.seq_len
        lengths = _randint(generator, L, (B, 1), dev) + 1
        batch = {"hist_items": _randint(generator, cfg.n_items, (B, L), dev),
                 "hist_cats": _randint(generator, cfg.n_cats, (B, L), dev),
                 "hist_mask": torch.arange(L, device=dev)[None] < lengths}
        if s["kind"] == "retrieval":
            n = s["candidates"]
            batch["cand_items"] = _randint(generator, cfg.n_items, (n,), dev)
            batch["cand_cats"] = _randint(generator, cfg.n_cats, (n,), dev)
        else:
            batch["target_item"] = _randint(generator, cfg.n_items, (B,),
                                            dev)
            batch["target_cat"] = _randint(generator, cfg.n_cats, (B,), dev)
        return batch

    def model_flops(self, shape_id, **cuts):
        """The attention and main MLPs' multiply-adds (x 2): a candidate's
        or an example's; the train kind three times an example's (forward
        and backward), as the JAX package counts them."""
        s = _cut(self.shapes[shape_id], cuts, ("batch", "candidates"))
        cfg = self.cfg
        d, L = cfg.d_pair, cfg.seq_len
        attn_d = [4 * d, *cfg.attn_mlp, 1]
        mlp_d = [3 * d, *cfg.mlp, 1]
        per_example = (sum(a * b for a, b in zip(attn_d[:-1], attn_d[1:]))
                       * 2 * L
                       + sum(a * b for a, b in zip(mlp_d[:-1], mlp_d[1:]))
                       * 2)
        if s["kind"] == "retrieval":
            return float(per_example * s["candidates"])
        mult = 3.0 if s["kind"] == "train" else 1.0
        return float(mult * per_example * s["batch"])

    def model_bytes(self, shape_id, **cuts):
        """The rows gathered and the attention features written and read;
        the train kind three passes of those and the tables' gradient
        rows, as the JAX package counts them."""
        s = _cut(self.shapes[shape_id], cuts, ("batch", "candidates"))
        d, L = self.cfg.d_pair, self.cfg.seq_len
        if s["kind"] == "retrieval":
            # a candidate: its target rows and its attention features
            return float(s["candidates"] * (d * 4 + L * d * 4 * 2))
        B = s["batch"]
        gathers = B * (L + 1) * d * 4                  # history + target
        acts = B * L * (4 * d) * 4 * 2                 # attention features
        if s["kind"] == "train":
            return float(3.0 * (gathers + acts) + 2.0 * gathers)
        return float(gathers + acts)

    def infer_run(self, generator, device="cuda"):
        dev = resolve_device(device)
        params = self.init_params(generator, dev, smoke=True)
        batch = self.make_inputs("serve_p99", generator, dev, smoke=True,
                                 batch=8)
        scores = self.build_step("serve_p99", smoke=True)(params, batch)
        rb = self.make_inputs("retrieval_cand", generator, dev, smoke=True,
                              candidates=256)
        cand = self.build_step("retrieval_cand", smoke=True, block=64)(
            params, rb)
        out = {"score_mean": float(scores.mean()),
               "retrieval_mean": float(cand.mean())}
        if not all(math.isfinite(v) for v in out.values()):
            raise RuntimeError(f"{self.arch_id}: non-finite {out}")
        return out


# ---------------------------------------------------------------------------
# GNN family


GNN_SHAPES: dict[str, dict] = {
    "full_graph_sm": dict(n=2_708, m=10_556, d=1_433, classes=7, graphs=1),
    "minibatch_lg": dict(n=180_224, m=179_200, d=602, classes=41, graphs=1,
                         sampled=True),
    "ogb_products": dict(n=2_449_029, m=61_859_140, d=100, classes=47,
                         graphs=1),
    "molecule": dict(n=30 * 128, m=64 * 128, d=16, classes=1, graphs=128),
}

# minibatch_lg's sampler: the web-stanford stand-in of ppr/datasets.py at
# full size (a Reddit-sized graph is not in the repository), the JAX
# sampler's batch and fanout, padded to the cell's (n, m)
MINIBATCH_GRAPH = "web-stanford"
MINIBATCH_BATCH_NODES = 1024
MINIBATCH_FANOUT = (15, 10)

# the cells one 80 GB card cannot hold as the models are written (float32)
_TOO_LARGE = {
    ("pna", "ogb_products"): "the (m, 150) concatenation [h[src], h[dst]] "
                             "alone is 37.1 GB, and the message, its square "
                             "and the two masked copies 18.6 GB each",
    ("graphcast", "ogb_products"): "one (m, 512) edge state is 126.7 GB",
    ("dimenet", "ogb_products"): "build_triplets over 61.9 M edges with a "
                                 "budget of 2^25 triplets, and (T, d) "
                                 "temporaries of 17 GB",
}


def _pad(x: int, mult: int = 128) -> int:
    """Pad a logical size to a multiple of 128, as the JAX package pads
    the cells (node and edge masks make padding transparent)."""
    return -(-x // mult) * mult


def _triplet_budget(m: int) -> int:
    return _pad(int(min(8 * m, 1 << 25)))


class GNNArch(ArchDef):
    """A GNN architecture over the four graph cells, all of the train kind
    (:meth:`build_step`; :meth:`forward_step` is its forward half)."""

    shapes = GNN_SHAPES

    def __init__(self, arch_id: str, model, make_cfg: Callable[[dict], Any],
                 make_smoke_cfg: Callable[[], Any]):
        self.arch_id = arch_id
        self.model = model
        self.make_cfg = make_cfg          # (shape meta dict) -> model config
        self.make_smoke_cfg = make_smoke_cfg
        self._is_dimenet = model is dimenet
        self._is_graphcast = model is graphcast

    def kind(self, shape_id):
        return "train"

    def _cfg(self, shape_id: str) -> Any:
        return self.make_cfg(GNN_SHAPES[shape_id])

    def config(self, smoke: bool = False, shape_id: str = "full_graph_sm"):
        """The smoke config, or the published one at the cell's widths."""
        return self.make_smoke_cfg() if smoke else self._cfg(shape_id)

    def skip_reason(self, shape_id: str) -> str | None:
        """Why one H100 cannot run the cell, or None."""
        return _TOO_LARGE.get((self.arch_id, shape_id))

    def init_params(self, generator, device="cuda", smoke=False,
                    shape_id: str = "full_graph_sm"):
        return self.model.init(self.config(smoke, shape_id), generator,
                               device)

    def build_step(self, shape_id: str | None = None, *, smoke: bool = False,
                   opt: AdamWConfig = AdamWConfig()) -> Callable:
        """train_step(params, opt_state, inputs) -> (params, opt_state,
        loss): the JAX package's train step for the cell's config (or,
        with ``smoke``, the smoke config) on the inputs of
        :meth:`make_inputs` (:meth:`smoke_case`): the loss and its
        gradient (:meth:`grad_step`), then :func:`~repro_torch.optim.
        adamw_update`, which writes the new parameters and moments into
        the ones given. ``opt_state`` is ``adamw_init(params)`` at the
        start."""
        grad_step = self.grad_step(shape_id, smoke=smoke)

        def train_step(params, opt_state, inputs):
            loss, grads = grad_step(params, inputs)
            params, opt_state, _ = adamw_update(opt, params, grads,
                                                opt_state)
            return params, opt_state, loss
        return train_step

    def grad_step(self, shape_id: str | None = None, *,
                  smoke: bool = False) -> Callable:
        """fn(params, inputs) -> (loss, grads): the loss of
        :meth:`forward_step` and its gradient in every parameter, a tuple
        in the JAX pytree's leaf order (``tree_leaves``), as
        ``jax.value_and_grad`` gives them. The tree is made trainable
        (``requires_grad_``); the aggregations' and gathers' backwards are
        the port's kernels on the card (``ops.segment_reduce``,
        ``ops.gather_rows``)."""
        forward = self.forward_step(shape_id, smoke=smoke)

        def loss_and_grads(params, inputs):
            params.requires_grad_(True)
            leaves = tree_leaves(params)
            with torch.enable_grad():
                _, loss = forward(params, inputs)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            return loss.detach(), grads
        return loss_and_grads

    def forward_step(self, shape_id: str | None = None, *,
                     smoke: bool = False) -> Callable:
        """fn(params, inputs) -> (output, loss): the model's ``apply`` and
        the value of its ``loss_fn`` on the inputs of :meth:`make_inputs`
        (or, with ``smoke``, of :meth:`smoke_case`), the forward half of
        the JAX package's train step."""
        cfg = self.config(smoke, shape_id or "full_graph_sm")
        graphs = _SMOKE_GRAPHS if smoke else GNN_SHAPES[shape_id]["graphs"]
        model, is_dime = self.model, self._is_dimenet

        def forward(params, inputs):
            batch = GraphBatch(
                node_feat=inputs["node_feat"],
                edge_index=inputs["edge_index"],
                node_mask=inputs["node_mask"], edge_mask=inputs["edge_mask"],
                positions=inputs.get("positions"),
                graph_ids=inputs.get("graph_ids"),
                labels=inputs.get("labels"), num_graphs=graphs)
            if is_dime:
                out = model.apply(params, cfg, batch,
                                  (inputs["triplet_kj"], inputs["triplet_ji"]))
            else:
                out = model.apply(params, cfg, batch)
            return out, model.loss_of(out, batch)
        return forward

    def make_inputs(self, shape_id: str, generator: torch.Generator,
                    device: str | torch.device = "cuda", *,
                    graph: Graph | None = None) -> dict[str, Any]:
        """The cell's padded inputs, drawn on ``generator``: n and m padded
        to multiples of 128, padding nodes and edges masked off, padded
        edges at node 0 (as the sampler pads them). minibatch_lg is a
        sample of ``graph`` (default: the full-size web-stanford stand-in)
        with batch 1,024 and fanout (15, 10), its features, labels and
        positions rows of seeded tables gathered by the sampled nodes; the
        other cells are random graphs (molecule: 128 graphs of 30 nodes and
        64 edges, edges within a graph). DimeNet also gets positions,
        ``graph_ids`` (padding nodes at ``graphs``, in no graph) and the
        triplets of the real edges, padded to the budget with ``idx_ji =
        m``, which the triplet sum drops."""
        reason = self.skip_reason(shape_id)
        if reason is not None:
            raise ValueError(f"{self.arch_id} on {shape_id} does not fit one "
                             f"card: {reason}")
        s = GNN_SHAPES[shape_id]
        cfg = self._cfg(shape_id)
        dev = resolve_device(device)
        N, M, g = _pad(s["n"]), _pad(s["m"]), s["graphs"]
        gen = generator

        def normal(*shape):
            return torch.randn(shape, generator=gen,
                               device=gen.device).to(dev)

        def ints(high, *shape):
            return torch.randint(0, high, shape, generator=gen,
                                 device=gen.device,
                                 dtype=torch.int32).to(dev)

        if s.get("sampled"):
            graph = graph if graph is not None else load(MINIBATCH_GRAPH,
                                                         scale=1)
            seed = int(ints(2**31 - 1, 1)[0])
            sub = next(minibatch_stream(
                graph, batch_nodes=MINIBATCH_BATCH_NODES,
                fanout=MINIBATCH_FANOUT, pad_nodes=N, pad_edges=M,
                seed=seed))
            nodes = torch.from_numpy(sub.nodes).to(dev)
            n, m = int(sub.node_mask.sum()), int(sub.edge_mask.sum())
            edge_index = torch.from_numpy(sub.edge_index).to(dev)
            node_feat = normal(graph.n, s["d"])[nodes]
            per_node = lambda t: t[nodes]            # noqa: E731
            table_rows = graph.n
        else:
            n, m = s["n"], s["m"]
            npg, epg = n // g, m // g
            base = (torch.arange(m, device=dev, dtype=torch.int32)
                    // epg) * npg
            edge_index = torch.zeros((2, M), dtype=torch.int32, device=dev)
            edge_index[0, :m] = ints(npg, m) + base
            edge_index[1, :m] = ints(npg, m) + base
            node_feat = torch.zeros((N, s["d"]), device=dev)
            node_feat[:n] = normal(n, s["d"])
            per_node = lambda t: torch.cat(          # noqa: E731
                [t, t.new_zeros((N - n,) + tuple(t.shape[1:]))])
            table_rows = n
        inputs = {"node_feat": node_feat, "edge_index": edge_index,
                  "node_mask": torch.arange(N, device=dev) < n,
                  "edge_mask": torch.arange(M, device=dev) < m}
        if self._is_dimenet:
            t = _triplet_budget(s["m"])
            kj, ji = self.model.build_triplets(
                edge_index[:, :m].cpu().numpy(), n, max_triplets=t)
            pad = t - kj.size
            inputs.update(
                positions=per_node(normal(table_rows, 3)),
                graph_ids=torch.where(
                    inputs["node_mask"],
                    torch.arange(N, device=dev) // max(n // g, 1), g
                ).to(torch.int32),
                labels=normal(g, cfg.n_out),
                triplet_kj=torch.from_numpy(np.concatenate(
                    [kj, np.zeros(pad, np.int32)])).to(dev),
                triplet_ji=torch.from_numpy(np.concatenate(
                    [ji, np.full(pad, M, np.int32)])).to(dev))
        elif self._is_graphcast:
            inputs["labels"] = normal(N, cfg.n_out)
        else:
            inputs["labels"] = per_node(ints(cfg.n_classes, table_rows))
        return inputs

    def smoke_case(self, generator: torch.Generator,
                   device: str | torch.device = "cuda"
                   ) -> tuple[Any, dict[str, Any]]:
        """(params, inputs) of the JAX ``smoke_run``'s case: the smoke
        config, a random batch of n = 64, m = 256 in 4 graphs with
        positions (DimeNet: its triplets, budget 512)."""
        cfg = self.make_smoke_cfg()
        dev = resolve_device(device)
        n, m = 64, 256
        d = getattr(cfg, "d_in", 16)
        batch = random_graph_batch(generator, n, m, d,
                                   n_graphs=_SMOKE_GRAPHS,
                                   with_positions=True,
                                   n_classes=getattr(cfg, "n_classes", 2),
                                   device=dev)
        params = self.init_params(generator, dev, smoke=True)
        inputs = {"node_feat": batch.node_feat,
                  "edge_index": batch.edge_index,
                  "node_mask": batch.node_mask, "edge_mask": batch.edge_mask,
                  "positions": batch.positions, "graph_ids": batch.graph_ids,
                  "labels": batch.labels}
        if self._is_dimenet:
            kj, ji = self.model.build_triplets(
                batch.edge_index.cpu().numpy(), n, max_triplets=512)
            inputs["triplet_kj"] = torch.from_numpy(kj).to(dev)
            inputs["triplet_ji"] = torch.from_numpy(ji).to(dev)
        return params, inputs

    def infer_run(self, generator, device="cuda"):
        params, inputs = self.smoke_case(generator, device)
        out, loss = self.forward_step(smoke=True)(params, inputs)
        res = {"loss": float(loss), "output_mean": float(out.mean())}
        if not all(math.isfinite(v) for v in res.values()):
            raise RuntimeError(f"{self.arch_id}: non-finite {res}")
        return res

    def train_run(self, generator: torch.Generator,
                  device: str | torch.device = "cuda") -> dict[str, float]:
        """The JAX ``smoke_run``'s counterpart: the smoke case's loss and
        the global norm of its gradient at the initial parameters."""
        params, inputs = self.smoke_case(generator, device)
        loss, grads = self.grad_step(smoke=True)(params, inputs)
        res = {"loss": float(loss), "grad_norm": float(global_norm(grads))}
        if not all(math.isfinite(v) for v in res.values()):
            raise RuntimeError(f"{self.arch_id}: non-finite {res}")
        return res

    def _dims(self, shape_id: str):
        s = GNN_SHAPES[shape_id]
        cfg = self._cfg(shape_id)
        h = getattr(cfg, "d_hidden", 128)
        L = getattr(cfg, "n_layers", getattr(cfg, "n_blocks", 2))
        return s["n"], s["m"], s["d"], h, L, cfg

    def _flops(self, shape_id: str, mult: float) -> float:
        n, m, d, h, L, cfg = self._dims(shape_id)
        if self._is_dimenet:
            t = _triplet_budget(m)
            per = t * h * cfg.n_bilinear * h * 2 + m * 2 * h * h * 2
            return mult * L * per / 2.0
        if self.model is gcn:
            return mult * (n * d * h + (L - 1) * n * h * h + m * h)
        if self.model is pna:
            per = m * (2 * h) * h * 2 + n * (13 * h) * h * 2
            return mult * L * per / 2.0
        per = m * (3 * h) * h * 2 + n * (2 * h) * h * 2       # graphcast
        return mult * (L * per + n * d * h * 2) / 2.0

    def _bytes(self, shape_id: str, passes: float, optimizer: bool) -> float:
        n, m, d, h, L, cfg = self._dims(shape_id)
        node = 6.0 * n * h * 4
        edge = 3.0 * m * h * 4                      # gather src, msg, scatter
        total = passes * L * (node + edge) + n * d * 4
        if self._is_dimenet:
            t = _triplet_budget(m)
            total += passes * L * t * (2 * h + cfg.n_bilinear) * 4
        if optimizer:
            total += 12.0 * self._param_bytes(shape_id)    # opt traffic
        return total

    def _param_bytes(self, shape_id: str) -> int:
        cfg = self._cfg(shape_id)
        size = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        return self.model.param_count(cfg) * size

    def model_flops(self, shape_id):
        """Dominant useful operations of the JAX train step (forward and
        backward): per-edge message GEMMs + per-node MLPs, as the JAX
        package counts them."""
        return self._flops(shape_id, 6.0)

    def model_bytes(self, shape_id):
        """Bytes of the JAX train step as the JAX package counts them:
        three passes and the optimizer's traffic."""
        return self._bytes(shape_id, 3.0, optimizer=True)

    def forward_flops(self, shape_id: str) -> float:
        """The forward alone: :meth:`model_flops`' formula at one pass (2
        where it has 6)."""
        return self._flops(shape_id, 2.0)

    def forward_bytes(self, shape_id: str) -> float:
        """The forward alone: :meth:`model_bytes`' formula at one pass and
        without the optimizer's traffic."""
        return self._bytes(shape_id, 1.0, optimizer=False)


_SMOKE_GRAPHS = 4
