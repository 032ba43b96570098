"""Architecture definitions and their shape cells, for the serving kinds:
the port of ``repro/configs/base.py``.

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

Training kinds, meshes and partition specs and the optimizer come with the
training and sharding slices.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any

import torch

from .._device import resolve_device
from ..models import transformer
from ..models.recsys import din

_TRAIN_LATER = ("training steps are not ported yet (a later slice of the "
                "port); the serving kinds are")
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
                 smoke_cfg: transformer.LMConfig):
        self.arch_id = arch_id
        self.cfg = cfg
        self.smoke_cfg = smoke_cfg

    def init_params(self, generator, device="cuda", smoke=False):
        return transformer.init(self.config(smoke), generator, device)

    def build_step(self, shape_id, *, smoke=False, **options):
        cfg = self.config(smoke)
        kind = self.kind(shape_id)
        if options:
            raise ValueError(f"no options for {kind}: {sorted(options)}")
        if kind == "train":
            raise NotImplementedError(_TRAIN_LATER)
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
                    **cuts):
        """prefill: tokens (B, S). decode: one token (B, 1) against an
        S-long cache of random keys and values, written at the last slot
        (``cache_len = S - 1``). Cuts: ``batch``, ``seq``."""
        s = _cut(self.shapes[shape_id], cuts, ("batch", "seq"))
        cfg = self.config(smoke)
        dev = resolve_device(device)
        B, S = s["batch"], s["seq"]
        if s["kind"] == "train":
            raise NotImplementedError(_TRAIN_LATER)
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
        if s["kind"] == "train":
            raise NotImplementedError(_TRAIN_LATER)
        cfg = self.cfg
        tokens = s["batch"] * (s["seq"] if s["kind"] != "decode" else 1)
        flops = 2.0 * cfg.flops_param_count * tokens
        if s["kind"] != "decode":
            # causal attention scores and values: 12 B S^2/2 H Dh a layer
            flops += (s["batch"] * s["seq"] ** 2 * cfg.n_heads * cfg.head_dim
                      * 2 * cfg.n_layers)
        return flops

    def model_bytes(self, shape_id, **cuts):
        s = _cut(self.shapes[shape_id], cuts, ("batch", "seq"))
        if s["kind"] == "train":
            raise NotImplementedError(_TRAIN_LATER)
        cfg = self.cfg
        B, S, L = s["batch"], s["seq"], cfg.n_layers
        weights = 2.0 * cfg.param_count                 # bf16
        kv = L * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
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
        """Options of the retrieval kind: ``block`` (candidates a block,
        default 8,192) and ``factored`` (the algebraically factored
        attention MLP, default off), as ``din.score_candidates`` takes
        them."""
        cfg = self.config(smoke)
        kind = self.kind(shape_id)
        if kind == "train":
            raise NotImplementedError(_TRAIN_LATER)
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

    def make_inputs(self, shape_id, generator, device="cuda", *, smoke=False,
                    **cuts):
        """Histories of L = seq_len (item, category) pairs, each user's
        valid prefix of a length drawn from [1, L] (``hist_mask``).
        serve: B users and a target each. retrieval: one user and N
        candidates. Cuts: ``batch``, ``candidates``."""
        s = _cut(self.shapes[shape_id], cuts, ("batch", "candidates"))
        cfg = self.config(smoke)
        dev = resolve_device(device)
        if s["kind"] == "train":
            raise NotImplementedError(_TRAIN_LATER)
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
        s = _cut(self.shapes[shape_id], cuts, ("batch", "candidates"))
        if s["kind"] == "train":
            raise NotImplementedError(_TRAIN_LATER)
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
        return float(per_example * s["batch"])

    def model_bytes(self, shape_id, **cuts):
        s = _cut(self.shapes[shape_id], cuts, ("batch", "candidates"))
        if s["kind"] == "train":
            raise NotImplementedError(_TRAIN_LATER)
        d, L = self.cfg.d_pair, self.cfg.seq_len
        if s["kind"] == "retrieval":
            # a candidate: its target rows and its attention features
            return float(s["candidates"] * (d * 4 + L * d * 4 * 2))
        B = s["batch"]
        gathers = B * (L + 1) * d * 4                  # history + target
        acts = B * L * (4 * d) * 4 * 2                 # attention features
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
