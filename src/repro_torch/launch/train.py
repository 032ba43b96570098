"""End-to-end training loop of the port, on the card: the config
registry, the data pipeline, the train step (the loss's gradient under
autograd, then AdamW), int8 gradient compression, asynchronous
checkpoints and an elastic restart. A copy of ``repro.launch.train``'s
DIN and GNN branches over the port's modules.

    python -m repro_torch.launch.train --arch din --steps 30 \\
        --preset smoke --ckpt-dir build/ckpt [--resume] [--compress-grads] \\
        [--fail-at 15:0] [--device cuda]

It trains the architecture's smoke config: DIN on a ``RecsysStream`` of
``--batch`` users (the loss and the tables' gradients through K5, its
backward and ``segment_reduce`` on the card), a GNN on one random graph of
128 nodes and 512 edges. ``--device`` defaults to ``cuda`` and raises
without a card unless ``--device cpu`` is given. An LM ``--arch`` or
``--preset lm100m`` raises ``NotImplementedError``: LM training is queue 1,
item 1b of ROADMAP.md.

What differs from the reference, so that a resumed run equals a straight
one: a checkpoint is labelled with the steps it holds (the reference
labels the state after step s as s, and a resume from it repeats step s),
it holds the compression residual as well, and a resumed run skips the
batches of the steps its checkpoint holds. The compression noise of step
s is drawn on a generator seeded from (``--seed``, s). A failure from
``--fail-at step:device`` marks the device failed in the elastic
controller, which restores the last checkpoint and carries on at that
step, as the reference does. The last line printed is a JSON summary;
over more than 20 steps the run then raises unless the mean loss of the
last 10 steps is below that of the first 10 (the reference's check).
"""

from __future__ import annotations

import argparse
import json
import time
from collections.abc import Callable
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..checkpoint.store import AsyncCheckpointer, latest_step, restore
from ..configs import get_arch
from ..configs.base import DINArch, GNNArch, LMArch
from ..core.allocator import DeviceAllocator
from ..data.pipeline import Prefetcher, RecsysStream
from ..ft.elastic import ElasticController, FailureInjector
from ..models.common import tree_leaves
from ..optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                     compress_grads, compress_init, step_noise)
from ..optim.compress import CompressState

LM_LATER = ("LM training is not ported yet: queue 1, item 1b of ROADMAP.md "
            "(the LM loss, K6's backward and the MoE backwards); this "
            "entry point trains DIN and the GNNs")
DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "ckpt"
NOISE_SEED_STRIDE = 1_000_003      # a step's noise seed: seed * this + step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="din")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", choices=["smoke", "lm100m"], default="smoke")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", action="append", default=[],
                    help="step:device_idx, inject a failure (testing)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def _model(arch, args, dev: torch.device, gen: torch.Generator
           ) -> tuple[Any, Callable, Any]:
    """(params, loss(params, batch), an iterator of host batches)."""
    if isinstance(arch, LMArch) or args.preset == "lm100m":
        raise NotImplementedError(LM_LATER)
    if isinstance(arch, DINArch):
        from ..models.recsys import din
        cfg = arch.smoke_cfg
        params = din.init(cfg, gen, dev)
        stream = iter(RecsysStream(n_items=cfg.n_items, n_cats=cfg.n_cats,
                                   seq_len=cfg.seq_len, batch=args.batch,
                                   seed=args.seed))

        def loss_fn(p, batch):
            return din.loss_fn(p, cfg, batch)
        return params, loss_fn, stream
    if isinstance(arch, GNNArch):
        from ..models.gnn.common import random_graph_batch
        cfg = arch.make_smoke_cfg()
        params = arch.model.init(cfg, gen, dev)
        # DimeNet's config has no d_in: 16 features, as the smoke case
        gb = random_graph_batch(gen, 128, 512, getattr(cfg, "d_in", 16),
                                n_classes=getattr(cfg, "n_classes", 2),
                                with_positions=True, device=dev)

        def graphs():
            while True:
                yield {}

        if arch.arch_id == "dimenet":
            kj, ji = arch.model.build_triplets(gb.edge_index.cpu().numpy(),
                                               128, max_triplets=2048)
            trip = (torch.from_numpy(kj).to(dev), torch.from_numpy(ji).to(dev))

            def loss_fn(p, batch):
                return arch.model.loss_fn(p, cfg, gb, trip)
        else:
            def loss_fn(p, batch):
                return arch.model.loss_fn(p, cfg, gb)
        return params, loss_fn, graphs()
    raise SystemExit(f"training not defined for {args.arch}")


def _state(params, opt: AdamWState, comp: CompressState | None) -> dict:
    """The checkpointed state as nested dicts and lists of tensors."""
    out = {"params": list(tree_leaves(params)),
           "opt": {"m": list(opt.m), "v": list(opt.v), "step": opt.step}}
    if comp is not None:
        out["comp"] = list(comp.error)
    return out


def _load(state: dict, params, comp: CompressState | None
          ) -> tuple[AdamWState, CompressState | None]:
    """Write a restored state's parameters into ``params``; return its
    optimizer and compression states."""
    with torch.no_grad():
        for p, saved in zip(tree_leaves(params), state["params"]):
            p.copy_(saved)
    opt = AdamWState(tuple(state["opt"]["m"]), tuple(state["opt"]["v"]),
                     state["opt"]["step"])
    if comp is not None:
        comp = CompressState(tuple(state["comp"]))
    return opt, comp


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    arch = get_arch(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    params, loss_fn, stream = _model(arch, args, dev, gen)

    opt_cfg = AdamWConfig(lr=args.lr)
    opt_state = adamw_init(params)
    comp_state = compress_init(params) if args.compress_grads else None

    def train_step(params, opt_state, comp_state, batch, step):
        params.requires_grad_(True)
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if comp_state is not None:
            noise_gen = torch.Generator(device=dev).manual_seed(
                args.seed * NOISE_SEED_STRIDE + step)
            grads, comp_state = compress_grads(
                grads, comp_state, step_noise(grads, noise_gen))
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        return params, opt_state, comp_state, loss.detach(), metrics

    # --- fault tolerance ------------------------------------------------
    schedule: dict[int, list[int]] = {}
    for spec in args.fail_at:
        s, d = spec.split(":")
        schedule.setdefault(int(s), []).append(int(d))
    allocator = DeviceAllocator(devices=[dev] * 8)         # logical
    rescales = {"count": 0}

    def on_rescale(healthy: int) -> None:
        rescales["count"] += 1
        print(f"  [elastic] rescaled to {healthy} logical devices; "
              f"restoring from checkpoint")

    controller = ElasticController(
        allocator=allocator, injector=FailureInjector(schedule),
        on_rescale=on_rescale)

    ckpt = AsyncCheckpointer(args.ckpt_dir)
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        start, state = restore(args.ckpt_dir, None,
                               _state(params, opt_state, comp_state))
        opt_state, comp_state = _load(state, params, comp_state)
        print(f"resumed from step {start}")
        for _ in range(start):                 # the batches it holds
            next(stream)

    # --- loop -------------------------------------------------------------
    it = Prefetcher(stream)
    losses: list[float] = []
    restored: list[int] = []
    t0 = time.perf_counter()
    try:
        for step in range(start, args.steps):
            if controller.tick(step):
                # restart from the last checkpoint after the failure
                ckpt.wait()
                if latest_step(args.ckpt_dir) is not None:
                    at, state = restore(args.ckpt_dir, None,
                                        _state(params, opt_state, comp_state))
                    opt_state, comp_state = _load(state, params, comp_state)
                    restored.append(at)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(it).items()}
            params, opt_state, comp_state, loss, metrics = train_step(
                params, opt_state, comp_state, batch, step)
            losses.append(float(loss))
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({(time.perf_counter() - t0) / (step - start + 1):.2f}"
                      f" s/step)")
            if (step + 1) % args.ckpt_every == 0 and step + 1 < args.steps:
                ckpt.save(step + 1, _state(params, opt_state, comp_state))
        ckpt.save(args.steps, _state(params, opt_state, comp_state))
        ckpt.wait()
    finally:
        it.close()
    summary = {"arch": args.arch, "device": str(dev), "steps": args.steps,
               "start": start, "losses": losses,
               "rescales": rescales["count"], "restored_from": restored,
               "seconds": time.perf_counter() - t0}
    if losses:
        print(f"done: {args.steps} steps, final loss {losses[-1]:.4f} "
              f"(first {losses[0]:.4f}), rescale events {rescales['count']}")
    if len(losses) > 20:
        summary["first10"] = float(np.mean(losses[:10]))
        summary["last10"] = float(np.mean(losses[-10:]))
    print(json.dumps({"train": {k: v for k, v in summary.items()
                                if k != "losses"}}))
    if len(losses) > 20 and not summary["last10"] < summary["first10"]:
        raise RuntimeError(f"loss did not improve: the first 10 steps' mean "
                           f"{summary['first10']}, the last 10's "
                           f"{summary['last10']}")
    return summary


if __name__ == "__main__":
    main()
