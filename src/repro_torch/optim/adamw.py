"""AdamW with global-norm clipping, the port of ``repro/optim/adamw.py``.

The same configuration and rule: a linear warm-up of the learning rate,
the gradients scaled by ``min(1, clip / ||g||)``, float32 moments whatever
the parameters' dtype, bias-corrected moments, and decoupled weight decay.
The update walks the parameters in the JAX pytree's order
(:func:`~repro_torch.models.common.tree_leaves`), so the global norm adds
the leaves' squared sums in the reference's order. It is plain tensor
code, as the reference is XLA and not Pallas; ``torch.optim.AdamW`` is
not this rule (its clipping, warm-up and decay differ). The step count,
learning rate, norm and clip scale stay on the parameters' device: an
update makes no host sync.

Unlike the reference's pure function, :func:`adamw_update` writes the new
parameters and moments into the tensors it was given (the port may update
in place where that saves memory): a caller that wants the old values
clones them first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.common import tensor_from_numpy, tree_leaves


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class AdamWState(NamedTuple):
    """Moments as tuples of float32 tensors in the parameters' JAX leaf
    order, and the step count, an int32 scalar tensor on their device."""

    m: tuple[torch.Tensor, ...]
    v: tuple[torch.Tensor, ...]
    step: torch.Tensor


def adamw_init(params: Any) -> AdamWState:
    leaves = tree_leaves(params)
    if not leaves:
        raise ValueError("no parameters")
    m = tuple(torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for p in leaves)
    v = tuple(torch.zeros_like(t) for t in m)
    return AdamWState(m, v, torch.zeros((), dtype=torch.int32,
                                        device=leaves[0].device))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the leaves' squared sums (in float32), added in leaf order."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: AdamWState) -> tuple[Any, AdamWState, dict]:
    """One AdamW step: returns (params, state, {"grad_norm", "lr"}), the
    parameters and moments updated in place, ``grads`` a tree of the
    parameters' structure or the sequence of their leaves' gradients."""
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    if len(flat_g) != len(flat_p) or len(state.m) != len(flat_p):
        raise ValueError(f"{len(flat_p)} parameters, {len(flat_g)} "
                         f"gradients, {len(state.m)} moments")
    step = state.step + 1
    stepf = step.to(torch.float32)
    # linear warmup then constant (schedule kept simple, as the reference)
    lr = cfg.lr * torch.clamp(stepf / max(cfg.warmup_steps, 1), max=1.0)
    gnorm = global_norm(flat_g)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1t = 1.0 - torch.pow(cfg.b1, stepf)
    b2t = 1.0 - torch.pow(cfg.b2, stepf)
    for p, g, m, v in zip(flat_p, flat_g, state.m, state.v):
        gf = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * gf
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(gf)
        m_hat = m_new / b1t
        v_hat = v_new / b2t
        pf = p.to(torch.float32)
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps) + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    return params, AdamWState(state.m, state.v, step), \
        {"grad_norm": gnorm, "lr": lr}


def state_from_numpy(state: Any, device: str | torch.device = "cuda"
                     ) -> AdamWState:
    """A JAX ``AdamWState`` (its fields as numpy arrays, or the state
    itself as (m, v, step)) -> the port's, on ``device``: m and v
    flattened in the JAX leaf order, float32, the step an int32 scalar."""
    m, v, step = state
    dev = resolve_device(device)

    def leaves(tree) -> tuple[torch.Tensor, ...]:
        return tuple(tensor_from_numpy(np.asarray(a), dev, torch.float32)
                     for a in tree_leaves(tree))

    return AdamWState(leaves(m), leaves(v),
                      torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                   device=dev))

