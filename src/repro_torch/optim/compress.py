"""Gradient compression for data parallelism across slow links: int8
stochastic rounding with error feedback, the port of
``repro/optim/compress.py``.

Each gradient leaf plus the residual carried from the last step is
quantised to int8 with one float32 scale (symmetric, stochastic rounding),
dequantised, and the new residual (what the rounding lost) carried to the
next step, which keeps the convergence of the uncompressed run (the
error-feedback guarantee). An all-reduce of the int8 tensors would move a
quarter of float32's bytes; on one card the round trip is modelled
locally, as the reference models it under pjit.

The rounding noise comes in as tensors, the port's RNG rule: the caller
hands ``compress_grads`` one uniform [-0.5, 0.5) tensor a leaf (the tests
hand JAX's), or draws them with :func:`step_noise` on a
``torch.Generator`` seeded for the step (``launch/train.py``). The leaves
are the gradients in the parameters' JAX leaf order
(``models.common.tree_leaves``), as ``grad_step`` returns them.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any, NamedTuple

import torch

from ..models.common import tree_leaves


class CompressState(NamedTuple):
    """The quantisation residual a leaf (float32), in leaf order."""

    error: tuple[torch.Tensor, ...]


def init_state(params: Any) -> CompressState:
    return CompressState(tuple(
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)))


def quantize(g: torch.Tensor, noise: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with stochastic rounding: (q int8, scale), scale =
    max(max|g|, 1e-12) / 127 a float32 scalar tensor, q = clip(round(g /
    scale + noise), -127, 127) with ``noise`` uniform in [-0.5, 0.5) of
    g's shape."""
    gf = g.to(torch.float32)
    scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def step_noise(grads: Sequence[torch.Tensor],
               generator: torch.Generator) -> list[torch.Tensor]:
    """One uniform [-0.5, 0.5) float32 tensor a leaf, drawn in leaf order
    on ``generator`` (whose device is the gradients')."""
    return [torch.rand(g.shape, generator=generator, device=g.device) - 0.5
            for g in grads]


def compress_grads(grads: Sequence[torch.Tensor], state: CompressState,
                   noise: Sequence[torch.Tensor]
                   ) -> tuple[tuple[torch.Tensor, ...], CompressState]:
    """Error-feedback int8 round trip of each leaf: g' = deq(quant(g + e)),
    e' = (g + e) - g'. Returns (g' in each leaf's dtype, the new state)."""
    if not len(grads) == len(state.error) == len(noise):
        raise ValueError(f"{len(grads)} gradients, {len(state.error)} "
                         f"residuals, {len(noise)} noise tensors")
    new_g, new_e = [], []
    for g, e, u in zip(grads, state.error, noise):
        corrected = g.to(torch.float32) + e
        deq = dequantize(*quantize(corrected, u))
        new_g.append(deq.to(g.dtype))
        new_e.append(corrected - deq)
    return tuple(new_g), CompressState(tuple(new_e))
