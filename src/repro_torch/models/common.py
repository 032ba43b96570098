"""Shared model building blocks, the port of ``repro/models/common.py``.

Norms, rotary embeddings, attention, activations and a small MLP, as plain
functions on tensors and one ``nn.Module``. Random initialisers take an
explicit ``torch.Generator``; they draw on the generator's device and move
the result to ``device``, which defaults to ``"cuda"``.

Attention on the serving path is K6 behind ``kernels.ops.flash_attention``.
:func:`flash_attention_blocked` is the port of the JAX module's blocked
online-softmax ``flash_attention_jnp`` (a plain version that scans key
blocks), and :func:`mha_reference` its naive oracle; neither is on the
path.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterator, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..kernels.ref import flash_attention_ref

# ---------------------------------------------------------------------------
# initialisers


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """(d_in, d_out) uniform on [-1, 1) / sqrt(d_in), the JAX layout
    (``x @ w``)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.rand((d_in, d_out), generator=generator,
                   device=generator.device) * 2.0 - 1.0
    return (w * scale).to(device=resolve_device(device), dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """(vocab, d) normal with standard deviation 0.02."""
    e = torch.randn((vocab, d), generator=generator, device=generator.device)
    return (e * 0.02).to(device=resolve_device(device), dtype=dtype)


# ---------------------------------------------------------------------------
# norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, returned in x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * weight).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics (the population
    variance), returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_frequencies(d_head: int, max_seq: int, theta: float = 10_000.0,
                     device: str | torch.device = "cuda"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of positions 0 .. max_seq - 1, each (max_seq, d_head / 2)
    float32, computed in float64 on the host as the JAX package does."""
    return rope_at(d_head, np.arange(max_seq), theta, device)


def rope_at(d_head: int, positions: np.ndarray, theta: float = 10_000.0,
            device: str | torch.device = "cuda"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows of :func:`rope_frequencies` for the given positions only
    (a decode step needs one)."""
    inv = 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64)
                           / d_head))
    freqs = np.outer(np.asarray(positions, dtype=np.float64), inv)
    dev = resolve_device(device)
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)).to(dev),
            torch.from_numpy(np.sin(freqs).astype(np.float32)).to(dev))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, Dh); positions (..., S) integer. Rotates the two halves
    of the head dimension in float32; returns x's dtype."""
    c = cos[positions][..., None, :]          # (..., S, 1, Dh/2)
    s = sin[positions][..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (plain versions; the serving path runs K6)


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            block_kv: int = 1024,
                            q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over key blocks of ``block_kv``, the port of
    ``flash_attention_jnp``: q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh)
    with Hq % Hkv == 0; query i sits at ``q_offset + i``. Running max, sum
    and output in float32; a masked score is -1e30; out in q's dtype."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    groups = Hq // Hkv
    # the JAX function's numpy-float scale promotes q to float32 first
    qf = (q.float() * (1.0 / math.sqrt(Dh))).reshape(B, Sq, Hkv, groups, Dh)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, Sq, Hkv, groups), -1e30, device=q.device)
    den = torch.zeros((B, Sq, Hkv, groups), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, groups, Dh), device=q.device)
    for k0 in range(0, Skv, block_kv):
        kb = k[:, k0:k0 + block_kv].float()
        vb = v[:, k0:k0 + block_kv].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        if causal:
            kv_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.tensor(-1e30, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p,
                                                   vb)
        m = m_new
    out = acc / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, Hq, Dh).to(q.dtype)


# naive attention with the whole (Sq, Skv) score matrix, the JAX module's
# test oracle: here it is K6's plain version
mha_reference = flash_attention_ref


# ---------------------------------------------------------------------------
# activations / MLP


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# jax.nn.gelu approximates with tanh by default, so "gelu" does too
_ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": _gelu_tanh, "silu": F.silu, "relu": F.relu,
    "gelu_tanh": _gelu_tanh, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "dice_like": torch.sigmoid}


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return _ACTS[name]


class MLP(nn.Module):
    """Dense layers ``x @ w + b`` with the JAX layout: ``weights[i]`` is
    (d_in, d_out). Parameters are made frozen (the serving paths need no
    gradient); ``requires_grad_(True)`` makes them trainable."""

    def __init__(self, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor] | None = None):
        super().__init__()
        self.weights = nn.ParameterList(
            nn.Parameter(w, requires_grad=False) for w in weights)
        self.biases = None if biases is None else nn.ParameterList(
            nn.Parameter(b, requires_grad=False) for b in biases)
        if biases is not None and len(biases) != len(weights):
            raise ValueError("one bias per layer")

    def forward(self, x: torch.Tensor, activation: str = "relu",
                final_act: bool = False) -> torch.Tensor:
        return mlp_apply(self, x, activation, final_act)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module, keyed as the JAX package's
    pytree: a dict becomes a submodule, a list an ``nn.ModuleList`` (its
    dicts submodules), a module (an :class:`MLP`) stays itself, and a
    tensor becomes a frozen parameter (the serving paths need no gradient).
    ``tree["key"]`` reads as a dict. The one way to make a tree trainable
    is ``nn.Module.requires_grad_(True)``, which the GNN train step
    (``GNNArch.build_step``) takes; :func:`tree_leaves` lists the
    parameters in the JAX pytree's order."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, nn.Module):
                self.add_module(key, value)
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v) if isinstance(v, Mapping) else v
                    for v in value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def keys(self) -> Iterator[str]:
        yield from self._parameters
        yield from self._modules


def tree_leaves(tree) -> list:
    """The leaves of a parameter tree in the order of ``jax.tree.leaves``
    of the JAX package's pytree: a dict's (a module's, such as a
    :class:`ParamTree` or DIN's module: its parameters' and submodules'
    names) keys sorted, a list's items in order, an :class:`MLP` as the JAX
    list of {"w", "b"} layers (each layer's "b" before its "w"). Also takes
    that pytree itself as nested dicts and lists of arrays, and a sequence
    of leaves, which it returns as a list."""
    if isinstance(tree, MLP):
        out = []
        for i, w in enumerate(tree.weights):
            if tree.biases is not None:
                out.append(tree.biases[i])
            out.append(w)
        return out
    if isinstance(tree, (nn.ModuleList, list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    if isinstance(tree, nn.Module):
        items = {**tree._parameters, **tree._modules}
        return [leaf for key in sorted(items)
                for leaf in tree_leaves(items[key])]
    if isinstance(tree, Mapping):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             dtype: torch.dtype = torch.float32, bias: bool = True,
             device: str | torch.device = "cuda") -> MLP:
    """Layers dims[0] -> dims[1] -> ... with ``dense_init`` weights and zero
    biases."""
    dev = resolve_device(device)
    weights = [dense_init(generator, a, b, dtype, dev)
               for a, b in zip(dims[:-1], dims[1:])]
    biases = [torch.zeros(b, dtype=dtype, device=dev) for b in dims[1:]] \
        if bias else None
    return MLP(weights, biases)


def mlp_apply(mlp: MLP, x: torch.Tensor, activation: str = "relu",
              final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` layer by layer, ``activation`` between the layers (and
    after the last with ``final_act``)."""
    fn = act_fn(activation)
    n = len(mlp.weights)
    for i, w in enumerate(mlp.weights):
        x = x @ w
        if mlp.biases is not None:
            x = x + mlp.biases[i]
        if i < n - 1 or final_act:
            x = fn(x)
    return x


# ---------------------------------------------------------------------------
# the LM loss


class _CrossEntropy(torch.autograd.Function):
    """The mean token cross-entropy with its backward written out: the
    gradient of a logit row is (softmax - one-hot of the label) times the
    row's weight (1 / the number of counted labels, 0 for an ignored
    label), formed in float32 with the one-hot as a non-accumulating store,
    so the backward has no scatter that adds (autograd's own backward of
    the gather would be a float ``scatter_add_``)."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_id):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        idx = labels.clamp(min=0).long()[..., None]
        gold = torch.gather(lf, -1, idx)[..., 0]
        del lf
        valid = (labels != ignore_id).float()
        count = torch.clamp(valid.sum(), min=1.0)
        ctx.save_for_backward(logits, lse, idx, valid, count)
        return ((lse - gold) * valid).sum() / count

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, valid, count = ctx.saved_tensors
        grad = logits.float()
        grad.sub_(lse[..., None]).exp_()                 # softmax
        grad.scatter_(-1, idx, torch.gather(grad, -1, idx) - 1.0)
        grad.mul_((valid * (g / count))[..., None])
        return grad.to(logits.dtype), None, None


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy of logits (..., V) against integer labels
    (...): the logsumexp in float32, a label ``ignore_id`` not counted, the
    sum over the counted labels divided by their number (at least 1), as
    the JAX package's ``cross_entropy_loss``. A float32 scalar; its
    gradient in the logits is in their dtype."""
    return _CrossEntropy.apply(logits, labels, ignore_id)


# ---------------------------------------------------------------------------
# the JAX package's parameters carried across


def tensor_from_numpy(a: np.ndarray, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """One array to a tensor on ``device``; a bfloat16 array (which numpy
    only knows through ``ml_dtypes``) is carried bit for bit."""
    a = np.array(a, copy=True, order="C")     # owned, writable, contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=resolve_device(device),
                dtype=dtype if dtype is not None else t.dtype)
