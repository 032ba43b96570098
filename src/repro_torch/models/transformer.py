"""Decoder-only LM for serving, the port of ``repro/models/transformer.py``.

One implementation spans the dense architectures of the JAX package: GQA
and MQA (``n_kv_heads``), an explicit head dim (gemma-2b's 256 is not
d_model / n_heads), GLU feed-forwards (GeGLU, SwiGLU), QKV bias, tied
embeddings, RoPE and RMSNorm, and a mixture-of-experts feed-forward
(``models/moe.py``: moonshot and qwen2-moe, routed top-k experts beside
shared ones).

Parameters are a :class:`DecoderLM`, an ``nn.Module`` on one device whose
tree of frozen parameters is keyed as the JAX package's pytree: every leaf
of ``params["layers"]`` is stacked over a leading (L,) axis, and weights
are (d_in, d_out) for ``x @ w``. :func:`params_from_numpy` loads the JAX
``init`` pytree into it. The JAX module scans over the stacked layers
and places sharding constraints; the port loops over the layers and has
no constraints (a sharding device of JAX; this is one card). Training
recomputes each layer in the backward, as the JAX module's
``jax.checkpoint`` with the policy "nothing" does (``cfg.remat``), through
``torch.utils.checkpoint``.

Entry points:
    loss_fn         tokens, labels -> mean token cross-entropy (training)
    value_and_grad  tokens, labels -> (loss, every parameter's gradient)
    prefill_step    tokens -> last-token logits + KV cache
    decode_step     one token + KV cache -> logits, cache written in place
    forward         tokens -> final hidden states

Attention goes through ``kernels.ops.flash_attention`` (K6 on the card) at
the two places where the JAX model calls ``flash_attention_jnp``; in
training its backward is K6's backward kernels. The projections, the
feed-forward (dense, or the experts' batched products of ``models/moe.py``)
and the unembedding are plain products. The serving steps run under
``no_grad`` and never build a training graph.

Training's gradients land as the serving tree holds the parameters: the
token embedding's through ``ops.gather_rows`` (a fold of the gradient rows
by token over the batch's plan, no accumulating ``index_put_``), each
layer's into its own slice of a leaf's stack (each layer reads its own
leaves, detached views of the stacks, so no layer's backward writes a
zero stack), a tied embedding's as the unembedding's plus the gather's.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..kernels import ops
from .common import (ParamTree, act_fn, apply_rope, cross_entropy_loss,
                     dense_init, embed_init, rms_norm, rope_at,
                     rope_frequencies, tensor_from_numpy, tree_leaves)
from .moe import MoEConfig, moe_apply, moe_init

# leaves kept in float32 whatever the model's dtype: the MoE router
_FLOAT32_LEAVES = ("router",)


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None          # default d_model // n_heads
    act: str = "silu"                  # GLU gate (silu = SwiGLU, gelu = GeGLU)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    dtype: str = "bfloat16"
    remat: bool = True                 # training recomputes each layer

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None \
            else self.d_model // self.n_heads

    def _attn_params(self) -> int:
        dh, H, Hkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = self.d_model * dh * (H + 2 * Hkv) + H * dh * self.d_model
        if self.qkv_bias:
            attn += dh * (H + 2 * Hkv)
        return attn

    def _total(self, ffn: int) -> int:
        per_layer = self._attn_params() + ffn + 2 * self.d_model
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + self.d_model

    @property
    def param_count(self) -> int:
        if self.moe is None:
            return self._total(3 * self.d_model * self.d_ff)
        m = self.moe
        return self._total(m.num_experts * 3 * self.d_model * m.d_ff_expert
                           + self.d_model * m.num_experts
                           + 3 * self.d_model * m.shared_ff * m.num_shared)

    @property
    def active_param_count(self) -> int:
        """Parameters a token touches (MoE: its top_k experts, the router
        and the shared experts)."""
        if self.moe is None:
            return self.param_count
        m = self.moe
        return self._total(m.top_k * 3 * self.d_model * m.d_ff_expert
                           + self.d_model * m.num_experts
                           + 3 * self.d_model * m.shared_ff * m.num_shared)

    @property
    def flops_param_count(self) -> int:
        """Active parameters a token's products visit: all but the input
        embedding's gather, the unembedding counted once (tied or not)."""
        untied = 0 if self.tie_embeddings else self.vocab * self.d_model
        return self.active_param_count - untied

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# ---------------------------------------------------------------------------
# parameters (stacked layers)


class DecoderLM(ParamTree):
    """The LM's parameters on one device: ``embed`` (V, d), ``layers``
    (attn: wq, wk, wv, wo [, bq, bk, bv]; ffn: w_gate, w_up, w_down, or
    with MoE ``moe.moe_init``'s tree [router, w_gate, w_up, w_down, shared];
    ln1, ln2; each stacked over (L,)), ``final_norm`` and, untied,
    ``lm_head``.
    """

    def __init__(self, cfg: LMConfig, tree: Mapping):
        want = {"embed", "layers", "final_norm"} | (
            set() if cfg.tie_embeddings else {"lm_head"})
        if set(tree) != want:
            raise ValueError(f"expected keys {sorted(want)}, got "
                             f"{sorted(tree)}")
        L = tree["layers"]["ln1"].shape[0]
        if L != cfg.n_layers:
            raise ValueError(f"{L} stacked layers, config has {cfg.n_layers}")
        super().__init__(tree)
        self.cfg = cfg


def params_from_numpy(tree: Mapping, cfg: LMConfig,
                      device: str | torch.device = "cuda") -> DecoderLM:
    """``repro.models.transformer.init``'s pytree as numpy arrays (nested
    dicts; bfloat16 leaves as ``ml_dtypes`` arrays) -> a :class:`DecoderLM`
    in ``cfg``'s dtype on ``device``, bit for bit; the MoE router stays in
    float32, as the JAX package keeps it (in the model's dtype it would
    route bf16 models differently). The layouts are the same, so nothing
    is transposed."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype()

    def load(t: Mapping) -> dict:
        return {k: load(v) if isinstance(v, Mapping)
                else tensor_from_numpy(
                    v, dev, torch.float32 if k in _FLOAT32_LEAVES else dt)
                for k, v in t.items()}

    return DecoderLM(cfg, load(tree))


def init(cfg: LMConfig, generator: torch.Generator,
         device: str | torch.device = "cuda") -> DecoderLM:
    """Random parameters for ``cfg``: the JAX package's initialisers (not
    its values: the generators differ), drawn from ``generator`` layer by
    layer and stacked over (L,)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype()
    dh, H, Hkv, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    L = cfg.n_layers

    def stacked(d_in: int, d_out: int) -> torch.Tensor:
        out = torch.empty((L, d_in, d_out), dtype=dt, device=dev)
        for i in range(L):
            out[i] = dense_init(generator, d_in, d_out, dt, dev)
        return out

    params: dict = {"embed": embed_init(generator, cfg.vocab, d, dt, dev)}
    attn = {"wq": stacked(d, H * dh), "wk": stacked(d, Hkv * dh),
            "wv": stacked(d, Hkv * dh), "wo": stacked(H * dh, d)}
    if cfg.qkv_bias:
        for key, width in (("bq", H * dh), ("bk", Hkv * dh),
                           ("bv", Hkv * dh)):
            attn[key] = torch.zeros((L, width), dtype=dt, device=dev)
    if cfg.moe is None:
        ffn = {"w_gate": stacked(d, cfg.d_ff), "w_up": stacked(d, cfg.d_ff),
               "w_down": stacked(cfg.d_ff, d)}
    else:
        ffn = _stack_layers(L, lambda: moe_init(generator, d, cfg.moe, dt,
                                                dev))
    params["layers"] = {"attn": attn, "ffn": ffn,
                        "ln1": torch.ones((L, d), dtype=dt, device=dev),
                        "ln2": torch.ones((L, d), dtype=dt, device=dev)}
    params["final_norm"] = torch.ones(d, dtype=dt, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, d, cfg.vocab, dt, dev)
    return DecoderLM(cfg, params)


def _stack_layers(L: int, make) -> dict:
    """Trees ``make()`` for L layers, stacked leaf by leaf over (L,): each
    layer's tree is copied in as it is drawn, so that no more than the
    stack and a layer or two live at once."""
    def empty(t: Mapping) -> dict:
        return {k: empty(v) if isinstance(v, Mapping) else
                v.new_empty((L, *v.shape)) for k, v in t.items()}

    def put(out: Mapping, t: Mapping, i: int) -> None:
        for k, v in t.items():
            if isinstance(v, Mapping):
                put(out[k], v, i)
            else:
                out[k][i] = v

    tree = make()
    out = empty(tree)
    for i in range(L):
        put(out, tree if i == 0 else make(), i)
    return out


def layer_params(params: DecoderLM, i: int) -> dict:
    """Layer i's leaves (views into the stacked tensors)."""
    def pick(tree: ParamTree) -> dict:
        return {k: pick(tree[k]) if isinstance(tree[k], ParamTree)
                else tree[k][i] for k in tree.keys()}
    return pick(params["layers"])


# ---------------------------------------------------------------------------
# blocks


def _attention(p: dict, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, positions: torch.Tensor, *,
               kv_cache: torch.Tensor | None = None, cache_len: int = 0,
               keep_cache: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Causal self-attention of x (B, S, d). With ``kv_cache`` (2, B, Smax,
    Hkv, Dh) the new keys and values are written into it at ``cache_len``
    (in place) and the queries attend to the cache; without, to
    themselves, and the (2, B, S, Hkv, Dh) keys and values are returned as
    the cache (None without ``keep_cache``: training keeps none)."""
    B, S, _ = x.shape
    dh, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, H, dh), cos, sin, positions)
    k = apply_rope(k.reshape(B, S, Hkv, dh), cos, sin, positions)
    v = v.reshape(B, S, Hkv, dh)
    if kv_cache is not None:
        kv_cache[0, :, cache_len:cache_len + S] = k
        kv_cache[1, :, cache_len:cache_len + S] = v
        cache = kv_cache
        # the layer's cache slices as they lie: K6 takes their strides
        out = ops.flash_attention(q, kv_cache[0], kv_cache[1], causal=True,
                                  q_offset=cache_len)
    else:
        cache = torch.stack([k, v]) if keep_cache else None
        out = ops.flash_attention(q, k, v, causal=True)
    return out.reshape(B, S, H * dh) @ p["wo"], cache


def _block(p: dict, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, positions: torch.Tensor,
           kv_cache: torch.Tensor | None = None, cache_len: int = 0,
           keep_cache: bool = True
           ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """One layer: (x out, its cache, the MoE aux loss (0 for a dense
    feed-forward), float32)."""
    h, cache = _attention(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                          cos, sin, positions, kv_cache=kv_cache,
                          cache_len=cache_len, keep_cache=keep_cache)
    x = x + h
    y = rms_norm(x, p["ln2"], cfg.norm_eps)
    fp = p["ffn"]
    if cfg.moe is not None:
        ff, aux = moe_apply(fp, cfg.moe, y)
        return x + ff, cache, aux
    hh = act_fn(cfg.act)(y @ fp["w_gate"]) * (y @ fp["w_up"])
    return x + hh @ fp["w_down"], cache, torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _layer(p: dict, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, positions: torch.Tensor,
           kv_cache: torch.Tensor | None = None,
           cache_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """A serving layer: (x out, its cache); the aux loss is training's."""
    x, cache, _ = _block(p, cfg, x, cos, sin, positions, kv_cache, cache_len)
    return x, cache


def _train_layer(p: dict, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    x, _, aux = _block(p, cfg, x, cos, sin, positions, keep_cache=False)
    return x, aux


def _unembed(params: DecoderLM, cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def _embed(params: DecoderLM, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.torch_dtype())


# ---------------------------------------------------------------------------
# public steps


@torch.no_grad()
def forward(params: DecoderLM, cfg: LMConfig, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens (B, S) -> final hidden states (B, S, d)."""
    B, S = tokens.shape
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta,
                                tokens.device)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for i in range(cfg.n_layers):
        x, _ = _layer(layer_params(params, i), cfg, x, cos, sin, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


@torch.no_grad()
def prefill_step(params: DecoderLM, cfg: LMConfig, tokens: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (last-position logits (B, V) float32, KV cache
    (L, 2, B, S, Hkv, Dh)). Logits only for the final position, as
    serving wants the next token's."""
    B, S = tokens.shape
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta,
                                tokens.device)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    caches = torch.empty((cfg.n_layers, 2, B, S, cfg.n_kv_heads,
                          cfg.head_dim), dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        x, caches[i] = _layer(layer_params(params, i), cfg, x, cos, sin,
                              positions)
    h = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, h)[:, 0].float(), caches


@torch.no_grad()
def decode_step(params: DecoderLM, cfg: LMConfig, token: torch.Tensor,
                kv_cache: torch.Tensor, cache_len: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. token (B, 1); kv_cache (L, 2, B, Smax, Hkv, Dh);
    ``cache_len`` the number of positions already in the cache (a Python
    int or a 0-d tensor; it may change from call to call). Writes the new
    token's keys and values at ``cache_len`` in place, where the JAX
    package returns an updated copy, and returns (logits (B, V) float32,
    the same cache tensor)."""
    B = token.shape[0]
    Smax = kv_cache.shape[3]
    cache_len = int(cache_len)
    if not 0 <= cache_len < Smax:
        raise ValueError(f"cache_len {cache_len} outside a cache of {Smax}")
    # the one row of the rotary tables this step needs, at position 0
    cos, sin = rope_at(cfg.head_dim, np.array([cache_len]), cfg.rope_theta,
                       token.device)
    x = _embed(params, cfg, token)
    positions = torch.zeros((B, 1), dtype=torch.long, device=token.device)
    for i in range(cfg.n_layers):
        x, _ = _layer(layer_params(params, i), cfg, x, cos, sin, positions,
                      kv_cache=kv_cache[i], cache_len=cache_len)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, h)[:, 0].float(), kv_cache


# ---------------------------------------------------------------------------
# training


def _stacked(tree: ParamTree, path: tuple[str, ...] = ()
             ) -> list[tuple[tuple[str, ...], torch.Tensor]]:
    """(path, stacked leaf) of every leaf of ``params["layers"]``."""
    out = []
    for key in tree.keys():
        value = tree[key]
        if isinstance(value, ParamTree):
            out += _stacked(value, path + (key,))
        else:
            out.append((path + (key,), value))
    return out


def _nest(pairs: list[tuple[tuple[str, ...], torch.Tensor]]) -> dict:
    out: dict = {}
    for path, value in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def _train_loss(top: Mapping, layers: list[dict], cfg: LMConfig,
                tokens: torch.Tensor, labels: torch.Tensor, remat: bool
                ) -> torch.Tensor:
    """The loss on trainable leaves: ``top`` holds "embed" (the gather's
    table), "unembed" (the unembedding: the table again, tied, or
    ``lm_head``) and "final_norm"; ``layers`` one tree a layer. The
    token embedding's gradient is a fold over the plan of the tokens
    (``ops.gather_rows``); with ``remat`` each layer is recomputed in the
    backward."""
    B, S = tokens.shape
    flat = tokens.reshape(-1)
    plan = ops.segment_plan(flat, cfg.vocab, keep_index=False)
    x = ops.gather_rows(top["embed"], flat, plan).reshape(B, S, -1).to(
        cfg.torch_dtype())
    cos, sin = rope_frequencies(cfg.head_dim, S, cfg.rope_theta,
                                tokens.device)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for p in layers:
        if remat:
            x, aux = checkpoint(_train_layer, p, cfg, x, cos, sin, positions,
                                use_reentrant=False)
        else:
            x, aux = _train_layer(p, cfg, x, cos, sin, positions)
        aux_total = aux_total + aux
    h = rms_norm(x, top["final_norm"], cfg.norm_eps)
    head = top["unembed"]
    logits = h @ (head.T if cfg.tie_embeddings else head)
    loss = cross_entropy_loss(logits, labels)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux_total
    return loss


def loss_fn(params: DecoderLM, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """tokens, labels (B, S) -> the mean token cross-entropy of the next
    token (float32 logsumexp, labels -1 ignored), plus the routers' aux
    loss times ``router_aux_weight`` for an MoE: the JAX ``loss_fn``.
    Differentiable in the parameters where they require a gradient (see
    :func:`value_and_grad`, which gives every leaf its own)."""
    top = {"embed": params["embed"], "final_norm": params["final_norm"],
           "unembed": params["embed"] if cfg.tie_embeddings
           else params["lm_head"]}
    layers = [layer_params(params, i) for i in range(cfg.n_layers)]
    return _train_loss(top, layers, cfg, tokens, labels,
                       cfg.remat and torch.is_grad_enabled())


def value_and_grad(params: DecoderLM, cfg: LMConfig, tokens: torch.Tensor,
                   labels: torch.Tensor
                   ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """(loss, grads): :func:`loss_fn` and its gradient in every parameter,
    a tuple in the JAX pytree's leaf order (``tree_leaves``), as
    ``jax.value_and_grad`` gives it. Each layer reads detached views of
    the stacked leaves, so each layer's gradient is its own tensor, and
    the stacks' gradients are those stacked in layer order; a tied
    embedding's gradient is the unembedding's plus the gather's.
    ``cfg.remat`` recomputes each layer in the backward; the gradients'
    bits are the same either way."""

    def leaf(t: torch.Tensor) -> torch.Tensor:
        return t.detach().requires_grad_(True)

    stacks = _stacked(params["layers"])
    with torch.enable_grad():
        top = {"embed": leaf(params["embed"]),
               "final_norm": leaf(params["final_norm"]),
               "unembed": leaf(params["embed"] if cfg.tie_embeddings
                               else params["lm_head"])}
        views = [[leaf(stack[i]) for _, stack in stacks]
                 for i in range(cfg.n_layers)]
        layers = [_nest([(path, v) for (path, _), v in zip(stacks, row)])
                  for row in views]
        loss = _train_loss(top, layers, cfg, tokens, labels, cfg.remat)
        inputs = [top["embed"], top["unembed"], top["final_norm"],
                  *(v for row in views for v in row)]
        got = torch.autograd.grad(loss, inputs, allow_unused=True,
                                  materialize_grads=True)
    del layers, views
    got = list(got)
    g_embed, g_unembed, g_norm = got[:3]
    by_leaf = {id(params["final_norm"]): g_norm}
    if cfg.tie_embeddings:
        by_leaf[id(params["embed"])] = g_unembed + g_embed
    else:
        by_leaf[id(params["embed"])] = g_embed
        by_leaf[id(params["lm_head"])] = g_unembed
    del g_embed, g_unembed
    # each stack's gradient in layer order, the layers' own freed as it is
    # written
    n = len(stacks)
    for j, (_, stack) in enumerate(stacks):
        rows = range(3 + j, len(got), n)
        by_leaf[id(stack)] = torch.stack([got[i] for i in rows])
        for i in rows:
            got[i] = None
    return loss.detach(), tuple(by_leaf[id(p)] for p in tree_leaves(params))


def model_flops_per_token(cfg: LMConfig) -> float:
    """MODEL_FLOPS = 6 N_active a trained token (2 forward + 4 backward)."""
    return 6.0 * cfg.active_param_count


def make_kv_cache(cfg: LMConfig, batch: int, max_seq: int,
                  dtype: torch.dtype | None = None,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """A zeroed (L, 2, B, max_seq, Hkv, Dh) cache."""
    return torch.zeros((cfg.n_layers, 2, batch, max_seq, cfg.n_kv_heads,
                        cfg.head_dim), dtype=dtype or cfg.torch_dtype(),
                       device=resolve_device(device))
