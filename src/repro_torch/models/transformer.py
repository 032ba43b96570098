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
under ``jax.checkpoint`` and places sharding constraints; the port loops
over the layers and has neither (both are compile and sharding devices of
JAX; this is one card).

Entry points, inference only:
    prefill_step  tokens -> last-token logits + KV cache
    decode_step   one token + KV cache -> logits, cache written in place
    forward       tokens -> final hidden states

Attention goes through ``kernels.ops.flash_attention`` (K6 on the card) at
the two places where the JAX model calls ``flash_attention_jnp``. The
projections, the feed-forward (dense, or the experts' batched products of
``models/moe.py``) and the unembedding are plain products.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import ops
from .common import (ParamTree, act_fn, apply_rope, dense_init, embed_init,
                     rms_norm, rope_at, rope_frequencies, tensor_from_numpy)
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
               kv_cache: torch.Tensor | None = None, cache_len: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal self-attention of x (B, S, d). With ``kv_cache`` (2, B, Smax,
    Hkv, Dh) the new keys and values are written into it at ``cache_len``
    (in place) and the queries attend to the cache; without, to
    themselves, and the (2, B, S, Hkv, Dh) keys and values are returned as
    the cache."""
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
        cache = torch.stack([k, v])
        out = ops.flash_attention(q, k, v, causal=True)
    return out.reshape(B, S, H * dh) @ p["wo"], cache


def _layer(p: dict, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, positions: torch.Tensor,
           kv_cache: torch.Tensor | None = None,
           cache_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    h, cache = _attention(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                          cos, sin, positions, kv_cache=kv_cache,
                          cache_len=cache_len)
    x = x + h
    y = rms_norm(x, p["ln2"], cfg.norm_eps)
    fp = p["ffn"]
    if cfg.moe is not None:
        # the aux loss is training's: serving drops it
        return x + moe_apply(fp, cfg.moe, y)[0], cache
    hh = act_fn(cfg.act)(y @ fp["w_gate"]) * (y @ fp["w_up"])
    return x + hh @ fp["w_down"], cache


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


def make_kv_cache(cfg: LMConfig, batch: int, max_seq: int,
                  dtype: torch.dtype | None = None,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """A zeroed (L, 2, B, max_seq, Hkv, Dh) cache."""
    return torch.zeros((cfg.n_layers, 2, batch, max_seq, cfg.n_kv_heads,
                        cfg.head_dim), dtype=dtype or cfg.torch_dtype(),
                       device=resolve_device(device))
