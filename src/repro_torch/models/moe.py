"""Mixture-of-experts feed-forward, the port of ``repro/models/moe.py``
(moonshot: 64 experts, top 6, 2 shared; qwen2-moe: 60 experts, top 4, 4
shared).

The dispatch is the JAX package's ``_moe_apply_gather``: the router runs in
float32 and picks each token's top k experts; the (token, k) entries are
bucketed by expert with a stable sort into C capacity slots an expert; the
experts' GLU feed-forwards run as batched products over (E, C, d); each
token's k outputs are gathered back and summed with the renormalised gate
weights. Entries beyond an expert's capacity are dropped (Switch/GShard
semantics: ``capacity_factor`` sets the drop rate). Shared experts are a
dense GLU added at the end.

``ep_mode="local_select"`` is, in the reference, a ``shard_map`` over a
``model`` mesh axis that falls back to the gather dispatch when no such
mesh is active. The port has no model mesh (one card), so both values run
the gather dispatch.

On the card the dispatch makes no host sync and adds no float with
atomics, so a call repeats its bits: experts are counted by an integer
``scatter_add_`` (``torch.bincount`` on CUDA reads the ids' maximum back
to the host), the capacity C is a host int from the static token count,
and the combine gathers each token's k entries through the inverse of the
sort order and adds them in k order (an ``index_add_`` would add them
with float atomics on the card).

Training keeps that rule. Autograd's backward of a ``rows[index]`` gather
is an accumulating ``index_put_``, float atomics on the card; the dispatch
and the combine gather through :class:`GatherRows` instead, whose
backward gathers the incoming gradient through the inverse index and adds
a source row's terms in k order: a token's K slots for the dispatch, the
one entry that fills a slot for the combine. Nothing is scattered.

The stages are module functions (:func:`route`, :func:`bucket`,
:func:`dispatch`, :func:`experts`, :func:`combine`), called by name from
:func:`moe_apply`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .._device import resolve_device
from .common import act_fn, dense_init


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0          # 0 -> same as d_ff_expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    act: str = "silu"
    # "gather" and "local_select" (the reference's expert-parallel
    # shard_map) both run the gather dispatch here: the port has no model
    # mesh
    ep_mode: str = "gather"

    @property
    def shared_ff(self) -> int:
        return self.d_ff_shared or self.d_ff_expert

    def capacity(self, num_tokens: int) -> int:
        c = int(num_tokens * self.top_k * self.capacity_factor
                / self.num_experts) + 1
        return max(8, -(-c // 8) * 8)   # pad to a multiple of 8


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32,
             device: str | torch.device = "cuda") -> dict[str, Any]:
    """The JAX initialisers and layouts: ``router`` (d, E) in float32
    whatever ``dtype``; ``w_gate`` and ``w_up`` (E, d, F), each drawn as one
    (d, E F) ``dense_init`` and reshaped and transposed; ``w_down`` (E, F,
    d), drawn as one (E F, d); with shared experts, ``shared`` holds a
    dense GLU of width ``shared_ff * num_shared``."""
    dev = resolve_device(device)
    E, F = cfg.num_experts, cfg.d_ff_expert

    def experts_in() -> torch.Tensor:
        w = dense_init(generator, d_model, E * F, dtype, dev)
        return w.reshape(d_model, E, F).transpose(0, 1).contiguous()

    params: dict[str, Any] = {
        "router": dense_init(generator, d_model, E, torch.float32, dev),
        "w_gate": experts_in(),
        "w_up": experts_in(),
        "w_down": dense_init(generator, E * F, d_model, dtype,
                             dev).reshape(E, F, d_model),
    }
    if cfg.num_shared:
        Fs = cfg.shared_ff * cfg.num_shared
        params["shared"] = {
            "w_gate": dense_init(generator, d_model, Fs, dtype, dev),
            "w_up": dense_init(generator, d_model, Fs, dtype, dev),
            "w_down": dense_init(generator, Fs, d_model, dtype, dev),
        }
    return params


def route(params, cfg: MoEConfig, xt: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d) -> (logits (T, E) and probabilities, float32; gate weights
    (T, K) float32, renormalised with a 1e-9 floor; gate ids (T, K) int64,
    by falling probability). The router's product runs in float32."""
    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_w, gate_i


def bucket(gate_i: torch.Tensor, num_experts: int, capacity: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """Capacity slots for the (token, k) entries of gate_i (T, K): entries
    sorted stably by expert, so that an expert keeps its first C entries in
    (token, k) order and drops the rest. Returns (counts (E,) int64, the
    entries routed to each expert; slot_token (E C,) int64, the token whose
    row fills each slot, T for an empty one; entry_slot (T K,) int64, each
    entry's slot in (token, k) order, E C for a dropped one; slot_entry
    (E C,) int64, the entry that fills each slot, T K for an empty one)."""
    T, K = gate_i.shape
    E, C = num_experts, capacity
    flat_e = gate_i.reshape(T * K)
    # an integer scatter_add_: exact in any order, and no readback (CUDA's
    # bincount reads the ids' maximum back to the host)
    counts = torch.zeros(E, dtype=torch.long, device=flat_e.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    sorted_e, order = torch.sort(flat_e, stable=True)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=flat_e.device) - offsets[sorted_e]
    slot = torch.where(rank < C, sorted_e * C + rank, E * C)
    entry_slot = torch.empty_like(slot).scatter_(0, order, slot)
    # every dropped entry lands in slot E C, in no set order among
    # duplicates; that slot is cut off and never read
    slot_entry = torch.full((E * C + 1,), T * K, dtype=torch.long,
                            device=flat_e.device
                            ).scatter_(0, slot, order)[:E * C]
    return counts, slot_entry // K, entry_slot, slot_entry


def _with_zero_row(rows: torch.Tensor) -> torch.Tensor:
    return torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])


class GatherRows(torch.autograd.Function):
    """src (n_src, d) gathered through ``index`` (n_out,) into (n_out, d),
    where index n_src reads a zero row. ``inverse`` (n_src, K') lists the
    outputs that read each source row (n_out for none), and each output
    is in at most one row's list. The backward gathers the incoming
    gradient through ``inverse`` and adds a row's K' terms in k order:
    d src[s] = sum_k g[inverse[s, k]], a fixed order and no scatter, where
    autograd's backward of ``src[index]`` adds with float atomics on the
    card."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _with_zero_row(src)[index]

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        terms = _with_zero_row(g)[inverse]
        out = terms[:, 0]
        for k in range(1, terms.shape[1]):
            out = out + terms[:, k]
        return out, None, None


def dispatch(xt: torch.Tensor, slot_token: torch.Tensor,
             entry_slot: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The experts' inputs (E, C, d): token rows gathered into their slots,
    zeros in an empty slot. A token's gradient is its K slots' gradients
    added in k order, a dropped entry's a zero row."""
    T, d = xt.shape
    rows = GatherRows.apply(xt, slot_token, entry_slot.reshape(T, -1))
    return rows.reshape(num_experts, -1, d)


def experts(params, cfg: MoEConfig, expert_in: torch.Tensor) -> torch.Tensor:
    """Each expert's GLU feed-forward over its slots: (E, C, d) -> (E, C,
    d), as batched products."""
    h = act_fn(cfg.act)(torch.bmm(expert_in, params["w_gate"])) \
        * torch.bmm(expert_in, params["w_up"])
    return torch.bmm(h, params["w_down"])


def combine(out: torch.Tensor, entry_slot: torch.Tensor,
            slot_entry: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """y (T, d) in out's dtype from the experts' outputs (E, C, d): each
    token's K entries gathered into (T, K, d) through ``entry_slot`` (a
    dropped entry reads a zero row), times its gate weight in out's dtype,
    and added in k order. A slot's gradient is that of the one entry in
    ``slot_entry`` that fills it (none for an empty slot)."""
    T, K = gate_w.shape
    d = out.shape[-1]
    rows = GatherRows.apply(out.reshape(-1, d), entry_slot,
                            slot_entry[:, None])
    per_entry = rows.reshape(T, K, d) * gate_w.to(out.dtype)[..., None]
    y = per_entry[:, 0]
    for k in range(1, K):
        y = y + per_entry[:, k]
    return y


def moe_apply(params, cfg: MoEConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, the Switch aux loss, a
    float32 scalar). C = ``cfg.capacity(B S)``: a prefill and a decode step
    have different capacities."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.top_k
    xt = x.reshape(T, d)
    _, probs, gate_w, gate_i = route(params, cfg, xt)
    counts, slot_token, entry_slot, slot_entry = bucket(gate_i, E,
                                                        cfg.capacity(T))
    # E * sum_e f_e p_e, f_e from integer counts (the reference adds float
    # 1 / (T K) an entry: the two agree to rounding)
    aux = E * torch.sum(counts.float() / (T * K) * probs.mean(dim=0))
    out = experts(params, cfg, dispatch(xt, slot_token, entry_slot, E))
    y = combine(out, entry_slot, slot_entry, gate_w)
    if "shared" in params:
        sp = params["shared"]
        hs = act_fn(cfg.act)(xt @ sp["w_gate"]) * (xt @ sp["w_up"])
        y = y + hs @ sp["w_down"]
    return y.reshape(B, S, d), aux
