"""Port parity of the mixture-of-experts feed-forward (``models/moe.py``)
against the JAX package's ``moe_apply`` with ``ep_mode="gather"`` (its
``local_select`` mode is not the reference here: it fails its own
single-shard test on this tree). The JAX parameters are carried across
leaf by leaf, and the inputs are numpy draws from a seed.

Tolerances: float32 at rtol 1e-5 with atol 1e-5 of max|y|, the aux loss at
rtol 1e-6 (the port counts experts in integers, the reference adds float
1 / (T K) an entry); bfloat16 at 2e-2, as the LM tests. Top-k routing is
compared first: ``jax.lax.top_k`` and ``torch.topk`` need not order equal
probabilities alike, so a tie would show there, not as a wrong output.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from repro_torch.models.common import tensor_from_numpy

KEY = jax.random.PRNGKey(3)

# (E, K, F, shared, d_ff_shared, capacity factor, B, S, d)
CASES = {
    "top1": (4, 1, 16, 0, 0, 1.25, 2, 16, 32),
    "top2": (6, 2, 16, 0, 0, 1.25, 2, 24, 32),
    "top2_shared": (6, 2, 16, 2, 0, 1.25, 2, 24, 32),
    "top4_wide_shared": (8, 4, 24, 1, 40, 1.25, 3, 10, 48),
    "top2_drops": (4, 2, 16, 1, 0, 0.3, 2, 32, 32),
    "top1_drops": (2, 1, 8, 0, 0, 0.05, 1, 64, 16),
}


def _config(name: str, module):
    E, K, F, shared, dfs, cf, *_ = CASES[name]
    return module.MoEConfig(num_experts=E, top_k=K, d_ff_expert=F,
                            num_shared=shared, d_ff_shared=dfs,
                            capacity_factor=cf)


def _pair(name: str, dtype=jnp.float32):
    """(JAX config, port config, JAX params, port params, x as numpy)."""
    B, S, d = CASES[name][-3:]
    jcfg, tcfg = _config(name, jmoe), _config(name, tmoe)
    jp = jmoe.moe_init(KEY, d, jcfg, dtype)
    tp = jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jp)
    x = np.random.default_rng(sum(map(ord, name))).standard_normal(
        (B, S, d)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _jax_gates(jp, jcfg, x):
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])


def _first_c(gate_i: np.ndarray, E: int, C: int) -> np.ndarray:
    """Dropped (token, k) entries by the definition: an entry is kept when
    fewer than C earlier entries, in (token, k) order, went to its
    expert."""
    flat = gate_i.reshape(-1)
    seen = np.zeros(E, np.int64)
    dropped = np.zeros(flat.shape, bool)
    for i, e in enumerate(flat):
        dropped[i] = seen[e] >= C
        seen[e] += 1
    return dropped.reshape(gate_i.shape)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_jax_gather(name):
    jcfg, tcfg, jp, tp, x = _pair(name)
    tx = torch.from_numpy(x)
    _, _, _, gate_i = tmoe.route(tp, tcfg, tx.reshape(-1, x.shape[-1]))
    jgate = _jax_gates(jp, jcfg, x)
    np.testing.assert_array_equal(gate_i.numpy(), jgate)
    # the same entries dropped: the port's buckets against the definition
    T, E = jgate.shape[0], tcfg.num_experts
    C = tcfg.capacity(T)
    counts, slot_token, entry_slot, slot_entry = tmoe.bucket(gate_i, E, C)
    dropped = _first_c(jgate, E, C)
    np.testing.assert_array_equal((entry_slot == E * C).numpy(),
                                  dropped.reshape(-1))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(jgate.reshape(-1), minlength=E))
    kept = entry_slot[entry_slot < E * C]
    assert kept.unique().numel() == kept.numel()    # a slot an entry
    np.testing.assert_array_equal(
        slot_token[kept].numpy(),
        np.nonzero(~dropped.reshape(-1))[0] // tcfg.top_k)
    # slot_entry inverts entry_slot on the kept entries, T K elsewhere
    np.testing.assert_array_equal(slot_entry[kept].numpy(),
                                  np.nonzero(~dropped.reshape(-1))[0])
    empty = torch.ones(E * C, dtype=torch.bool)
    empty[kept] = False
    assert (slot_entry[empty] == T * tcfg.top_k).all()
    assert (slot_token[empty] == T).all()
    if tcfg.capacity_factor < 1:
        assert dropped.any()
    else:
        assert not dropped.any()
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(tp, tcfg, tx)
    jy = np.asarray(jy)
    assert ty.dtype == torch.float32 and ty.shape == jy.shape
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jy).max()))
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_drops_overflow_at_tiny_capacity():
    """Mirror of the JAX test of the same name, inside the port."""
    _, tcfg, _, tp, x = _pair("top1_drops")
    hi = dataclasses.replace(tcfg, capacity_factor=8.0)
    y_hi, _ = tmoe.moe_apply(tp, hi, torch.from_numpy(x))
    y_lo, _ = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert float((y_hi - y_lo).abs().max()) > 1e-3


def test_local_select_runs_the_gather_dispatch():
    jcfg, tcfg, jp, tp, x = _pair("top2_shared")
    local = dataclasses.replace(tcfg, ep_mode="local_select")
    y_g, aux_g = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    y_l, aux_l = tmoe.moe_apply(tp, local, torch.from_numpy(x))
    assert torch.equal(y_g, y_l) and torch.equal(aux_g, aux_l)


def test_moe_bfloat16_keeps_the_router_float32():
    jcfg, tcfg, jp, tp, x = _pair("top4_wide_shared", jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["w_gate"].dtype == tp["shared"]["w_down"].dtype \
        == torch.bfloat16
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = tensor_from_numpy(np.asarray(jx), "cpu")
    _, _, _, gate_i = tmoe.route(tp, tcfg, tx.reshape(-1, x.shape[-1]))
    np.testing.assert_array_equal(gate_i.numpy(),
                                  _jax_gates(jp, jcfg, np.asarray(jx)))
    jy, jaux = jmoe.moe_apply(jp, jcfg, jx)
    ty, taux = tmoe.moe_apply(tp, tcfg, tx)
    assert ty.dtype == torch.bfloat16
    jy = np.asarray(jy, np.float32)
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=2e-2,
                               atol=2e-2 * float(np.abs(jy).max()))
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("name", ["top2_shared", "top4_wide_shared"])
def test_moe_init_matches_jax_layouts(name):
    """``moe_init``'s tree: the JAX leaves' names, shapes and dtypes (the
    router float32 in a bfloat16 model), and JAX's dense_init scales."""
    _, tcfg, jp, _, _ = _pair(name, jnp.bfloat16)
    d = CASES[name][-1]
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), d, tcfg,
                       torch.bfloat16, "cpu")
    jflat = {jax.tree_util.keystr(k): a for k, a in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(k): a for k, a in
             jax.tree_util.tree_flatten_with_path(
                 tp, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]}
    assert {k: (a.shape, str(a.dtype)) for k, a in jflat.items()} == \
        {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
         for k, t in tflat.items()}
    E, F = tcfg.num_experts, tcfg.d_ff_expert
    for key, fan_in in (("w_gate", d), ("w_down", E * F)):
        top = float(tp[key].float().abs().max())   # rounded to bfloat16
        assert 0.9 * fan_in ** -0.5 < top <= fan_in ** -0.5 * (1 + 2**-8)
