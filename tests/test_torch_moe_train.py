"""Port parity of MoE LM training against the JAX package on the CPU.

* ``moe.GatherRows`` (the dispatch's and the combine's gather, whose
  backward adds a row's terms in k order with no scatter) under
  ``torch.autograd.gradcheck`` in float64: both uses, with the zero-row
  sentinel, with dropped entries and with K' of 1 and K.
* The MoE layer's output, aux loss and every gradient (the router, the
  experts, the shared experts, the input) against
  ``jax.value_and_grad`` of the JAX ``_moe_apply_gather`` in float64
  (``jax.enable_x64``), on qwen2-moe's and moonshot's SMOKE MoE, with and
  without drops and shared experts.
* ``transformer.loss_fn``/``value_and_grad`` on both SMOKE LMs against
  JAX's float64 ``value_and_grad(transformer.loss_fn)``.
* Per-layer remat on against off: the same bits.
* One ``build_step("train_4k", smoke=True)`` step with ``grad_accum`` 1
  and 2 against the JAX ``LMArch`` train step from the same AdamW state.
* The step with ``ops`` routed to stand-ins of the CUDA wrappers: no
  float scatter, and K6's launches as ``chip_smoke.lm_train_launches``
  counts them.
* ``model_flops``/``model_bytes`` of ``train_4k`` equal to the JAX
  package's for both MoE arch ids, at the published shape and cut.

The gradients are defined only on one routing, so each comparison first
asserts that the port's top-k ids, and the entries it drops, are the
reference's: a near tie shows there, not as a gradient error. The
comparisons are one step each: over many steps, rounding may flip a top-k
choice between the two packages.

Tolerances are those of ``tests/test_torch_lm_train.py``: the loss at rtol
1e-5; gradients at rtol 1e-4 with atol 1e-6 x the leaf's largest |entry|;
first moments at the gradients' rtol, second moments at twice it. The
parameters after a step: the same, plus what the gradients' tolerance
lets AdamW's first update move (``_update_slack``: near eps the update
lr g / (|g| + eps) follows |g|, and where the tolerance reaches |g| its
sign is not held).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import chip_smoke
from repro.configs import base as jbase
from repro.configs import get_arch as j_get_arch
from repro.configs import moonshot_v1_16b_a3b as j_moonshot
from repro.configs import qwen2_moe_a2_7b as j_qwen2_moe
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.optim import adamw as jadamw
from repro_torch.configs import get_arch, moonshot_v1_16b_a3b, qwen2_moe_a2_7b
from repro_torch.configs.base import LMArch
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.common import tensor_from_numpy, tree_leaves
from repro_torch.optim import adamw_init, state_from_numpy

CONFIGS = {"qwen2_moe": (j_qwen2_moe.SMOKE, qwen2_moe_a2_7b.SMOKE),
           "moonshot": (j_moonshot.SMOKE, moonshot_v1_16b_a3b.SMOKE)}
ARCH_IDS = {"qwen2_moe": "qwen2-moe-a2.7b", "moonshot": "moonshot-v1-16b-a3b"}
MOE_IDS = tuple(ARCH_IDS.values())
DROP_FACTOR = 0.3          # a capacity factor that drops about half
B, S = 4, 24


def _close(got, want, rtol: float, what: str) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


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


def _assert_same_routing(gate_i: torch.Tensor, want: np.ndarray, E: int,
                         C: int, what: str) -> np.ndarray:
    """The port's top-k ids are the reference's, and its bucketing drops
    the entries the definition drops. Returns the dropped (T, K)."""
    np.testing.assert_array_equal(gate_i.numpy(), want, err_msg=what)
    dropped = _first_c(want, E, C)
    entry_slot = tmoe.bucket(gate_i, E, C)[2]
    np.testing.assert_array_equal((entry_slot == E * C).numpy(),
                                  dropped.reshape(-1), err_msg=what)
    return dropped


# ---------------------------------------------------------------------------
# the gather's backward


def _routing(T: int, E: int, K: int, seed: int) -> torch.Tensor:
    """gate_i (T, K): K distinct experts a token, by a seeded draw."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.permutation(E)[:K]
                                      for _ in range(T)]))


@pytest.mark.parametrize("K,factor", [(1, 1.25), (1, 0.3), (3, 1.25),
                                      (3, 0.3)])
def test_gather_rows_gradcheck(K, factor):
    T, E, d = 12, 4, 3
    gate_i = _routing(T, E, K, seed=K)
    cfg = tmoe.MoEConfig(num_experts=E, top_k=K, d_ff_expert=4,
                         capacity_factor=factor)
    C = cfg.capacity(T) if factor > 1 else 2       # C = 2: drops
    _, slot_token, entry_slot, slot_entry = tmoe.bucket(gate_i, E, C)
    dropped = entry_slot == E * C
    # drops where the capacity is cut; empty slots (the sentinel) where not
    assert bool(dropped.any()) == (factor < 1)
    if factor > 1:
        assert bool((slot_token == T).any())
    gen = torch.Generator().manual_seed(K)
    xt = torch.randn(T, d, generator=gen, dtype=torch.float64,
                     requires_grad=True)
    out = torch.randn(E * C, d, generator=gen, dtype=torch.float64,
                      requires_grad=True)
    inverse = entry_slot.reshape(T, K)
    assert torch.autograd.gradcheck(tmoe.GatherRows.apply,
                                    (xt, slot_token, inverse))
    assert torch.autograd.gradcheck(tmoe.GatherRows.apply,
                                    (out, entry_slot, slot_entry[:, None]))
    # the backwards by their definitions: a token's K slots in k order, a
    # dropped entry's a zero row; a slot its one entry's, an empty slot 0
    g = torch.randn(E * C, d, generator=gen, dtype=torch.float64)
    rows = tmoe.GatherRows.apply(xt, slot_token, inverse)
    (dx,) = torch.autograd.grad(rows, xt, g)
    want = torch.zeros_like(dx)
    for t in range(T):
        for k in range(K):
            if not dropped[t * K + k]:
                want[t] += g[entry_slot[t * K + k]]
    assert torch.equal(dx, want)
    ge = torch.randn(T * K, d, generator=gen, dtype=torch.float64)
    per_entry = tmoe.GatherRows.apply(out, entry_slot, slot_entry[:, None])
    assert not per_entry[dropped].any()
    (dout,) = torch.autograd.grad(per_entry, out, ge)
    want = torch.zeros_like(dout)
    kept = ~dropped
    want[entry_slot[kept]] = ge[kept]
    assert torch.equal(dout, want)


# ---------------------------------------------------------------------------
# the MoE layer


def _layer_cfg(name: str, module, drops: bool, shared: bool):
    m = CONFIGS[name][0 if module is jmoe else 1].moe
    fields = {k: getattr(m, k) for k in (
        "num_experts", "top_k", "d_ff_expert", "num_shared", "d_ff_shared",
        "capacity_factor", "router_aux_weight", "act")}
    if drops:
        fields["capacity_factor"] = DROP_FACTOR
    if not shared:
        fields["num_shared"] = 0
    return module.MoEConfig(**fields)


@pytest.mark.parametrize("drops", [False, True], ids=["no_drops", "drops"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "unshared"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_layer_gradients_match_jax(name, shared, drops):
    jcfg = _layer_cfg(name, jmoe, drops, shared)
    tcfg = _layer_cfg(name, tmoe, drops, shared)
    d = CONFIGS[name][1].d_model
    jp = jmoe.moe_init(jax.random.PRNGKey(5), d, jcfg, jnp.float32)
    np_p = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    cot = rng.standard_normal((2, S, d))
    aux_w = 0.37
    T, E, K = 2 * S, tcfg.num_experts, tcfg.top_k
    C = tcfg.capacity(T)

    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), np_p)
        x64, cot64 = jnp.asarray(x, jnp.float64), jnp.asarray(cot)

        def f(p, xx):
            y, aux = jmoe._moe_apply_gather(p, jcfg, xx)
            return jnp.sum(y * cot64) + aux_w * aux, (y, aux)

        (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(p64, x64)
        xt = x64.reshape(T, d)
        probs = jax.nn.softmax(xt.astype(jnp.float32) @ p64["router"], -1)
        jgate = np.asarray(jax.lax.top_k(probs, K)[1])
        jgp = [np.asarray(g) for g in jax.tree.leaves(jgp)]
        jgx, jy = np.asarray(jgx), np.asarray(jy)

    tp = jax.tree.map(lambda a: tensor_from_numpy(a, "cpu")
                      .requires_grad_(True), np_p)
    tx = torch.from_numpy(x).requires_grad_(True)
    gate_i = tmoe.route(tp, tcfg, tx.detach().reshape(T, d))[3]
    dropped = _assert_same_routing(gate_i, jgate, E, C, name)
    assert bool(dropped.any()) == drops
    y, aux = tmoe.moe_apply(tp, tcfg, tx)
    loss = torch.sum(y.double() * torch.from_numpy(cot)) + aux_w * aux
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad(loss, [*leaves, tx])
    _close(y.detach().numpy(), jy, 1e-4, "y")
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    assert len(leaves) == len(jgp)
    for i, (g, w) in enumerate(zip(grads, [*jgp, jgx])):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, 1e-4, f"{name} gradient {i}")


# ---------------------------------------------------------------------------
# the LM


def _pair(name: str):
    jcfg, tcfg = CONFIGS[name]
    jp = jt.init(jax.random.PRNGKey(1), jcfg)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    return jcfg, tcfg, jp, tp, toks, labels


def _jax_routing(jp, jcfg, toks, monkeypatch) -> list[np.ndarray]:
    """Each layer's top-k ids in the JAX forward in float64: the forward
    run eagerly, layer by layer (``scan_layers`` and ``remat`` off, the
    same arithmetic), with ``jax.lax.top_k`` recording its ids."""
    seen = []
    top_k = jax.lax.top_k

    def recording(x, k):
        out = top_k(x, k)
        seen.append(np.asarray(out[1]))
        return out

    cfg = dataclasses.replace(jcfg, dtype="float64", scan_layers=False,
                              remat=False)
    monkeypatch.setattr(jax.lax, "top_k", recording)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           jp)
        jt.forward(p64, cfg, jnp.asarray(toks))
    monkeypatch.undo()
    return seen


def _port_routing(tp, tcfg, toks, labels, monkeypatch) -> list:
    seen = []
    route = tmoe.route

    def recording(*args):
        out = route(*args)
        seen.append(out[3])
        return out

    monkeypatch.setattr(tmoe, "route", recording)
    with torch.no_grad():
        tt.loss_fn(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(labels))
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradients_match_jax(name, monkeypatch):
    jcfg, tcfg, jp, tp, toks, labels = _pair(name)
    want_gates = _jax_routing(jp, jcfg, toks, monkeypatch)
    got_gates = _port_routing(tp, tcfg, toks, labels, monkeypatch)
    assert len(got_gates) == len(want_gates) == tcfg.n_layers
    m = tcfg.moe
    for i, (g, w) in enumerate(zip(got_gates, want_gates)):
        _assert_same_routing(g, w, m.num_experts, m.capacity(B * S),
                             f"{name} layer {i}")
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           jp)
        cfg64 = dataclasses.replace(jcfg, dtype="float64")
        want_loss, want = jax.jit(jax.value_and_grad(jt.loss_fn),
                                  static_argnums=1)(
            p64, cfg64, jnp.asarray(toks), jnp.asarray(labels))
        want = [np.asarray(g) for g in jax.tree.leaves(want)]
    tt_toks, tt_labels = torch.from_numpy(toks), torch.from_numpy(labels)
    loss, grads = tt.value_and_grad(tp, tcfg, tt_toks, tt_labels)
    assert len(grads) == len(want) == len(tree_leaves(tp))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert torch.equal(loss, tt.loss_fn(tp, tcfg, tt_toks, tt_labels))
    # every MoE leaf has its own stacked gradient, the router's float32
    stacked = dict(tt._stacked(tp["layers"]))
    for path in (("ffn", "router"), ("ffn", "w_gate"), ("ffn", "w_up"),
                 ("ffn", "w_down"), ("ffn", "shared", "w_gate"),
                 ("ffn", "shared", "w_up"), ("ffn", "shared", "w_down")):
        leaf = stacked[path]
        g = next(g for g, p in zip(grads, tree_leaves(tp)) if p is leaf)
        assert g.shape == leaf.shape and g.dtype == torch.float32
        assert g.shape[0] == tcfg.n_layers and bool(g.abs().sum(
            dim=tuple(range(1, g.dim()))).gt(0).all()), path
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g.numpy(), w, 1e-4, f"{name} gradient leaf {i}")


def test_the_aux_loss_enters_with_its_weight():
    """The loss is the cross-entropy plus ``router_aux_weight`` times the
    layers' aux losses: the weight's effect on the loss is linear."""
    _, tcfg, _, tp, toks, labels = _pair("qwen2_moe")
    tt_toks, tt_labels = torch.from_numpy(toks), torch.from_numpy(labels)
    losses = []
    for w in (0.0, 1.0, 2.0):
        m = dataclasses.replace(tcfg.moe, router_aux_weight=w)
        cfg = dataclasses.replace(tcfg, moe=m)
        losses.append(float(tt.loss_fn(tp, cfg, tt_toks, tt_labels)))
    aux = losses[1] - losses[0]
    assert aux > 0.5 * tcfg.n_layers      # each layer's aux is >= ~1
    np.testing.assert_allclose(losses[2] - losses[0], 2 * aux, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_gives_the_same_bits(name):
    _, tcfg, _, tp, toks, labels = _pair(name)
    assert tcfg.remat
    runs = [tt.value_and_grad(tp, dataclasses.replace(tcfg, remat=r),
                              torch.from_numpy(toks), torch.from_numpy(labels))
            for r in (True, False)]
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _update_slack(m, opt) -> np.ndarray:
    """What the gradients' tolerance allows a first AdamW step's update to
    move, from JAX's first moment m = (1 - b1) g (g the clipped gradient
    the step used): the update is lr g / (|g| + eps), so an error dg in g
    moves it by up to lr eps dg / (|g| - dg + eps)^2, and by 2 lr where dg
    reaches |g| (the sign is not held). dg is the gradients' tolerance,
    1e-4 |g| + 1e-6 max|g|."""
    g = np.abs(np.asarray(m, np.float64)) / (1 - opt.b1)
    dg = 1e-4 * g + 1e-6 * g.max()
    lr = opt.lr / opt.warmup_steps
    return np.where(dg >= g, 2 * lr,
                    lr * opt.eps * dg / (g - dg + opt.eps) ** 2)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_jax_train_step(accum, monkeypatch):
    jcfg, tcfg, jp, tp, toks, labels = _pair("qwen2_moe")
    # the same routing in both packages' float32 forwards
    m = tcfg.moe
    for i, (g, w) in enumerate(zip(
            _port_routing(tp, tcfg, toks, labels, monkeypatch),
            _jax_routing(jp, jcfg, toks, monkeypatch))):
        _assert_same_routing(g, w, m.num_experts, m.capacity(B * S),
                             f"layer {i}")
    jarch = jbase.LMArch("qwen2-moe-a2.7b", jcfg, jcfg, grad_accum=accum)
    jstep = jax.jit(jarch.build_step("train_4k"))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jstate = jadamw.adamw_init(jp)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jp, jstate, jloss = jstep(jp, jstate, jb)
    slack = [_update_slack(m, jarch.opt) for m in jax.tree.leaves(jstate.m)]
    step = LMArch("qwen2-moe-a2.7b", tcfg, tcfg,
                  grad_accum=accum).build_step("train_4k", smoke=True)
    tp, tstate, loss = step(tp, tstate, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(tstate.step) == 1
    for i, (t, j) in enumerate(zip(tree_leaves(tp), jax.tree.leaves(jp))):
        got = t.detach().numpy().astype(np.float64)
        want = np.asarray(j, np.float64)
        limit = 1e-4 * np.abs(want) + 1e-6 * np.abs(want).max() + slack[i]
        assert (np.abs(got - want) <= limit).all(), f"parameter leaf {i}"
    for i, (mt, jm) in enumerate(zip(tstate.m, jax.tree.leaves(jstate.m))):
        _close(mt.numpy(), np.asarray(jm, np.float64), 1e-4,
               f"first moment {i}")
    for i, (v, jv) in enumerate(zip(tstate.v, jax.tree.leaves(jstate.v))):
        _close(v.numpy(), np.asarray(jv, np.float64), 2e-4,
               f"second moment {i}")


@pytest.mark.parametrize("arch_id", MOE_IDS)
def test_train_step_on_the_card_path_has_no_float_scatter(arch_id,
                                                          monkeypatch):
    """The MoE train step (2 micro-batches) with ``ops`` routing to the
    CUDA wrappers, each stood in by its plain version run outside the
    recorder: no float scatter anywhere in the step, the dispatch's and
    the combine's backwards included (autograd's backward of a gather
    would record an accumulating ``index_put_``), K6's launches as its
    structure gives them, and the CPU's loss and gradients."""
    arch = get_arch(arch_id)
    cfg = arch.smoke_cfg
    counts = {"fwd": 0, "bwd": 0, "seg": 0}

    def fwd(q, k, v, *, causal=True, q_offset=0, return_lse=False):
        with _disable_current_modes():
            counts["fwd"] += 1
            out = ref.flash_attention_ref(q, k, v, causal=causal,
                                          q_offset=q_offset)
            lse = torch.zeros(q.shape[:3])
        return (out, lse) if return_lse else out

    def bwd(q, k, v, o, lse, dout, *, causal=True, q_offset=0):
        with _disable_current_modes():
            counts["bwd"] += 1
            return ref.flash_attention_bwd_ref(q, k, v, o, dout,
                                               causal=causal,
                                               q_offset=q_offset)

    def seg(values, order, keys, offsets, op):
        with _disable_current_modes():
            counts["seg"] += 1
            rows = order if order is not None else torch.arange(
                values.shape[0], dtype=torch.int32)
            return ref.segment_reduce_ref(values, rows, offsets, op)

    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "segment_reduce_cuda", seg)
    params = arch.init_params(torch.Generator().manual_seed(0), "cpu",
                              smoke=True)
    batch = arch.make_inputs("train_4k", torch.Generator(), "cpu",
                             smoke=True, seed=0, batch=4, seq=16)
    step = LMArch(arch_id, cfg, cfg, grad_accum=2).build_step(
        "train_4k", smoke=True)
    start = [p.detach().clone() for p in tree_leaves(params)]
    state = adamw_init(params)
    recorder = chip_smoke.float_scatter_recorder()
    with recorder:
        _, _, loss = step(params, state, batch)
    assert not recorder.seen, sorted(set(recorder.seen))
    want = chip_smoke.lm_train_launches(cfg, 2)
    assert counts == {"fwd": want["flash_attention"],
                      "bwd": want["flash_attention_bwd"],
                      "seg": want["segment_reduce"]}
    monkeypatch.undo()
    # the recorder sees autograd's gather backward where it runs
    recorder = chip_smoke.float_scatter_recorder()
    x = torch.ones(3, 2, requires_grad=True)
    with recorder:
        x[torch.tensor([0, 0, 2])].sum().backward()
    assert recorder.seen
    fresh = arch.init_params(torch.Generator().manual_seed(0), "cpu",
                             smoke=True)
    assert all(torch.equal(a, b) for a, b in zip(start, tree_leaves(fresh)))
    _, _, want_loss = step(fresh, adamw_init(fresh), batch)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(fresh)))


@pytest.mark.parametrize("arch_id", MOE_IDS)
def test_train_flops_and_bytes_match_jax(arch_id, monkeypatch):
    ours, theirs = get_arch(arch_id), j_get_arch(arch_id)
    assert ours.model_flops("train_4k") == theirs.model_flops("train_4k")
    assert ours.model_bytes("train_4k") == theirs.model_bytes("train_4k")
    cut = dict(batch=2, seq=4096)
    monkeypatch.setitem(jbase.LM_SHAPES, "train_4k",
                        {**jbase.LM_SHAPES["train_4k"], **cut})
    assert ours.model_flops("train_4k", **cut) == \
        theirs.model_flops("train_4k")
    assert ours.model_bytes("train_4k", **cut) == \
        theirs.model_bytes("train_4k")
    assert tt.model_flops_per_token(ours.cfg) == \
        jt.model_flops_per_token(theirs.cfg)
