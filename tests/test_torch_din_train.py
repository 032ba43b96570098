"""Port parity of DIN training against the JAX package on the CPU.

* K5's backward, plain version (``ref.embedding_bag_grad_ref``, and
  ``ops.embedding_bag`` under autograd), against ``jax.grad`` of the JAX
  package's ``embedding_bag_ref`` in the table and the weights: a hot id,
  negative ids, an id no bag names.
* ``din.loss_fn``'s value and every leaf's gradient (``grad_step``, leaves
  in the JAX order) against ``jax.value_and_grad(din.loss_fn)``, on
  ``din_arch.SMOKE`` and on a mid config (n_items 5,000, n_cats 500, d 18,
  L 100, B 256) over a ``RecsysStream`` batch, with the JAX parameters
  carried across (``din.params_from_numpy``).
* One and three ``build_step("train_batch")`` steps against the JAX
  ``DINArch`` train step from the same AdamW state (``state_from_numpy``).
* ``model_flops``/``model_bytes`` of every cell, the train kind included,
  equal to the JAX package's; ``tree_leaves`` of a ``DIN`` in the JAX
  order; ``make_inputs("train_batch")`` a ``RecsysStream`` batch.
* The train step with the CUDA wrappers stood in by their plain versions:
  no float ``index_add``, ``scatter_add``, ``scatter_reduce`` or
  accumulating ``index_put_`` outside them, and the launches that
  ``chip_smoke.din_train_launches`` gives.

Tolerances. The loss and the MLP leaves' gradients: rtol 1e-5, atol 1e-6 x
the leaf's largest |entry|; the two tables' gradients rtol 1e-4 with the
same atol. Gradients are held against JAX's ``value_and_grad`` in float64
(``jax.enable_x64``, on the same float32 parameters and inputs): JAX's own
float32 gradient of the attention MLP's last weight, a sum over B L =
25,600 terms with cancellation, lies up to 1.19 of the rtol 1e-5 limit from
float64 on the mid config, where the port's lies within 0.15 of it.
Parameters after the AdamW steps (against JAX's float32 train step): rtol
1e-4 with the same atol, except entries whose JAX gradient was at rounding
level at some step (|g| within its gradient tolerance), where Adam's update
is about lr sign(g) and a sign flip moves the entry by up to 2 lr a step:
those within 2 sum(lr) more (``tests/test_torch_gnn_train.py``'s rule).
Moments: the gradients' rtol, second moments twice it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from repro.configs import base as jbase
from repro.configs import din_arch as j_din_arch
from repro.data.pipeline import RecsysStream as JRecsysStream
from repro.kernels import ref as jref
from repro.models.recsys import din as jdin
from repro.optim import adamw as jadamw
from repro_torch.configs import DIN_SHAPES, din_arch, get_arch
from repro_torch.configs.base import DINArch
from repro_torch.data import RecsysStream
from repro_torch.kernels import embedding_bag, ops, ref, segment_reduce
from repro_torch.models.common import tree_leaves
from repro_torch.models.recsys import din as tdin
from repro_torch.optim import AdamWConfig, adamw_init, state_from_numpy

MID = dataclasses.replace(j_din_arch.CONFIG, name="din-mid", n_items=5_000,
                          n_cats=500)
TABLE_LEAVES = (6, 7)              # cat_emb, item_emb in the JAX leaf order


def _tcfg(jcfg) -> tdin.DINConfig:
    return tdin.DINConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)})


def _rtol(i: int) -> float:
    return 1e-4 if i in TABLE_LEAVES else 1e-5


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    limit = rtol * np.abs(want) + 1e-6 * float(np.abs(want).max())
    bad = np.abs(got - want) > limit
    assert not bad.any(), (f"{what}: {int(bad.sum())} entries, max err "
                           f"{float(np.abs(got - want).max())}")


# ---------------------------------------------------------------------------
# K5's backward


@pytest.mark.parametrize("V,d,B,L,seed", [(50, 8, 16, 10, 0),
                                          (1000, 18, 64, 100, 1),
                                          (300, 7, 5, 33, 2)])
def test_bag_backward_matches_jax_grad(V, d, B, L, seed):
    """dT and dw of the plain version and of ops.embedding_bag under
    autograd against jax.grad, with one id holding a quarter of the
    positions, negative ids (row id + V) and rows no id names."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(-(V // 4), V // 2, (B, L)).astype(np.int32)
    ids[rng.random((B, L)) < 0.25] = 3                   # the hot id
    w = rng.standard_normal((B, L)).astype(np.float32)
    g = rng.standard_normal((B, d)).astype(np.float32)
    want_t, want_w = jax.grad(
        lambda t, ww: jnp.sum(jref.embedding_bag_ref(t, jnp.asarray(ids), ww)
                              * jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(w))
    tt, tw = torch.from_numpy(table), torch.from_numpy(w)
    d_t, d_w = ref.embedding_bag_grad_ref(tt, torch.from_numpy(ids), tw,
                                          torch.from_numpy(g))
    _close(d_t.numpy(), want_t, 1e-5, "plain dT")
    _close(d_w.numpy(), want_w, 1e-5, "plain dw")
    assert not d_t[V // 2:V - V // 4].any()             # rows no id names
    lt, lw = tt.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    a_t, a_w = torch.autograd.grad(
        ops.embedding_bag(lt, torch.from_numpy(ids), lw),
        (lt, lw), torch.from_numpy(g))
    assert torch.equal(a_t, d_t) and torch.equal(a_w, d_w)


def test_bag_backward_of_an_id_outside_the_table():
    """An id outside [-V, V): no row of dT, a NaN dw, as jnp.take's fill
    and its dropped scatter give them."""
    table = torch.arange(12.0).reshape(4, 3)
    ids = torch.tensor([[0, 9], [1, -1]], dtype=torch.int32)
    w = torch.ones((2, 2))
    g = torch.ones((2, 3))
    d_t, d_w = ref.embedding_bag_grad_ref(table, ids, w, g)
    want_t, want_w = jax.grad(
        lambda t, ww: jnp.sum(jref.embedding_bag_ref(t, jnp.asarray(
            ids.numpy()), ww)), argnums=(0, 1))(jnp.asarray(table.numpy()),
                                                jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(want_t))
    assert torch.isnan(d_w).tolist() == [[False, True], [False, False]]
    np.testing.assert_array_equal(d_w.numpy(), np.asarray(want_w))


def test_bag_on_the_card_path_needs_the_plan(monkeypatch):
    """On the card the table's gradient needs the ids' plan: the backward
    raises without one, directly and under autograd."""
    table = torch.zeros((4, 2), requires_grad=True)
    ids = torch.zeros((1, 2), dtype=torch.int32)
    w, g = torch.ones((1, 2)), torch.ones((1, 2))
    out = ops.embedding_bag(table, ids, w)              # the CPU forward
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    with pytest.raises(ValueError, match="plan"):
        ops.embedding_bag_grad(table, ids, w, g, None)
    with pytest.raises(ValueError, match="plan"):
        torch.autograd.grad(out, table, g)


def test_bag_plan_reads_ids_as_the_forward():
    """``ops.bag_plan`` is the plan of the ids read as K5 reads them (an id
    in [-V, 0) is row id + V): the plan the card's table gradient folds."""
    ids = torch.tensor([[3, -1, 0, -5], [4, 4, -2, 1]], dtype=torch.int32)
    got = ops.bag_plan(ids, 5)
    want = ops.segment_plan((ids % 5).reshape(-1), 5, keep_index=False)
    for a, b in ((got.order, want.order), (got.keys, want.keys),
                 (got.offsets, want.offsets)):
        assert torch.equal(a, b)
    assert got.index is None


# ---------------------------------------------------------------------------
# the loss and its gradient


def _pair(jcfg, B: int, seed: int):
    """(JAX params, the port's DIN, a RecsysStream batch as numpy)."""
    jp = jdin.init(jax.random.PRNGKey(seed), jcfg)
    tp = tdin.params_from_numpy(jax.tree.map(np.asarray, jp), _tcfg(jcfg),
                                "cpu")
    batch = next(iter(JRecsysStream(jcfg.n_items, jcfg.n_cats,
                                    jcfg.seq_len, B, seed=seed)))
    return jp, tp, batch


def _jax_value_and_grad64(jp, jcfg, batch):
    """JAX's value_and_grad of din.loss_fn in float64 on the float32
    parameters and inputs: (loss, leaves)."""
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           jp)
        b64 = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                              else v) for k, v in batch.items()}
        loss, grads = jax.value_and_grad(
            lambda p: jdin.loss_fn(p, jcfg, b64))(p64)
        return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("which,B,seed", [("smoke", 8, 3), ("mid", 256, 3),
                                          ("mid", 256, 4)])
def test_loss_and_gradients_match_jax(which, B, seed):
    jcfg = j_din_arch.SMOKE if which == "smoke" else MID
    jp, tp, batch = _pair(jcfg, B, seed)
    want_loss, want = _jax_value_and_grad64(jp, jcfg, batch)
    arch = DINArch("din", _tcfg(jcfg), din_arch.SMOKE)
    loss, grads = arch.grad_step()(tp, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert len(grads) == len(want) == 14
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g.numpy(), w, _rtol(i), f"{which} gradient leaf {i}")
    # the rows of the item table that no id of the batch names get 0
    named = np.zeros(jcfg.n_items, bool)
    named[batch["hist_items"].reshape(-1)] = True
    named[batch["target_item"]] = True
    assert not grads[7][torch.from_numpy(~named)].any()


def test_forward_step_is_the_loss_and_score():
    jcfg = MID
    jp, tp, batch = _pair(jcfg, 64, 5)
    arch = DINArch("din", _tcfg(jcfg), din_arch.SMOKE)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, loss = arch.forward_step()(tp, tb)
    assert torch.equal(logits, tdin.score(tp, _tcfg(jcfg), tb))
    assert torch.equal(loss, tdin.loss_fn(tp, _tcfg(jcfg), tb))
    want = jdin.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# train steps


def _rounding_level(g, rtol):
    g = np.abs(np.asarray(g, np.float64))
    return g <= rtol * g + rtol * g.max()


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_the_jax_train_step(steps):
    jcfg = MID
    jp, tp, batch = _pair(jcfg, 256, 6)
    jarch = jbase.DINArch("din", jcfg, j_din_arch.SMOKE)
    jstep = jax.jit(jarch.build_step("train_batch"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jadamw.adamw_init(jp)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    step = DINArch("din", _tcfg(jcfg), din_arch.SMOKE).build_step(
        "train_batch")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = jarch.opt
    tiny = [np.zeros(np.shape(x), bool) for x in jax.tree.leaves(jp)]
    lrs = []
    for k in range(steps):
        grads = jax.grad(lambda p: jdin.loss_fn(p, jcfg, jb))(jp)
        for i, g in enumerate(jax.tree.leaves(grads)):
            tiny[i] |= _rounding_level(g, _rtol(i))
        lrs.append(opt.lr * min(1.0, (k + 1) / opt.warmup_steps))
        jp, jstate, jloss = jstep(jp, jstate, jb)
        tp, tstate, loss = step(tp, tstate, tb)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(tstate.step) == steps
    slack = 2.0 * sum(lrs)
    for i, (t, j) in enumerate(zip(tree_leaves(tp), jax.tree.leaves(jp))):
        got = t.detach().numpy().astype(np.float64)
        want = np.asarray(j, np.float64)
        limit = 1e-4 * np.abs(want) + 1e-6 * float(np.abs(want).max())
        limit = np.where(tiny[i], limit + slack, limit)
        assert (np.abs(got - want) <= limit).all(), f"parameter leaf {i}"
    for got, want, mult in ((tstate.m, jstate.m, 1), (tstate.v, jstate.v, 2)):
        for i, (x, y) in enumerate(zip(got, jax.tree.leaves(want))):
            _close(x.numpy(), y, mult * _rtol(i), f"moment leaf {i}")


def test_train_step_updates_in_place_and_decays_every_table_row():
    jp, tp, batch = _pair(j_din_arch.SMOKE, 8, 7)
    before = tp.item_emb.detach().clone()
    arch = DINArch("din", _tcfg(j_din_arch.SMOKE), din_arch.SMOKE)
    state = adamw_init(tp)
    out, state, loss = arch.build_step("train_batch", opt=AdamWConfig(
        lr=1e-2, warmup_steps=1))(tp, state,
                                  {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    assert out is tp and torch.isfinite(loss)
    # weight decay moves every nonzero row, named or not
    moved = (tp.item_emb.detach() != before).any(dim=1)
    assert bool(moved[before.abs().sum(dim=1) > 0].all())


# ---------------------------------------------------------------------------
# accounting, leaves, inputs


def test_model_flops_and_bytes_equal_jax():
    for jcfg in (j_din_arch.CONFIG, MID):
        jarch = jbase.DINArch("din", jcfg, j_din_arch.SMOKE)
        arch = DINArch("din", _tcfg(jcfg), din_arch.SMOKE)
        for shape_id in DIN_SHAPES:
            assert arch.model_flops(shape_id) == jarch.model_flops(shape_id)
            assert arch.model_bytes(shape_id) == jarch.model_bytes(shape_id)
    full = get_arch("din")
    assert abs(full.model_flops("train_batch") - 5.95e11) < 0.01e11
    assert abs(full.model_bytes("train_batch") - 27.4e9) < 0.1e9


def test_tree_leaves_of_din_follow_jax():
    jp, tp, _ = _pair(j_din_arch.SMOKE, 8, 0)
    leaves = tree_leaves(tp)
    want = jax.tree.leaves(jp)
    assert len(leaves) == len(want) == 14
    for t, j in zip(leaves, want):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
    assert leaves[6] is tp.cat_emb and leaves[7] is tp.item_emb
    assert leaves[0] is tp.attn.biases[0] and leaves[1] is tp.attn.weights[0]


def test_make_inputs_of_the_train_cell_is_a_recsys_stream_batch():
    arch = get_arch("din")
    got = arch.make_inputs("train_batch", torch.Generator(), "cpu",
                           smoke=True, seed=11, batch=32)
    cfg = arch.smoke_cfg
    want = next(iter(RecsysStream(cfg.n_items, cfg.n_cats, cfg.seq_len, 32,
                                  seed=11)))
    assert set(got) == set(want) and "label" in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    with pytest.raises(ValueError, match="seed"):
        arch.make_inputs("serve_p99", torch.Generator(), "cpu", smoke=True,
                         seed=1)


# ---------------------------------------------------------------------------
# the kernels' path, stood in by the plain versions


class _FloatScatters(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.paused = False
        self.seen: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused and chip_smoke.is_float_scatter(func.__name__,
                                                           args, kwargs):
            self.seen.append(func.__name__)
        return func(*args, **kwargs)


def test_train_step_runs_only_the_kernels(monkeypatch):
    """With ``ops`` sending CPU tensors to counting stand-ins of the CUDA
    wrappers, a train step runs no float scatter outside them and launches
    each kernel as often as DIN's structure says."""
    mode = _FloatScatters()
    count = dict.fromkeys(chip_smoke.din_train_launches(), 0)

    def plain(names, fn):
        def stand_in(*args, **kwargs):
            for name in names(kwargs):
                count[name] += 1
            mode.paused = True
            try:
                return fn(*args, **kwargs)
            finally:
                mode.paused = False
        return stand_in

    def rows(o, keys):
        return torch.arange(keys.shape[0]) if o is None else o

    def bag_grad(table, ids, w, g, order, keys, offsets, *, table_grad,
                 weights_grad):
        return ref.embedding_bag_grad_ref(table, ids, w, g,
                                          table_grad=table_grad,
                                          weights_grad=weights_grad)

    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(ops, "embedding_bag_cuda", plain(
        lambda kw: ["embedding_bag"], ref.embedding_bag_ref))
    monkeypatch.setattr(ops, "embedding_bag_grad_cuda", plain(
        lambda kw: [n for n, on in (("embedding_bag_grad_table",
                                     kw["table_grad"]),
                                    ("embedding_bag_grad_weights",
                                     kw["weights_grad"])) if on],
        bag_grad))
    monkeypatch.setattr(ops, "segment_reduce_cuda", plain(
        lambda kw: ["segment_reduce"], lambda v, o, k, off, op:
        ref.segment_reduce_ref(v, rows(o, k), off, op)))
    monkeypatch.setattr(ops, "segment_reduce_grad_cuda", plain(
        lambda kw: ["segment_reduce_grad"],
        lambda g, v, out, o, k, ix, off, op:
        ref.segment_reduce_grad_ref(g, v, out, rows(o, k), off, op)))
    arch = get_arch("din")
    params = arch.init_params(torch.Generator().manual_seed(1), "cpu",
                              smoke=True)
    batch = arch.make_inputs("train_batch", torch.Generator(), "cpu",
                             smoke=True, seed=2, batch=64)
    state = adamw_init(params)
    before = [p.detach().clone() for p in tree_leaves(params)]
    embedding_bag.reset_launches()
    with mode:
        params, state, loss = arch.build_step("train_batch", smoke=True)(
            params, state, batch)
    assert mode.seen == []
    assert torch.isfinite(loss)
    assert all(not torch.equal(p, q)
               for p, q in zip(tree_leaves(params), before))
    assert count == chip_smoke.din_train_launches()
    assert embedding_bag.LAUNCHES["embedding_bag_grad_table"] == 0
    assert segment_reduce.LAUNCHES["segment_reduce"] == 0
