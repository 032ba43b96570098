"""Port parity of GNN training against the JAX package on the CPU.

* The backward of the segment reduction (``ref.segment_reduce_grad_ref``
  and ``ops.segment_reduce`` under autograd) against ``jax.grad`` of
  ``jax.ops.segment_sum/max/min``: ties (split equally, column by column,
  the identity counted among them), indices outside [0, S), empty
  segments, segments over 128 edges; and the gather's backward
  (``ops.gather_rows``) against ``jax.grad`` of ``x[index]``.
* ``jax.grad`` of each model's ``loss_fn`` with the JAX parameters carried
  across, leaf by leaf in the JAX order (``tree_leaves``): the smoke
  configurations, masked and unmasked; GCN at full width on full_graph_sm;
  PNA and GraphCast at their published widths on n 120, m 256, masked.
* AdamW alone against ``repro.optim.adamw``, clipping active and not,
  inside and past the warm-up.
* One and three train steps of ``build_step(smoke=True)`` against the JAX
  train step (``value_and_grad(loss_fn)`` then ``adamw_update``, as
  ``repro/configs/base.py``'s ``build_step`` writes it) from a JAX state
  carried across by ``state_from_numpy``; one step of both packages'
  ``build_step`` on GCN's full_graph_sm cell.
* The train step with the two CUDA wrappers stood in by their plain
  versions: no float ``index_add``, ``scatter_add``, ``scatter_reduce`` or
  accumulating ``index_put_`` outside them, and the launches the model's
  structure gives (``chip_smoke.gnn_train_launches``).
* The sliced power iteration (``ops.segment_reduce`` over the plan of the
  edge destinations) against the JAX package's.

Tolerances. Gradients, losses and the first moments: GCN rtol 1e-5, the
others 1e-4 (the forward's, ``tests/test_torch_gnn.py``), each atol rtol x
the leaf's largest |entry|; second moments (squares of the gradients)
twice that rtol. A max/min backward of the plain version equals JAX's bit
for bit, a sum's too; the gather's backward adds in another order than
XLA's scatter, rtol 1e-6. AdamW alone: rtol 1e-6 of each leaf's largest
|entry| (the same rule op for op; ``pow`` and the norm's reduction order
differ). Parameters after k steps: the gradient rule's tolerance, except
on entries whose JAX gradient was at rounding level (|g| within the
gradient's tolerance) at some step: Adam's update there is about
lr * sign(g), and a sign flip between the packages moves the entry by up
to 2 lr a step, so those entries are held to 2 sum(lr) + that tolerance.
DimeNet's smoke case holds the gradient's rule as is.
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
import repro.ppr as jppr
import repro_torch.ppr as tppr
from repro.configs import get_arch as j_get_arch
from repro.models.gnn import common as jcommon
from repro.models.gnn import dimenet as jdimenet
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import graphcast as jgraphcast
from repro.models.gnn import pna as jpna
from repro.optim import adamw as jadamw
from repro_torch.configs import GNN_SHAPES, get_arch
from repro_torch.configs.base import _pad
from repro_torch.kernels import ops, ref, segment_reduce
from repro_torch.models.common import tree_leaves
from repro_torch.models.gnn import GraphBatch
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               global_norm, state_from_numpy)

ARCHS = {"gcn-cora": (jgcn, 1e-5), "pna": (jpna, 1e-4),
         "graphcast": (jgraphcast, 1e-4), "dimenet": (jdimenet, 1e-4)}
SMOKE_N, SMOKE_M, SMOKE_GRAPHS = 64, 256, 4


# ---------------------------------------------------------------------------
# the segment reduction's backward


def _jax_segment(op):
    return {"sum": jax.ops.segment_sum, "max": jax.ops.segment_max,
            "min": jax.ops.segment_min}[op]


def _grad_both(values, index, S, op, g_out):
    """JAX's gradient of sum(segment_op(values) * g_out), the plain
    version's and the one through ops.segment_reduce under autograd."""
    want = jax.grad(lambda v: jnp.sum(
        _jax_segment(op)(v, jnp.asarray(index), num_segments=S)
        * jnp.asarray(g_out)))(jnp.asarray(values))
    plan = ops.segment_plan(torch.from_numpy(index), S)
    v = torch.from_numpy(values)
    out = ref.segment_reduce_ref(v, plan.order, plan.offsets, op)
    plain = ref.segment_reduce_grad_ref(torch.from_numpy(g_out), v, out,
                                        plan.order, plan.offsets, op)
    leaf = v.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(
        ops.segment_reduce(leaf, plan, op), leaf, torch.from_numpy(g_out))
    return np.asarray(want), plain.numpy(), auto.numpy()


def test_backward_splits_the_scratch_ties_as_jax():
    values = np.array([[1, 0], [3, 0], [3, 0]], np.float32)
    g_out = np.array([[1, 10]], np.float32)
    want, plain, auto = _grad_both(values, np.zeros(3, np.int32), 1, "max",
                                   g_out)
    np.testing.assert_array_equal(
        want, np.array([[0, 10 * np.float32(1 / 3)]] * 3, np.float32)
        + np.array([[0, 0], [0.5, 0], [0.5, 0]], np.float32))
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(auto, want)


def test_backward_counts_the_identity_among_ties():
    """A column whose maximum is -inf (all its values -inf) splits among
    its edges and the scatter's initial value, as JAX's does."""
    inf = np.float32(np.inf)
    values = np.array([[-inf, 2], [-inf, 1], [5, inf], [4, inf]],
                      np.float32)
    index = np.array([0, 0, 1, 1], np.int32)
    g_out = np.array([[7, 3], [2, 5]], np.float32)
    for op, v in (("max", values), ("min", -values)):
        want, plain, auto = _grad_both(v, index, 2, op, g_out)
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(auto, want)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("E,S,d,levels,seed", [
    (300, 40, 3, 3, 0),        # many ties, some empty segments
    (700, 5, 4, 4, 1),         # segments over 128 edges
    (500, 600, 2, 1000, 2),    # mostly empty segments, few ties
    (257, 1, 1, 2, 3),         # one segment of 257 edges, (E,) values
])
def test_backward_matches_jax(op, E, S, d, levels, seed):
    """Values on a few levels (ties in every column), indices drawn from
    [-2, S + 2) (outside [0, S): in no segment, gradient 0)."""
    rng = np.random.default_rng(seed)
    shape = (E,) if d == 1 and seed == 3 else (E, d)
    values = rng.integers(0, levels, shape).astype(np.float32)
    index = rng.integers(-2, S + 2, E).astype(np.int32)
    g_out = rng.standard_normal((S,) + shape[1:]).astype(np.float32)
    want, plain, auto = _grad_both(values, index, S, op, g_out)
    outside = (index < 0) | (index >= S)
    assert outside.any()
    assert not want[outside].any()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(auto, want)


@pytest.mark.parametrize("rows,E,d", [(10, 300, 3), (50, 40, 1), (3, 1, 5)])
def test_gather_rows_backward_is_the_segment_sum(rows, E, d):
    rng = np.random.default_rng(rows + E)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    index = rng.integers(0, rows, E).astype(np.int32)
    g = rng.standard_normal((E, d)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(a[jnp.asarray(index)]
                                      * jnp.asarray(g)))(jnp.asarray(x))
    leaf = torch.from_numpy(x).requires_grad_(True)
    idx = torch.from_numpy(index)
    plan = ops.segment_plan(idx, rows)
    got = ops.gather_rows(leaf, idx, plan)
    np.testing.assert_array_equal(got.detach().numpy(), x[index])
    (grad,) = torch.autograd.grad(got, leaf, torch.from_numpy(g))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    # the plan of an index that sends rows of zero gradient to a trash
    # segment past x's rows gives the same bits
    keep = rng.random(E) < 0.7
    g0 = torch.from_numpy(np.where(keep[:, None], g, 0).astype(np.float32))
    masked = torch.where(torch.from_numpy(keep), idx, rows)
    (a,) = torch.autograd.grad(ops.gather_rows(leaf, idx, plan), leaf, g0)
    (b,) = torch.autograd.grad(
        ops.gather_rows(leaf, idx, ops.segment_plan(masked, rows + 1)),
        leaf, g0)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not of an index"):
        ops.gather_rows(leaf, idx, ops.segment_plan(idx, rows - 1))


# ---------------------------------------------------------------------------
# the models' gradients


def _batch_arrays(n, m, d, graphs, classes, seed, masked):
    """A random batch as numpy arrays: uniform edges, ``graphs`` graphs by
    node id mod graphs; with ``masked``, a quarter of the edges and the
    last few nodes masked off, the masked edges at node 0."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    edge_mask = np.ones(m, bool)
    node_mask = np.ones(n, bool)
    if masked:
        edge_mask = rng.random(m) < 0.75
        src[~edge_mask] = 0
        dst[~edge_mask] = 0
        node_mask[-5:] = False
    return {"node_feat": rng.standard_normal((n, d)).astype(np.float32),
            "edge_index": np.stack([src, dst]), "node_mask": node_mask,
            "edge_mask": edge_mask,
            "positions": rng.standard_normal((n, 3)).astype(np.float32),
            "graph_ids": (np.arange(n) % graphs).astype(np.int32),
            "labels": rng.integers(0, classes, n).astype(np.int32)}


class _Pair:
    """One case in both packages: the JAX loss of the parameters, and the
    port's batch and triplets for the same arrays."""

    def __init__(self, arch_id, jcfg, a, graphs):
        self.jmod = ARCHS[arch_id][0]
        self.jcfg = jcfg
        self.jb = jcommon.GraphBatch(num_graphs=graphs,
                                     **{k: jnp.asarray(v)
                                        for k, v in a.items()})
        self.inputs = {k: torch.from_numpy(v) for k, v in a.items()}
        self.jt = None
        if arch_id == "dimenet":
            kj, ji = jdimenet.build_triplets(a["edge_index"],
                                             a["node_feat"].shape[0],
                                             max_triplets=512)
            self.jt = (jnp.asarray(kj), jnp.asarray(ji))
            self.inputs["triplet_kj"] = torch.from_numpy(kj)
            self.inputs["triplet_ji"] = torch.from_numpy(ji)

    def loss(self, params):
        if self.jt is not None:
            return self.jmod.loss_fn(params, self.jcfg, self.jb, self.jt)
        return self.jmod.loss_fn(params, self.jcfg, self.jb)

    def torch_batch(self, graphs):
        i = self.inputs
        return GraphBatch(num_graphs=graphs, **{
            k: i[k] for k in ("node_feat", "edge_index", "node_mask",
                              "edge_mask", "positions", "graph_ids",
                              "labels")})


def _leaf_close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _grads_match(arch_id, jcfg, tcfg, a, graphs, seed):
    _, rtol = ARCHS[arch_id]
    pair = _Pair(arch_id, jcfg, a, graphs)
    jp = pair.jmod.init(jax.random.PRNGKey(seed), jcfg)
    jloss, jgrads = jax.value_and_grad(pair.loss)(jp)
    tmod = get_arch(arch_id).model
    tp = tmod.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jleaves = jax.tree.leaves(jp)
    tleaves = tree_leaves(tp)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):             # the JAX leaf order
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))
    tp.requires_grad_(True)
    batch = pair.torch_batch(graphs)
    if arch_id == "dimenet":
        tt = (pair.inputs["triplet_kj"], pair.inputs["triplet_ji"])
        loss = tmod.loss_fn(tp, tcfg, batch, tt)
    else:
        loss = tmod.loss_fn(tp, tcfg, batch)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=rtol)
    for i, (g, w) in enumerate(zip(grads, jax.tree.leaves(jgrads))):
        _leaf_close(g.numpy(), w, rtol, f"{arch_id} gradient leaf {i}")
    return grads


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_smoke_gradients_match_jax(arch_id, masked):
    tcfg = get_arch(arch_id).make_smoke_cfg()
    jcfg = j_get_arch(arch_id).make_smoke_cfg()
    d = getattr(tcfg, "d_in", 16)
    a = _batch_arrays(SMOKE_N, SMOKE_M, d, SMOKE_GRAPHS,
                      getattr(tcfg, "n_classes", 2), seed=11, masked=masked)
    grads = _grads_match(arch_id, jcfg, tcfg, a, SMOKE_GRAPHS, seed=4)
    assert all(bool(g.abs().sum() > 0) for g in grads[-2:])


def test_gcn_full_width_gradients_on_full_graph_sm_match_jax():
    s = GNN_SHAPES["full_graph_sm"]
    N, M = _pad(s["n"]), _pad(s["m"])
    a = _batch_arrays(N, M, s["d"], 1, s["classes"], seed=2, masked=False)
    a["edge_mask"][s["m"]:] = False
    a["edge_index"][:, s["m"]:] = 0
    a["node_mask"][s["n"]:] = False
    tcfg = get_arch("gcn-cora")._cfg("full_graph_sm")
    jcfg = j_get_arch("gcn-cora")._cfg("full_graph_sm")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _grads_match("gcn-cora", jcfg, tcfg, a, 1, seed=5)


@pytest.mark.parametrize("arch_id", ["pna", "graphcast"])
def test_published_width_gradients_match_jax(arch_id):
    """PNA (4 layers, d 75) and GraphCast (16 blocks, d 512, 227 outputs)
    at the molecule cell's config on n 120, m 256, masked."""
    tcfg = get_arch(arch_id)._cfg("molecule")
    jcfg = j_get_arch(arch_id)._cfg("molecule")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    a = _batch_arrays(120, 256, tcfg.d_in, 1, getattr(tcfg, "n_classes", 2),
                      seed=6, masked=True)
    _grads_match(arch_id, jcfg, tcfg, a, 1, seed=8)


# ---------------------------------------------------------------------------
# AdamW


def _tree(rng, scale):
    return {"b": [rng.standard_normal((3, 4)).astype(np.float32) * scale,
                  rng.standard_normal((5,)).astype(np.float32) * scale],
            "a": {"w": rng.standard_normal((6, 2)).astype(np.float32)
                  * scale}}


@pytest.mark.parametrize("grad_scale,step", [(10.0, 0), (1e-3, 0),
                                             (10.0, 150), (1e-3, 150)])
def test_adamw_update_matches_jax(grad_scale, step):
    """Clipping active (|g| ~ 10) and inactive (|g| ~ 1e-3), inside the
    warm-up (step 1) and past it (step 151)."""
    rng = np.random.default_rng(step + int(grad_scale * 1000))
    p, g = _tree(rng, 1.0), _tree(rng, grad_scale)
    m, v = _tree(rng, 0.1), jax.tree.map(np.abs, _tree(rng, 0.01))
    cfg = jadamw.AdamWConfig()
    jstate = jadamw.AdamWState(jax.tree.map(jnp.asarray, m),
                               jax.tree.map(jnp.asarray, v),
                               jnp.asarray(step, jnp.int32))
    jp, js, jmet = jadamw.adamw_update(cfg, jax.tree.map(jnp.asarray, p),
                                       jax.tree.map(jnp.asarray, g), jstate)
    tp = [torch.from_numpy(x.copy()) for x in tree_leaves(p)]
    tg = [torch.from_numpy(x) for x in tree_leaves(g)]
    ts = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert [tuple(x.shape) for x in ts.m] == [x.shape for x in tree_leaves(m)]
    out, ts2, met = adamw_update(AdamWConfig(**dataclasses.asdict(cfg)),
                                 tp, tg, ts)
    assert out is tp and ts2.m is ts.m            # in place
    assert int(ts2.step) == step + 1 and ts2.step.dtype == torch.int32
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   rtol=1e-6)
    clipped = float(jmet["grad_norm"]) > cfg.grad_clip
    assert clipped == (grad_scale > 1)
    for got, want in ((tp, jp), (ts2.m, js.m), (ts2.v, js.v)):
        for x, y in zip(got, jax.tree.leaves(want)):
            _leaf_close(x.numpy(), y, 1e-6, "adamw leaf")
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(jadamw.global_norm(g)), rtol=1e-6)
    fresh = adamw_init(tp)
    assert all(not x.any() for x in fresh.m + fresh.v)
    assert int(fresh.step) == 0 and fresh.m[0].dtype == torch.float32


# ---------------------------------------------------------------------------
# train steps


def _jax_step(pair, opt):
    """The JAX package's train step (``repro/configs/base.py``'s
    ``build_step``) on the pair's batch: returns (params, state, loss,
    grads)."""
    def step(params, state):
        loss, grads = jax.value_and_grad(pair.loss)(params)
        params, state, _ = jadamw.adamw_update(opt, params, grads, state)
        return params, state, loss, grads
    return step


def _rounding_level(g, rtol):
    """Entries of a gradient within its tolerance of 0: |g| <= rtol |g| +
    rtol max|g|."""
    g = np.abs(np.asarray(g, np.float64))
    return g <= rtol * g + rtol * g.max()


def _check_params(tleaves, jparams, rtol, lrs, tiny, what):
    """Parameters within the gradient's rule, except the entries whose JAX
    gradient was at rounding level at some step: 2 sum(lr) more there."""
    sign_slack = 2.0 * float(sum(lrs))
    used = 0
    for i, (t, j) in enumerate(zip(tleaves, jax.tree.leaves(jparams))):
        got = t.detach().numpy().astype(np.float64)
        want = np.asarray(j, np.float64)
        limit = rtol * np.abs(want) + rtol * float(np.abs(want).max())
        limit = np.where(tiny[i], limit + sign_slack, limit)
        bad = np.abs(got - want) > limit
        assert not bad.any(), (f"{what} leaf {i}: {int(bad.sum())} entries, "
                               f"max err {float(np.abs(got - want).max())}")
        used += int((tiny[i] & (np.abs(got - want) > limit - sign_slack))
                    .sum())
    return used


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_smoke_train_steps_match_jax(arch_id, steps):
    _, rtol = ARCHS[arch_id]
    arch, jarch = get_arch(arch_id), j_get_arch(arch_id)
    tcfg, jcfg = arch.make_smoke_cfg(), jarch.make_smoke_cfg()
    a = _batch_arrays(SMOKE_N, SMOKE_M, getattr(tcfg, "d_in", 16),
                      SMOKE_GRAPHS, getattr(tcfg, "n_classes", 2), seed=13,
                      masked=True)
    pair = _Pair(arch_id, jcfg, a, SMOKE_GRAPHS)
    jp = pair.jmod.init(jax.random.PRNGKey(9), jcfg)
    jstate = jadamw.adamw_init(jp)
    tp = arch.model.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      "cpu")
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    train_step = arch.build_step(smoke=True)
    jstep = _jax_step(pair, jarch.opt)
    tiny = [np.zeros(np.shape(x), bool) for x in jax.tree.leaves(jp)]
    lrs = []
    for k in range(steps):
        jp, jstate, jloss, jgrads = jstep(jp, jstate)
        for i, g in enumerate(jax.tree.leaves(jgrads)):
            tiny[i] |= _rounding_level(g, rtol)
        lrs.append(jarch.opt.lr * min(1.0, (k + 1) / jarch.opt.warmup_steps))
        tp, tstate, loss = train_step(tp, tstate, pair.inputs)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    assert int(tstate.step) == steps
    _check_params(tree_leaves(tp), jp, rtol, lrs, tiny, arch_id)
    for got, want, r in ((tstate.m, jstate.m, rtol),
                         (tstate.v, jstate.v, 2 * rtol)):
        for i, (x, y) in enumerate(zip(got, jax.tree.leaves(want))):
            _leaf_close(x.numpy(), y, r, f"{arch_id} moment leaf {i}")


def test_gcn_cell_build_steps_agree():
    """One step of the JAX package's own ``build_step`` and the port's on
    GCN's full_graph_sm cell, from the same parameters and inputs."""
    jarch, arch = j_get_arch("gcn-cora"), get_arch("gcn-cora")
    s = GNN_SHAPES["full_graph_sm"]
    a = _batch_arrays(_pad(s["n"]), _pad(s["m"]), s["d"], 1, s["classes"],
                      seed=3, masked=False)
    a["edge_mask"][s["m"]:] = False
    a["node_mask"][s["n"]:] = False
    cfg = jarch._cfg("full_graph_sm")
    jp = jgcn.init(jax.random.PRNGKey(2), cfg)
    jstate = jadamw.adamw_init(jp)
    keys = ("node_feat", "edge_index", "node_mask", "edge_mask", "labels")
    jp2, jstate2, jloss = jarch.build_step("full_graph_sm")(
        jp, jstate, {k: jnp.asarray(a[k]) for k in keys})
    tp0 = arch.model.params_from_numpy(
        jax.tree.map(np.asarray, jp), arch._cfg("full_graph_sm"), "cpu")
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tp, tstate, loss = arch.build_step("full_graph_sm")(
        tp0, tstate, {k: torch.from_numpy(a[k]) for k in keys})
    assert tp is tp0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = jax.grad(lambda p: jgcn.loss_fn(
        p, cfg, jcommon.GraphBatch(**{k: jnp.asarray(a[k]) for k in keys})
    ))(jp)
    tiny = [_rounding_level(g, 1e-5) for g in jax.tree.leaves(grads)]
    _check_params(tree_leaves(tp), jp2, 1e-5, [jarch.opt.lr / 100], tiny,
                  "gcn-cora full_graph_sm")
    for x, y in zip(tstate.m, jax.tree.leaves(jstate2.m)):
        _leaf_close(x.numpy(), y, 1e-5, "gcn-cora first moment")


def test_train_run_matches_the_jax_smoke_run_shape():
    for arch_id in ARCHS:
        res = get_arch(arch_id).train_run(torch.Generator().manual_seed(0),
                                          "cpu")
        assert set(res) == {"loss", "grad_norm"} and res["grad_norm"] > 0


# ---------------------------------------------------------------------------
# the kernels' path, stood in by the plain versions


class _FloatScatters(TorchDispatchMode):
    """Records float scatters (the ops that fold with atomics on a card)
    outside the stand-ins."""

    def __init__(self):
        super().__init__()
        self.paused = False
        self.seen: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__
        if not self.paused and chip_smoke.is_float_scatter(name, args,
                                                           kwargs):
            self.seen.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_train_step_runs_only_the_kernels(arch_id, monkeypatch):
    """With ``ops`` sending CPU tensors to counting stand-ins of the two
    CUDA wrappers, a smoke train step runs no float scatter outside them
    and launches each kernel as often as the model's structure says."""
    mode = _FloatScatters()
    count = {"segment_reduce": 0, "segment_reduce_grad": 0}

    def plain(name, fn):
        def stand_in(*args):
            count[name] += 1
            mode.paused = True
            try:
                return fn(*args)
            finally:
                mode.paused = False
        return stand_in

    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    def rows(o, keys):
        return torch.arange(keys.shape[0]) if o is None else o

    monkeypatch.setattr(ops, "segment_reduce_cuda", plain(
        "segment_reduce", lambda v, o, k, off, op:
        ref.segment_reduce_ref(v, rows(o, k), off, op)))
    monkeypatch.setattr(ops, "segment_reduce_grad_cuda", plain(
        "segment_reduce_grad", lambda g, v, out, o, k, ix, off, op:
        ref.segment_reduce_grad_ref(g, v, out, rows(o, k), off, op)))
    arch = get_arch(arch_id)
    params, inputs = arch.smoke_case(torch.Generator().manual_seed(1), "cpu")
    state = adamw_init(params)
    before = [p.detach().clone() for p in tree_leaves(params)]
    with mode:
        params, state, loss = arch.build_step(smoke=True)(params, state,
                                                          inputs)
    assert mode.seen == []
    assert torch.isfinite(loss)
    assert any(not torch.equal(p, q)
               for p, q in zip(tree_leaves(params), before))
    want = chip_smoke.gnn_train_launches(arch_id, arch.make_smoke_cfg())
    assert (count["segment_reduce"], count["segment_reduce_grad"]) == want
    assert segment_reduce.LAUNCHES["segment_reduce_grad"] == 0


def test_float_scatter_rule():
    f = torch.zeros(4)
    i = torch.zeros(4, dtype=torch.long)
    idx = torch.tensor([0, 1])
    cases = [("index_add_.default", (f, 0, idx, f[:2]), {}, True),
             ("index_add.default", (i, 0, idx, i[:2]), {}, False),
             ("scatter_add.default", (f, 0, idx, f[:2]), {}, True),
             ("scatter_reduce.two", (f, 0, idx, f[:2], "amax"), {}, True),
             ("index_put_.default", (f, (idx,), f[:2], True), {}, True),
             ("index_put_.default", (f, (idx,), f[:2]), {}, False),
             ("_index_put_impl_.default", (f, (idx,), f[:2]),
              {"accumulate": True}, True),
             ("index_select.default", (f, 0, idx), {}, False)]
    for name, args, kwargs, want in cases:
        assert chip_smoke.is_float_scatter(name, args, kwargs) == want, name


# ---------------------------------------------------------------------------
# the sliced power iteration


def test_sliced_power_iteration_folds_through_segment_reduce(monkeypatch):
    jg = jppr.load("web-stanford", scale=512)
    tg = tppr.load("web-stanford", scale=512)
    assert tg.device("cpu").layout == "sliced"
    sources = np.array([0, 7, 42])
    calls = []
    reduce = ops.segment_reduce

    def counting(values, plan, op):
        calls.append((tuple(values.shape), op))
        return reduce(values, plan, op)

    monkeypatch.setattr(ops, "segment_reduce", counting)
    want = jppr.ppr_power_iteration(jg, sources, alpha=0.2)
    got = tppr.ppr_power_iteration(tg, sources, alpha=0.2, device="cpu")
    assert calls and set(calls) == {((tg.edge_src.size, 3), "sum")}
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
