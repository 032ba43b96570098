"""Port parity of the GNN family against the JAX package on the CPU: the
four models' ``apply`` and ``loss_fn`` with the JAX parameters carried
across by ``params_from_numpy``, on the same numpy batches (the smoke
configurations, with and without masked edges and nodes, and GCN at its
full width on full_graph_sm); DimeNet's host code and the neighbour
sampler array-equal; ``model_flops``/``model_bytes`` equal for all 16
cells; ``make_inputs``' shapes and masks; the registry. The aggregations
run through ``ops.segment_reduce``, whose CPU path is the plain version.

Tolerances, each with an atol of rtol x the output's largest |entry|:
GCN rtol 1e-5 (two float32 layers, sums of a few terms); PNA 1e-4 (its
std is sqrt(E[m^2] - E[m]^2), which cancels); GraphCast 1e-4 (16 layer
norms in the full config, 2 here, each dividing by a float32 std);
DimeNet 1e-4 (the spherical Bessel recurrences divide by x at every
order, and the bilinear term sums in another order than the einsum).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data import neighbor_sampler as j_sampler
from repro.models.gnn import common as jcommon
from repro.models.gnn import dimenet as jdimenet
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import graphcast as jgraphcast
from repro.models.gnn import pna as jpna
from repro.ppr import datasets as j_datasets
from repro_torch.configs import GNN_SHAPES, LATER, GNNArch, get_arch
from repro_torch.configs.base import _pad, _triplet_budget
from repro_torch.data import neighbor_sampler as t_sampler
from repro_torch.kernels import segment_reduce
from repro_torch.models.gnn import GraphBatch
from repro_torch.models.gnn import dimenet as tdimenet
from repro_torch.ppr import datasets as t_datasets

ARCHS = {"gcn-cora": (jgcn, 1e-5), "pna": (jpna, 1e-4),
         "graphcast": (jgraphcast, 1e-4), "dimenet": (jdimenet, 1e-4)}


def _batch_arrays(n: int, m: int, d: int, graphs: int, classes: int,
                  seed: int, masked: bool) -> dict:
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


def _batches(a: dict, graphs: int):
    jb = jcommon.GraphBatch(num_graphs=graphs,
                            **{k: jnp.asarray(v) for k, v in a.items()})
    tb = GraphBatch(num_graphs=graphs,
                    **{k: torch.from_numpy(v) for k, v in a.items()})
    return jb, tb


def _run_both(arch_id: str, jcfg, tcfg, a: dict, graphs: int, seed: int):
    jmod, _ = ARCHS[arch_id]
    tmod = get_arch(arch_id).model
    jp = jmod.init(jax.random.PRNGKey(seed), jcfg)
    tp = tmod.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jb, tb = _batches(a, graphs)
    if arch_id == "dimenet":
        kj, ji = jdimenet.build_triplets(a["edge_index"], a["node_feat"]
                                         .shape[0], max_triplets=512)
        jt = (jnp.asarray(kj), jnp.asarray(ji))
        tt = (torch.from_numpy(kj), torch.from_numpy(ji))
        want = jmod.apply(jp, jcfg, jb, jt)
        want_loss = jmod.loss_fn(jp, jcfg, jb, jt)
        got = tmod.apply(tp, tcfg, tb, tt)
        got_loss = tmod.loss_fn(tp, tcfg, tb, tt)
    else:
        want = jmod.apply(jp, jcfg, jb)
        want_loss = jmod.loss_fn(jp, jcfg, jb)
        got = tmod.apply(tp, tcfg, tb)
        got_loss = tmod.loss_fn(tp, tcfg, tb)
    return (np.asarray(want), float(want_loss), got.numpy(),
            float(got_loss), jp, tp)


def _close(got, want, rtol):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_smoke_apply_and_loss_match_jax(arch_id, masked):
    _, rtol = ARCHS[arch_id]
    tcfg = get_arch(arch_id).make_smoke_cfg()
    jcfg = j_get_arch(arch_id).make_smoke_cfg()
    d = getattr(tcfg, "d_in", 16)
    a = _batch_arrays(64, 256, d, 4, getattr(tcfg, "n_classes", 2),
                      seed=7, masked=masked)
    segment_reduce.reset_launches()
    want, want_loss, got, got_loss, jp, tp = _run_both(arch_id, jcfg, tcfg,
                                                       a, 4, seed=3)
    assert segment_reduce.LAUNCHES["segment_reduce"] == 0   # CPU tensors
    _close(got, want, rtol)
    np.testing.assert_allclose(got_loss, want_loss, rtol=rtol)
    n = sum(np.asarray(x).size for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n
    assert get_arch(arch_id).model.param_count(tcfg) == n


def test_gcn_full_width_on_full_graph_sm_matches_jax():
    """gcn-cora at its published width (d_in 1,433, d 16, 7 classes) on the
    padded full_graph_sm cell: 2,708 of 2,816 nodes and 10,556 of 10,624
    edges real."""
    s = GNN_SHAPES["full_graph_sm"]
    N, M = _pad(s["n"]), _pad(s["m"])
    a = _batch_arrays(N, M, s["d"], 1, s["classes"], seed=2, masked=False)
    a["edge_mask"][s["m"]:] = False
    a["edge_index"][:, s["m"]:] = 0
    a["node_mask"][s["n"]:] = False
    tcfg = get_arch("gcn-cora")._cfg("full_graph_sm")
    jcfg = j_get_arch("gcn-cora")._cfg("full_graph_sm")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want, want_loss, got, got_loss, _, _ = _run_both("gcn-cora", jcfg, tcfg,
                                                     a, 1, seed=5)
    _close(got, want, 1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)


@pytest.mark.parametrize("L,N", [(7, 6), (3, 4)])
def test_bessel_roots_equal_jax(L, N):
    np.testing.assert_array_equal(tdimenet.bessel_roots(L, N),
                                  jdimenet.bessel_roots(L, N))


@pytest.mark.parametrize("n,m,budget", [(30, 64, None), (200, 900, None),
                                        (50, 400, 300), (5, 0, None)])
def test_build_triplets_equal_jax(n, m, budget):
    rng = np.random.default_rng(n + m)
    ei = rng.integers(0, n, (2, m)).astype(np.int32)
    want = jdimenet.build_triplets(ei, n, max_triplets=budget)
    got = tdimenet.build_triplets(ei, n, max_triplets=budget)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if budget is not None:
        assert got[0].size == budget


@pytest.fixture(scope="module")
def graphs():
    jg = j_datasets.load("web-stanford", scale=64)
    tg = t_datasets.load("web-stanford", scale=64)
    np.testing.assert_array_equal(jg.edge_src, tg.edge_src)
    np.testing.assert_array_equal(jg.edge_dst, tg.edge_dst)
    return jg, tg


def _same_subgraph(a, b):
    for f in ("nodes", "node_mask", "edge_index", "edge_mask"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.seed_count == b.seed_count


@pytest.mark.parametrize("fanout", [(15, 10), (3,), (4, 3, 2)])
def test_sample_subgraph_equals_jax(graphs, fanout):
    jg, tg = graphs
    seeds = np.random.default_rng(1).integers(0, jg.n, 64)
    a = j_sampler.sample_subgraph(jg, seeds, fanout,
                                  np.random.default_rng(9))
    b = t_sampler.sample_subgraph(tg, seeds, fanout,
                                  np.random.default_rng(9))
    _same_subgraph(a, b)
    c = j_sampler.sample_subgraph(jg, seeds, fanout, np.random.default_rng(9),
                                  pad_nodes=20_000, pad_edges=20_000)
    d = t_sampler.sample_subgraph(tg, seeds, fanout, np.random.default_rng(9),
                                  pad_nodes=20_000, pad_edges=20_000)
    _same_subgraph(c, d)
    with pytest.raises(ValueError, match="exceeds padding"):
        t_sampler.sample_subgraph(tg, seeds, fanout, np.random.default_rng(9),
                                  pad_nodes=10, pad_edges=10)


def test_minibatch_stream_equals_jax(graphs):
    jg, tg = graphs
    kw = dict(batch_nodes=256, fanout=(15, 10), pad_nodes=30_000,
              pad_edges=30_000, seed=4, shard=1, num_shards=2)
    js = j_sampler.minibatch_stream(jg, **kw)
    ts = t_sampler.minibatch_stream(tg, **kw)
    for _ in range(3):
        _same_subgraph(next(js), next(ts))


@pytest.mark.parametrize("arch_id", list(ARCHS))
@pytest.mark.parametrize("shape_id", list(GNN_SHAPES))
def test_model_flops_and_bytes_equal_jax(arch_id, shape_id):
    t, j = get_arch(arch_id), j_get_arch(arch_id)
    assert t.kind(shape_id) == j.kind(shape_id) == "train"
    assert t.model_flops(shape_id) == j.model_flops(shape_id)
    assert t.model_bytes(shape_id) == j.model_bytes(shape_id)
    assert t.forward_flops(shape_id) == pytest.approx(
        t.model_flops(shape_id) / 3, rel=1e-12)
    assert t.forward_bytes(shape_id) < t.model_bytes(shape_id)


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_make_inputs_shapes_and_masks(arch_id):
    arch = get_arch(arch_id)
    for shape_id in ("full_graph_sm", "molecule"):
        s = GNN_SHAPES[shape_id]
        N, M, g = _pad(s["n"]), _pad(s["m"]), s["graphs"]
        inp = arch.make_inputs(shape_id, torch.Generator().manual_seed(0),
                               "cpu")
        assert inp["node_feat"].shape == (N, s["d"])
        assert inp["edge_index"].shape == (2, M)
        assert inp["edge_index"].dtype == torch.int32
        assert int(inp["node_mask"].sum()) == s["n"]
        assert int(inp["edge_mask"].sum()) == s["m"]
        ei = inp["edge_index"]
        assert bool((ei[:, ~inp["edge_mask"]] == 0).all())
        assert int(ei.max()) < s["n"]
        if g > 1:     # edges stay within their graph
            npg = s["n"] // g
            assert bool((ei[0] // npg == ei[1] // npg).all())
        if arch_id == "dimenet":
            t = _triplet_budget(s["m"])
            assert inp["triplet_kj"].shape == inp["triplet_ji"].shape == (t,)
            gid = inp["graph_ids"]
            assert bool((gid[~inp["node_mask"]] == g).all())
            assert int(gid[inp["node_mask"]].max()) == g - 1
            assert inp["labels"].shape == (g, arch._cfg(shape_id).n_out)
            ji = inp["triplet_ji"]
            real = ji < M
            kj, jj = tdimenet.build_triplets(
                ei[:, :s["m"]].numpy(), s["n"], max_triplets=t)
            assert int(real.sum()) == kj.size
            np.testing.assert_array_equal(inp["triplet_kj"][real].numpy(),
                                          kj)
        elif arch_id == "graphcast":
            assert inp["labels"].shape == (N, arch._cfg(shape_id).n_out)
        else:
            assert inp["labels"].shape == (N,)
            assert int(inp["labels"].max()) < arch._cfg(shape_id).n_classes
    if arch_id != "gcn-cora":
        with pytest.raises(ValueError, match="does not fit"):
            arch.make_inputs("ogb_products", torch.Generator(), "cpu")


def test_forward_step_on_a_cell_and_infer_run():
    arch = get_arch("pna")
    gen = torch.Generator().manual_seed(1)
    inp = arch.make_inputs("molecule", gen, "cpu")
    params = arch.init_params(gen, "cpu", shape_id="molecule")
    fwd = arch.forward_step("molecule")
    out, loss = fwd(params, inp)
    again, loss2 = fwd(params, inp)
    assert out.shape == (3840, 2) and torch.isfinite(out).all()
    assert torch.equal(out, again) and float(loss) == float(loss2)
    with pytest.raises(NotImplementedError):
        arch.build_step("molecule")
    for arch_id in ARCHS:
        res = get_arch(arch_id).infer_run(torch.Generator().manual_seed(0),
                                          "cpu")
        assert set(res) == {"loss", "output_mean"}


def test_registry_has_the_gnns():
    for arch_id in ARCHS:
        arch = get_arch(arch_id)
        assert isinstance(arch, GNNArch) and arch.arch_id == arch_id
    assert LATER == ("ppr-fora",)
    with pytest.raises(KeyError, match="not ported yet"):
        get_arch("ppr-fora")
    assert get_arch("graphcast").skip_reason("ogb_products")
    assert get_arch("gcn-cora").skip_reason("ogb_products") is None


def test_minibatch_inputs_from_a_small_graph(graphs):
    """minibatch_lg's construction on the scale-64 web-stanford stand-in:
    its padded shapes, masks and rows gathered by the sampled nodes."""
    _, tg = graphs
    arch = get_arch("gcn-cora")
    inp = arch.make_inputs("minibatch_lg", torch.Generator().manual_seed(2),
                           "cpu", graph=tg)
    N, M = GNN_SHAPES["minibatch_lg"]["n"], GNN_SHAPES["minibatch_lg"]["m"]
    assert inp["node_feat"].shape == (N, 602)
    assert inp["edge_index"].shape == (2, M)
    n, m = int(inp["node_mask"].sum()), int(inp["edge_mask"].sum())
    assert 1024 <= n <= tg.n and m > 0
    assert bool(inp["node_mask"][:n].all())
    assert bool(inp["edge_mask"][:m].all())
    assert bool((inp["edge_index"][:, m:] == 0).all())
    assert int(inp["edge_index"][:, :m].max()) < n
