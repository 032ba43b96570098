"""Port parity of DIN's serving path against the JAX package: ``score``
and ``score_candidates`` (unfactored and factored, two block sizes) on
``din_arch.SMOKE`` with the JAX parameters carried across by
``din.params_from_numpy``, and the port's mirror of the JAX factored
retrieval test. The history pooling runs through ``ops.embedding_bag``,
whose CPU path is K5's plain version.

Tolerances: scores at rtol 1e-5 (atol 1e-6); the factored retrieval
against the unfactored one at the JAX test's atol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import din_arch as j_din_arch
from repro.models.recsys import din as jdin
from repro_torch.configs import din_arch
from repro_torch.kernels import embedding_bag
from repro_torch.models.recsys import din as tdin

KEY = jax.random.PRNGKey(0)


def _din_pair():
    jcfg, tcfg = j_din_arch.SMOKE, din_arch.SMOKE
    jp = jdin.init(KEY, jcfg)
    tp = tdin.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _din_batch(cfg, B: int, n_cand: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    L = cfg.seq_len
    return {"hist_items": rng.integers(0, cfg.n_items, (B, L)).astype(
                np.int32),
            "hist_cats": rng.integers(0, cfg.n_cats, (B, L)).astype(np.int32),
            "hist_mask": rng.random((B, L)) < 0.8,
            "target_item": rng.integers(0, cfg.n_items, B).astype(np.int32),
            "target_cat": rng.integers(0, cfg.n_cats, B).astype(np.int32),
            "cand_items": rng.integers(0, cfg.n_items, n_cand).astype(
                np.int32),
            "cand_cats": rng.integers(0, cfg.n_cats, n_cand).astype(
                np.int32)}


def test_din_params_from_numpy_is_a_module():
    jcfg, tcfg, jp, tp = _din_pair()
    assert isinstance(tp, torch.nn.Module)
    np.testing.assert_array_equal(tp.item_emb.numpy(),
                                  np.asarray(jp["item_emb"]))
    assert len(tp.attn.weights) == len(jp["attn"])
    n = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n


def test_din_score_matches_jax():
    jcfg, tcfg, jp, tp = _din_pair()
    b = _din_batch(jcfg, 16, 0, seed=4)
    want = jdin.score(jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    embedding_bag.reset_launches()
    got = tdin.score(tp, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    assert embedding_bag.LAUNCHES["embedding_bag"] == 0      # CPU tensors
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("n_cand,block", [(300, 64), (256, 256)])
def test_din_score_candidates_matches_jax(factored, n_cand, block):
    jcfg, tcfg, jp, tp = _din_pair()
    b = _din_batch(jcfg, 1, n_cand, seed=n_cand)
    want = jdin.score_candidates(jp, jcfg,
                                 {k: jnp.asarray(v) for k, v in b.items()},
                                 block=block, factored=factored)
    got = tdin.score_candidates(tp, tcfg,
                                {k: torch.from_numpy(v)
                                 for k, v in b.items()},
                                block=block, factored=factored)
    assert got.shape == (n_cand,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_din_factored_retrieval_exact():
    """Mirror of the JAX test of the same name, inside the port."""
    cfg = tdin.DINConfig(n_items=500, n_cats=20, embed_dim=6, seq_len=12,
                         attn_mlp=(16, 8), mlp=(24, 12))
    p = tdin.init(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"hist_items": torch.randint(0, 500, (1, 12), generator=g,
                                         dtype=torch.int32),
             "hist_cats": torch.randint(0, 20, (1, 12), generator=g,
                                        dtype=torch.int32),
             "hist_mask": torch.rand((1, 12), generator=g) < 0.8,
             "cand_items": torch.randint(0, 500, (300,), generator=g,
                                         dtype=torch.int32),
             "cand_cats": torch.randint(0, 20, (300,), generator=g,
                                        dtype=torch.int32)}
    a = tdin.score_candidates(p, cfg, batch, block=64)
    b = tdin.score_candidates(p, cfg, batch, block=64, factored=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_din_candidates_equal_pointwise_scores():
    """Scoring N candidates against one user equals ``score`` on the N
    (user, candidate) pairs."""
    _, tcfg, _, tp = _din_pair()
    b = {k: torch.from_numpy(v) for k, v in
         _din_batch(tcfg, 1, 100, seed=6).items()}
    cand = tdin.score_candidates(tp, tcfg, b, block=32)
    pairs = {k: b[k].expand(100, -1) for k in
             ("hist_items", "hist_cats", "hist_mask")}
    pairs["target_item"], pairs["target_cat"] = b["cand_items"], \
        b["cand_cats"]
    np.testing.assert_allclose(cand.numpy(),
                               tdin.score(tp, tcfg, pairs).numpy(),
                               rtol=1e-5, atol=1e-6)


# K5's ids outside [0, V) (V = 4): [-V, 0) wraps to id + V, and a bag with
# an id outside [-V, V) is NaN in every column, as jnp.take reads them
BAG_IDS = [[[0, -1]], [[0, 5]], [[-4, 3]], [[-5, 0]], [[2, 4], [1, -2]],
           [[0, 1], [3, -3]]]


@pytest.mark.parametrize("ids", BAG_IDS)
@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_reads_ids_as_jax(ids, weighted):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops, ref as tref

    rng = np.random.default_rng(len(ids))
    table = rng.standard_normal((4, 3)).astype(np.float32)
    ids = np.asarray(ids, np.int32)
    w = rng.random(ids.shape).astype(np.float32) if weighted else None
    want = np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(ids),
        None if w is None else jnp.asarray(w)))
    got = tref.embedding_bag_ref(torch.from_numpy(table),
                                 torch.from_numpy(ids),
                                 None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7,
                               equal_nan=True)
    assert np.isnan(want).any() == bool(((ids < -4) | (ids >= 4)).any())
    if weighted:
        np.testing.assert_array_equal(
            ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                              torch.from_numpy(w)).numpy(), got.numpy())
