"""Port parity of the attention (K6) and embedding-bag (K5) plain versions
against the JAX package, the CPU/CUDA dispatch, and the wrappers'
argument checks.

K6's plain version is held against ``flash_attention_pallas`` in
interpret mode and ``repro.kernels.ref.flash_attention_ref`` over the
shapes and dtypes of ``tests/test_kernels.py::test_flash_attention_sweep``
at that test's tolerance (3e-5 in float32, 2e-2 in bfloat16); K5's against
``embedding_bag_pallas`` over the shapes of ``test_embedding_bag_sweep`` at
1e-4. The CUDA kernels themselves are held against these plain versions
on a card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``. K6's
route rule and its split of the visible keys over blocks (route B) are
plain Python, tested here.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import embedding_bag, flash_attention, ops, ref

ATTN_SHAPES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 100, 100, 4, 2, 32, True, 0),        # GQA + ragged block tail
    (1, 1, 256, 4, 1, 64, True, 255),        # decode shape (MQA)
    (2, 64, 192, 8, 8, 128, False, 0),       # cross, no mask
    (1, 37, 53, 2, 1, 16, True, 16),         # odd everything + offset
]
DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(B, Sq, Skv, Hq, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, Dh), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, Dh), dtype=np.float32))


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal,off", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_plain_matches_pallas_and_ref(B, Sq, Skv, Hq, Hkv, Dh,
                                                causal, off, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _qkv(B, Sq, Skv, Hq, Hkv, Dh, seed=Sq + Skv)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    want_pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, q_offset=off, block_q=32, block_k=64,
        interpret=True), np.float32)
    want_ref = np.asarray(jref.flash_attention_ref(
        jq, jk, jv, causal=causal, q_offset=off), np.float32)
    got = ops.flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    assert got.dtype == tdt and got.shape == tq.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_ref, atol=tol, rtol=tol)


def test_attention_plain_float64_and_strided_cache():
    """The card check's float64 run agrees with float32, and a strided view
    of a cache gives the answer of its contiguous copy."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 40, 4, 2, 16, 3))
    cache = torch.zeros((2, 2, 64, 2, 16))
    cache[0, :, :40], cache[1, :, :40] = k, v
    strided = ref.flash_attention_ref(q, cache[0], cache[1], q_offset=39)
    plain = ref.flash_attention_ref(q, k, v, q_offset=39)
    torch.testing.assert_close(strided, plain, rtol=1e-6, atol=1e-7)
    f64 = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                  q_offset=39)
    assert f64.dtype == torch.float64
    torch.testing.assert_close(f64.float(), plain, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("V,d,B,L", [(100, 8, 16, 5), (1000, 18, 64, 100),
                                     (64, 32, 300, 7), (50_000, 16, 128, 64)])
def test_embedding_bag_plain_matches_pallas(V, d, B, L):
    rng = np.random.default_rng(V + L)
    table = rng.standard_normal((V, d), dtype=np.float32)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    w = rng.random((B, L), dtype=np.float32)
    want = np.asarray(embedding_bag_pallas(jnp.asarray(table),
                                           jnp.asarray(ids), jnp.asarray(w)))
    got = ops.embedding_bag(*(torch.from_numpy(a) for a in (table, ids, w)))
    assert got.dtype == torch.float32 and got.shape == (B, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.embedding_bag_ref(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w))),
        atol=1e-5, rtol=1e-5)


def test_embedding_bag_broadcast_ids_equal_copied_ids():
    """Retrieval pools one history for every candidate through a row-stride
    0 view of the ids; it must equal the pooled copy."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((300, 6), dtype=np.float32))
    hist = torch.from_numpy(rng.integers(0, 300, 12).astype(np.int32))
    w = torch.from_numpy(rng.random((9, 12), dtype=np.float32))
    view = hist[None].expand(9, 12)
    assert view.stride() == (0, 1)
    torch.testing.assert_close(ops.embedding_bag(table, view, w),
                               ops.embedding_bag(table, view.contiguous(), w))


def test_dispatch_routes_by_device_and_wrappers_refuse_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 4, 2, 1, 16, 0))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention_cuda(q, k, v)
    table = torch.zeros((10, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.ones((2, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        embedding_bag.embedding_bag_cuda(table, ids, w)
    flash_attention.reset_launches()
    embedding_bag.reset_launches()
    ops.flash_attention(q, k, v)
    ops.embedding_bag(table, ids, w)
    assert flash_attention.LAUNCHES == {"flash_attention": 0,
                                        "flash_attention_mma": 0,
                                        "flash_attention_split": 0}
    assert embedding_bag.LAUNCHES == {"embedding_bag": 0,
                                      "embedding_bag_gather": 0,
                                      "embedding_bag_shared": 0}


# (B, Hkv, rows = Sq * Hq / Hkv, kv_end, SMs): gemma-2b's decode on an H100
# at the first and last step of the smoke run, a GQA decode, a short cache,
# a cache shorter than one split, and a grid that already fills the card
SPLIT_CASES = [(4, 1, 8, 4113, 132), (4, 1, 8, 4128, 132),
               (2, 2, 2, 71, 132), (1, 1, 4, 256, 132), (3, 1, 8, 20, 132),
               (1, 4, 74, 53, 132), (64, 8, 8, 1000, 132)]


@pytest.mark.parametrize("B,Hkv,rows,kv_end,sms", SPLIT_CASES)
def test_split_plan_covers_every_visible_key_once(B, Hkv, rows, kv_end,
                                                  sms):
    splits = flash_attention.split_plan(B, Hkv, rows, kv_end, sms)
    bounds = flash_attention.split_bounds(kv_end, splits)
    assert len(bounds) == splits >= 1
    covered = np.zeros(kv_end, dtype=int)
    for lo, hi in bounds:
        assert hi > lo                               # no split is empty
        covered[lo:hi] += 1
    assert (covered == 1).all()                      # each key exactly once
    blocks = -(-rows // flash_attention.SPLIT_ROW_TILE) * Hkv * B
    if blocks >= 2 * sms:
        assert splits == 1                           # no merge pass
    else:                                            # fill the card, or
        assert (blocks * splits >= 2 * sms           # split to the least
                or min(hi - lo for lo, hi in bounds)  # keys a split allows
                < 2 * flash_attention.MIN_SPLIT_KEYS)


def test_split_plan_fills_the_card_at_gemma_decode_only():
    """gemma-2b (8 query heads on 1 KV head) at B 4 on 132 SMs: a decode
    step over 4,113 visible keys gets at least 2 x 132 blocks; the
    4 x 4,096 prefill's grid already fills the card, so one split."""
    decode = flash_attention.split_plan(4, 1, 8, 4113, 132)
    assert decode > 1
    assert decode * -(-8 // flash_attention.SPLIT_ROW_TILE) * 4 >= 264
    assert flash_attention.split_plan(4, 1, 4096 * 8, 4096, 132) == 1


@pytest.mark.parametrize("dtype,Sq,Hq,Hkv,Dh,want", [
    (torch.bfloat16, 4096, 8, 1, 256, "mma"),      # gemma-2b prefill
    (torch.bfloat16, 8, 8, 1, 256, "mma"),         # 64 folded rows
    (torch.bfloat16, 32, 2, 1, 16, "mma"),
    (torch.bfloat16, 64, 4, 4, 128, "mma"),        # MHA
    (torch.bfloat16, 1, 8, 1, 256, "split"),       # gemma-2b decode
    (torch.bfloat16, 7, 8, 1, 256, "split"),       # 56 folded rows
    (torch.bfloat16, 33, 8, 8, 8, "split"),        # Dh 8
    (torch.float32, 4096, 8, 1, 256, "split"),     # float32: no TF32
    (torch.float32, 128, 2, 2, 64, "split"),
])
def test_route_rule(dtype, Sq, Hq, Hkv, Dh, want):
    assert flash_attention.route(dtype, Sq, Hq, Hkv, Dh) == want
