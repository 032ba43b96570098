"""The card's live endpoint fold in torch on the CPU.

``ref.endpoint_fold_fixed_ref`` repeats ``csrc/endpoint_fold.cu``'s
arithmetic step for step (the card tests hold the kernel to it bit for
bit): each lane's weight an int64 on its row's scale 2^s, s = 188 -
ceil(log2 W) - E (E the largest participating weight's biased exponent),
the integers summed, each sum back to float32. Here it is held to the
float64 plain version within the bound that the kernel's header derives
(a cell of k lanes off by at most k * 2^(e + l - 63), plus the two final
roundings), to its own bits under a lane permutation and inside a batch,
and to the JAX package's ``segment_sum``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

SHAPES = [(1, 1, 5), (3, 300, 20), (2, 4097, 1000), (8, 1 << 14, 2000)]
CASES = ["uniform", "active", "hub", "skew", "binades", "equal"]


def _inputs(case: str, B: int, W: int, n: int, seed: int):
    """pos (B, W) int32 and float32 weights (B, W) for one case, from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, n, (B, W), dtype=np.int32)
    w = rng.random((B, W), dtype=np.float32)
    if case == "active":                   # lanes past a row's count weigh 0
        act = rng.integers(1, W + 1, (B, 1))
        w = np.where(np.arange(W)[None] < act, w, 0.0).astype(np.float32)
    elif case == "hub":
        pos[:] = n // 2
    elif case == "skew":                   # a fifth of the lanes at node 7
        pos = np.where(rng.random((B, W)) < 0.2, min(7, n - 1),
                       pos).astype(np.int32)
    elif case == "binades":                # weights over 40 binades
        w = np.ldexp(1.0 + rng.random((B, W)),
                     -rng.integers(0, 40, (B, W))).astype(np.float32)
    elif case == "equal":                  # the walks' r_sum / w_eff
        act = rng.integers(1, W + 1, (B, 1))
        share = (rng.random((B, 1)) / act).astype(np.float32)
        w = np.where(np.arange(W)[None] < act, share, 0.0).astype(np.float32)
    return torch.from_numpy(pos), torch.from_numpy(w)


def _bound(pos, w, n: int) -> torch.Tensor:
    """The header's bound on |fixed - exact| a cell: k lanes of at most
    2^(e + l - 63) each (k counted among the lanes that take part), then
    int64 -> float64 (2^-53) and float64 -> float32 (2^-24) of the
    result."""
    W = pos.shape[1]
    keep = (w > 0) & (pos >= 0) & (pos < n)
    e = torch.where(keep, w.double(), 0.0).amax(dim=1).frexp().exponent
    unit = torch.ldexp(torch.ones_like(e, dtype=torch.float64),
                       e + (W - 1).bit_length() - 63)
    count = ref.endpoint_fold_ref(torch.where(keep, pos, 0),
                                  keep.double(), n)
    want = ref.endpoint_fold_ref(torch.where(keep, pos, 0),
                                 torch.where(keep, w.double(), 0.0), n)
    lanes = count * unit[:, None]
    return lanes * (1 + 2.0**-20) + (2.0**-53 + 2.0**-24) * (want + lanes)


@pytest.mark.parametrize("B,W,n", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_fixed_fold_within_its_bound_of_float64(B, W, n, case):
    pos, w = _inputs(case, B, W, n, seed=B * 31 + W)
    got = ref.endpoint_fold_fixed_ref(pos, w, n)
    want = ref.endpoint_fold_ref(pos, w.double(), n)
    assert got.dtype == torch.float32 and got.shape == (B, n)
    err = (got.double() - want).abs()
    assert bool((err <= _bound(pos, w, n)).all()), float(
        (err / _bound(pos, w, n).clamp_min(1e-300)).max())
    if case == "equal":                    # rows of equal weights: relative
        rel = (2.0**((W - 1).bit_length() - 62) + 2.0**-53 + 2.0**-24)
        assert bool((err <= rel * (1 + 2.0**-20) * want).all())


@pytest.mark.parametrize("case", ["uniform", "hub", "skew", "binades"])
def test_fixed_fold_is_segment_sum(case):
    B, W, n = 2, 3000, 500
    pos, w = _inputs(case, B, W, n, seed=7)
    want = np.stack([np.asarray(jax.ops.segment_sum(
        jnp.asarray(w[b].numpy()), jnp.asarray(pos[b].numpy()),
        num_segments=n)) for b in range(B)])
    got = ref.endpoint_fold_fixed_ref(pos, w, n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("B,W,n", SHAPES[1:])
@pytest.mark.parametrize("case", ["uniform", "active", "skew", "binades"])
def test_fixed_fold_bits_ignore_lane_order(B, W, n, case):
    pos, w = _inputs(case, B, W, n, seed=W)
    got = ref.endpoint_fold_fixed_ref(pos, w, n)
    rng = np.random.default_rng(W + 1)
    for _ in range(3):
        perm = torch.from_numpy(rng.permuted(
            np.tile(np.arange(W), (B, 1)), axis=1))
        again = ref.endpoint_fold_fixed_ref(torch.gather(pos, 1, perm),
                                            torch.gather(w, 1, perm), n)
        assert torch.equal(again, got)


@pytest.mark.parametrize("case", ["uniform", "active", "hub", "binades",
                                  "equal"])
def test_fixed_fold_row_alone_is_its_row_in_a_batch(case):
    B, W, n = 8, 5000, 700
    pos, w = _inputs(case, B, W, n, seed=3)
    batch = ref.endpoint_fold_fixed_ref(pos, w, n)
    for b in range(B):
        alone = ref.endpoint_fold_fixed_ref(pos[b:b + 1], w[b:b + 1], n)
        assert torch.equal(alone[0], batch[b])


def test_fixed_fold_zero_rows_and_lanes_outside_the_graph():
    pos = torch.tensor([[0, 4, -1, 2, 9, 4], [1, 1, 1, 3, 3, 0]],
                       dtype=torch.int32)
    w = torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0, 32.0], [0.0] * 6])
    got = ref.endpoint_fold_fixed_ref(pos, w, 5)
    assert got.tolist() == [[1.0, 0.0, 8.0, 0.0, 34.0], [0.0] * 5]
    # a lane outside the graph sets no part of the row's scale either
    big = torch.tensor([[0, 4, -1, 2, 9, 4]], dtype=torch.int32)
    heavy = torch.tensor([[1.0, 2.0, 2.0**60, 8.0, 2.0**70, 32.0]])
    assert torch.equal(ref.endpoint_fold_fixed_ref(big, heavy, 5), got[:1])


def test_fixed_fold_does_not_overflow_at_the_lane_cap():
    """W = 2^22 (the lane cap), every lane at one cell: the lanes' integers
    sum to at most 2^62."""
    W, n = 1 << 22, 3
    pos = torch.ones((1, W), dtype=torch.int32)
    for w in (torch.full((1, W), 0.9999999, dtype=torch.float32),
              torch.full((1, W), 2.0**-30, dtype=torch.float32),
              torch.from_numpy(np.random.default_rng(0).random(
                  (1, W), dtype=np.float32))):
        got = ref.endpoint_fold_fixed_ref(pos, w, n)
        want = float(w.double().sum())
        assert got[0, 0] == 0 and got[0, 2] == 0
        assert abs(float(got[0, 1]) - want) <= 2.0**-22 * want


@pytest.mark.parametrize("log_w", [20, 21])
def test_fixed_fold_adversarial_cell_within_atol_up_to_2_21_lanes(log_w):
    """The header's input class: a row of mixed weights whose other lanes
    all weigh half a unit (each rounds to 0) and share one cell stays
    within 1e-6 of the largest output up to W = 2^21."""
    W, n = 1 << log_w, 4
    e = 1                                   # the largest weight, 1.0 < 2^e
    w = torch.full((1, W), 2.0**(e + log_w - 63), dtype=torch.float32)
    w[0, 0] = 1.0
    pos = torch.full((1, W), 2, dtype=torch.int32)
    pos[0, 0] = 0
    got = ref.endpoint_fold_fixed_ref(pos, w, n)
    want = ref.endpoint_fold_ref(pos, w.double(), n)
    assert float(got[0, 2]) == 0.0          # every half unit rounds to even
    err = float((got.double() - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max())
    assert err <= float(_bound(pos, w, n).max())


def test_coarser_scale_is_a_coarser_fold():
    """``scale_cut`` takes bits off every row's scale: the check that must
    refuse a coarse fold sees it."""
    pos, w = _inputs("equal", 2, 1 << 20, 300, seed=5)
    want = ref.endpoint_fold_ref(pos, w.double(), 300)
    fine = (ref.endpoint_fold_fixed_ref(pos, w, 300).double() - want).abs()
    coarse = (ref.endpoint_fold_fixed_ref(pos, w, 300, scale_cut=32).double()
              - want).abs()
    assert float(coarse.max()) > 1e-5 * float(want.abs().max())
    assert float(fine.max()) <= 2.0**-23 * float(want.abs().max())
