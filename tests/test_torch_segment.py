"""The port's segment reduction on the CPU: ``ops.segment_plan`` and the
plain ``segment_reduce`` against ``jax.ops.segment_sum/max/min`` on the
same numpy inputs, and the dispatch sending a CPU tensor to the plain
version (no kernel launch).

Tolerances: sums at rtol 1e-6 with atol 1e-6 x the largest |output| (float32
sums of at most a few hundred terms, in another order than XLA's); max and
min exactly (no rounding in either).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref, segment_reduce

JAX_OPS = {"sum": jax.ops.segment_sum, "max": jax.ops.segment_max,
           "min": jax.ops.segment_min}


def _jax(values: np.ndarray, index: np.ndarray, S: int, op: str):
    return np.asarray(JAX_OPS[op](jnp.asarray(values), jnp.asarray(index),
                                  num_segments=S))


def _check(got: np.ndarray, want: np.ndarray, op: str) -> None:
    assert got.shape == want.shape
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * max(np.abs(want).max(), 1.0))
    else:
        np.testing.assert_array_equal(got, want)


# (E, S, d, index range): unsorted indices, empty segments (S well above
# the edges' spread), indices outside [0, S) (dropped), d = 1 as a 1-D
# values vector, a narrow and a wide row, and long segments (many runs)
CASES = [(400, 60, 7, (0, 60)), (300, 80, 0, (0, 40)),
         (500, 10, 16, (-3, 13)), (2000, 4, 75, (0, 4)),
         (64, 200, 3, (0, 200)), (0, 5, 4, (0, 5)),
         (1500, 3, 1, (0, 3))]


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("E,S,d,span", CASES)
def test_plain_segment_reduce_matches_jax(E, S, d, span, op):
    rng = np.random.default_rng(E + S + d)
    index = rng.integers(span[0], span[1], E).astype(np.int32)
    shape = (E,) if d == 0 else (E, d)
    values = rng.standard_normal(shape).astype(np.float32)
    plan = ops.segment_plan(torch.from_numpy(index), S)
    got = ops.segment_reduce(torch.from_numpy(values), plan, op).numpy()
    _check(got, _jax(values, index, S, op), op)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_trash_node_redirect_matches_jax(op):
    """The models' masked edges: redirected to node n, reduced over n + 1
    segments, the trash row cut off. Node 0 keeps its real edges only."""
    rng = np.random.default_rng(5)
    n, m = 50, 600
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    mask = rng.random(m) < 0.7
    dst[~mask] = 0                         # padded edges point at node 0
    values = rng.standard_normal((m, 5)).astype(np.float32)
    index = np.where(mask, dst, n).astype(np.int32)
    plan = ops.segment_plan(torch.from_numpy(index), n + 1)
    got = ops.segment_reduce(torch.from_numpy(values), plan, op)[:n].numpy()
    _check(got, _jax(values, index, n + 1, op)[:n], op)
    real = values[mask & (dst == 0)]
    if op == "sum":
        np.testing.assert_allclose(got[0], real.sum(0), rtol=1e-6,
                                   atol=1e-6)


def test_empty_segments_give_the_identities():
    plan = ops.segment_plan(torch.tensor([1, 1, 3], dtype=torch.int32), 5)
    v = torch.tensor([[1.0], [2.0], [-4.0]])
    assert ops.segment_reduce(v, plan, "sum")[:, 0].tolist() == \
        [0.0, 3.0, 0.0, -4.0, 0.0]
    mx = ops.segment_reduce(v, plan, "max")[:, 0]
    mn = ops.segment_reduce(v, plan, "min")[:, 0]
    assert mx.tolist() == [-np.inf, 2.0, -np.inf, -4.0, -np.inf]
    assert mn.tolist() == [np.inf, 1.0, np.inf, -4.0, np.inf]
    for op, got in (("max", mx), ("min", mn)):
        want = _jax(v.numpy(), np.array([1, 1, 3], np.int32), 5, op)
        np.testing.assert_array_equal(got.numpy(), want[:, 0])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_segment_plan_order_offsets_and_pieces(dtype):
    """The plan's positions: order the stable argsort, keys the sorted
    index clamped to [-1, S], offsets its searchsorted bounds; the
    index kept for the backward (int32); the contiguous view shares keys
    and offsets and has no order and no index. The pieces
    of the kernels' fold are not the plan's: they are the run lengths and
    levels, from E and d alone, and every level covers its positions with
    whole runs until one run holds them all."""
    rng = np.random.default_rng(11)
    S, E = 12, 3000
    # a skewed index: segment 2 holds ~half the edges (many runs)
    index = np.where(rng.random(E) < 0.5, 2,
                     rng.integers(-3, S + 3, E)).astype(np.int64)
    plan = ops.segment_plan(torch.from_numpy(index).to(dtype), S)
    assert plan.order.dtype == plan.keys.dtype == plan.offsets.dtype == \
        torch.int32
    order = np.argsort(index, kind="stable")
    np.testing.assert_array_equal(plan.order.numpy(), order)
    np.testing.assert_array_equal(plan.keys.numpy(),
                                  np.clip(index[order], -1, S))
    np.testing.assert_array_equal(
        plan.offsets.numpy(), np.searchsorted(np.sort(index),
                                              np.arange(S + 1)))
    assert plan.num_segments == S and plan.num_positions == E
    np.testing.assert_array_equal(
        plan.counts.numpy(), np.bincount(index[(index >= 0) & (index < S)],
                                         minlength=S))
    # the index itself where it is int32, else clamped to [-1, S]
    np.testing.assert_array_equal(np.clip(plan.index.numpy(), -1, S),
                                  np.clip(index, -1, S))
    assert plan.index.dtype == torch.int32
    assert ops.segment_plan(torch.from_numpy(index).to(dtype), S,
                            keep_index=False).index is None
    flat = plan.contiguous()
    assert flat.order is None and flat.index is None and \
        flat.keys is plan.keys and flat.offsets is plan.offsets
    assert torch.equal(flat.rows(), torch.arange(E, dtype=torch.int32))
    assert torch.equal(plan.rows(), plan.order)
    for d in (1, 16, 47, 75, 128, 512):
        vec = segment_reduce.unit_width(d)
        group, per = segment_reduce.layout(d, vec)
        assert group * per * vec >= min(d, 128 * vec) and group <= 32
        assert segment_reduce.batch(per, vec) * per * vec <= 16
        R1, RL = segment_reduce.run_lengths(E, d, vec)
        assert R1 % segment_reduce.batch(per, vec) == 0
        assert RL % segment_reduce.batch(per, vec) == 0
        G = segment_reduce.THREADS // group
        lv = segment_reduce.levels(E, d)
        assert lv[0] == (E, R1) and all(R == RL for _, R in lv[1:])
        for (n, R), (m, _) in zip(lv, lv[1:]):
            assert m == 2 * -(-(-(-n // R)) // G)     # two slots a block
        n, R = lv[-1]
        assert -(-(-(-n // R)) // G) <= 1             # one block holds all


# (E, S, d, segment 1's share of the edges, outside): segments crossing
# run boundaries, one segment over many runs (several levels), empty
# segments, edges outside [0, S), and the odd widths 47 and 75
FOLD_CASES = [(700, 40, 4, 0.0, True), (3000, 64, 47, 0.6, True),
              (2500, 300, 75, 0.3, False), (1200, 5, 16, 0.9, True),
              (900, 600, 2, 0.0, True)]


def _fold_case(E, S, d, share, outside, seed):
    rng = np.random.default_rng(seed)
    index = rng.integers(0, max(S // 2, 1), E)
    index[rng.random(E) < share] = 1
    if outside:
        index[:6] = [-1, S, S + 3, -7, S - 1, 0]
    rng.shuffle(index)
    values = rng.standard_normal((E, d)).astype(np.float32)
    return values, index.astype(np.int32)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("E,S,d,share,outside", FOLD_CASES)
def test_pieces_fold_equals_the_plain_fold(E, S, d, share, outside, op):
    """The card's order (``segment_reduce.card_order_reduce``: runs,
    slots, phantoms and levels, each add in float32 as the kernel makes
    it) against the float64 plain version and ``jax.ops.segment_*``: max
    and min equal, the sum within deg 2^-24 sum|v| (any order of deg
    float32 adds), on both routes (the contiguous one over the values in
    plan order gives the same bits)."""
    values, index = _fold_case(E, S, d, share, outside, seed=E + d)
    plan = ops.segment_plan(torch.from_numpy(index), S)
    v = torch.from_numpy(values)
    R1, RL = segment_reduce.run_lengths(E, d, segment_reduce.unit_width(d))
    off = plan.offsets.long()
    live = off[1:] > off[:-1]
    crossing = (off[:-1] // R1 != (off[1:] - 1) // R1) & live
    assert bool(crossing.any())              # partials carried across runs
    assert share == 0 or int(plan.counts.max()) > 2 * R1   # several runs
    card = segment_reduce.card_order_reduce(v, plan.order, plan.keys, S, op)
    flat = segment_reduce.card_order_reduce(v[plan.order.long()], None,
                                            plan.keys, S, op)
    assert torch.equal(card, flat)
    want = ref.segment_reduce_ref(v.double(), plan.order, plan.offsets, op)
    if op == "sum":
        mag = ref.segment_reduce_ref(v.double().abs(), plan.order,
                                     plan.offsets, "sum")
        limit = plan.counts.double()[:, None] * 2.0**-24 * mag + 1e-30
        assert bool(((card.double() - want).abs() <= limit).all())
    else:
        assert torch.equal(card.double(), want)
    _check(card.numpy(), _jax(values, index, S, op), op)


def test_card_order_is_not_the_left_fold():
    """Where a segment crosses runs, the card's sum folds the runs'
    partials (in the block, then across blocks), not the edges left to
    right: the two orders differ in the last bits on a long segment of
    values of mixed magnitude."""
    rng = np.random.default_rng(4)
    E = 20000                            # three blocks: two levels
    index = np.zeros(E, np.int32)
    values = (rng.standard_normal((E, 1))
              * 10.0 ** rng.integers(-4, 4, (E, 1))).astype(np.float32)
    plan = ops.segment_plan(torch.from_numpy(index), 1)
    v = torch.from_numpy(values)
    card = segment_reduce.card_order_reduce(v, plan.order, plan.keys, 1,
                                            "sum")
    left = torch.zeros(1)
    for x in v[:, 0]:
        left = left + x
    assert len(segment_reduce.levels(E, 1)) >= 2
    assert not torch.equal(card[0], left)
    want = float(values.astype(np.float64).sum())
    assert abs(float(card[0]) - want) <= E * 2.0**-24 * float(
        np.abs(values).sum())


def test_cpu_tensor_goes_to_the_plain_version():
    segment_reduce.reset_launches()
    index = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    v = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    plan = ops.segment_plan(index, 3)
    got = ops.segment_reduce(v, plan, "sum")
    assert segment_reduce.LAUNCHES["segment_reduce"] == 0
    assert torch.equal(got, ref.segment_reduce_ref(v, plan.order,
                                                   plan.offsets, "sum"))
    assert got.tolist() == [[2.0, 3.0], [6.0, 7.0], [4.0, 6.0]]
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce.segment_reduce_cuda(v, plan.order, plan.keys,
                                           plan.offsets, "sum")
    assert torch.equal(ops.segment_reduce(v[plan.order.long()],
                                          plan.contiguous(), "sum"), got)


def test_plan_refuses_bad_arguments():
    with pytest.raises(ValueError):
        ops.segment_plan(torch.zeros(3), 2)
    with pytest.raises(ValueError):
        ops.segment_plan(torch.zeros(3, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        ref.segment_reduce_ref(torch.zeros(2),
                               torch.zeros(2, dtype=torch.int32),
                               torch.tensor([0, 2]), "mean")
