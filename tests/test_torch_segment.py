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
# values vector, a narrow and a wide row, and long segments (pieces)
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
    rng = np.random.default_rng(11)
    S, E = 12, 3000
    # a skewed index: segment 2 holds ~half the edges (several pieces)
    index = np.where(rng.random(E) < 0.5, 2,
                     rng.integers(-1, S + 1, E)).astype(np.int64)
    plan = ops.segment_plan(torch.from_numpy(index).to(dtype), S)
    assert plan.order.dtype == plan.offsets.dtype == torch.int32
    np.testing.assert_array_equal(plan.order.numpy(),
                                  np.argsort(index, kind="stable"))
    np.testing.assert_array_equal(
        plan.offsets.numpy(), np.searchsorted(np.sort(index),
                                              np.arange(S + 1)))
    assert plan.num_segments == S
    np.testing.assert_array_equal(
        plan.counts.numpy(), np.bincount(index[(index >= 0) & (index < S)],
                                         minlength=S))
    off = plan.offsets.numpy()
    pieces = plan.piece_offsets.numpy()
    bounds = plan.piece_bounds.numpy()
    P = bounds.shape[1]
    assert P == 2 * -(-E // segment_reduce.PIECE)
    assert pieces[-1] <= P
    for s in range(S):
        cnt = off[s + 1] - off[s]
        mine = range(pieces[s], pieces[s + 1])
        if cnt <= segment_reduce.PIECE:
            assert len(mine) == 0
            continue
        assert len(mine) == -(-cnt // segment_reduce.PIECE)
        spans = [(bounds[0, p], bounds[1, p]) for p in mine]
        assert spans[0][0] == off[s] and spans[-1][1] == off[s + 1]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(0 < e - b <= segment_reduce.PIECE for b, e in spans)
    # pieces past the last are empty
    assert (bounds[0, pieces[-1]:] == bounds[1, pieces[-1]:]).all()


def test_pieces_fold_equals_the_plain_fold():
    """The card's order for a long segment (its pieces' left folds, then
    those folded in piece order), written in torch, against the plain
    version: max and min equal, the sum within the float32 rounding of
    the two orders."""
    rng = np.random.default_rng(3)
    index = torch.from_numpy(rng.integers(0, 3, 1000).astype(np.int32))
    values = torch.from_numpy(rng.standard_normal((1000, 4)).astype(
        np.float32))
    plan = ops.segment_plan(index, 3)
    for op in ("sum", "max", "min"):
        plain = ops.segment_reduce(values, plan, op)
        parts = ref.segment_ranges_ref(values, plan.order,
                                       plan.piece_bounds[0],
                                       plan.piece_bounds[1], op)
        rows = []
        for s in range(3):
            p0, p1 = int(plan.piece_offsets[s]), int(plan.piece_offsets[s + 1])
            assert p1 - p0 > 1
            rows.append(ref.segment_reduce_ref(
                parts[p0:p1], torch.arange(p1 - p0, dtype=torch.int32),
                torch.tensor([0, p1 - p0], dtype=torch.int32), op)[0])
        card = torch.stack(rows)
        if op == "sum":
            torch.testing.assert_close(card, plain, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(card, plain)


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
        segment_reduce.segment_reduce_cuda(v, plan.order, plan.offsets,
                                           plan.piece_offsets,
                                           plan.piece_bounds, "sum")


def test_plan_refuses_bad_arguments():
    with pytest.raises(ValueError):
        ops.segment_plan(torch.zeros(3), 2)
    with pytest.raises(ValueError):
        ops.segment_plan(torch.zeros(3, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        ref.segment_reduce_ref(torch.zeros(2),
                               torch.zeros(2, dtype=torch.int32),
                               torch.tensor([0, 2]), "mean")
