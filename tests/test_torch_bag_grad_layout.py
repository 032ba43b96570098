"""The geometry of K5's backward (``csrc/embedding_bag_grad.cu``), plain
Python that the CUDA kernels follow: the zero fill of the table gradient
writes each word of a row no id names exactly once and no word of a named
row; level 1 stages the runs that are a warp's, and walks a run's
positions in the order ``segment_reduce.card_order_reduce`` folds them
(left to right), each from the shared-memory row of the lane that staged
it; and the weights' gradient takes a lane an item up to
``GRAD_LANE_WORDS`` words a row, a group of lanes beyond. The kernels are
held to their plain version on a card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

from __future__ import annotations

from collections import Counter

import pytest

from repro_torch.kernels import embedding_bag
from repro_torch.kernels.segment_reduce import THREADS, geometry, levels

S = 1100                       # a whole fill tile and part of a second


def _counts(pattern: str) -> list[int]:
    if pattern == "even":
        return [1 - r % 2 for r in range(S)]
    if pattern == "none":
        return [0] * S
    if pattern == "one":
        return [5 if r == S // 2 else 0 for r in range(S)]
    if pattern == "long":                   # a few rows of many positions
        return [40 if r % 7 == 3 else r % 3 // 2 for r in range(S)]
    return [(r * 7919) % 5 // 3 for r in range(S)]      # scattered runs


@pytest.mark.parametrize("pattern", ["even", "none", "one", "long",
                                     "mixed"])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 16, 18, 31])
def test_fill_writes_each_unnamed_word_once(d, pattern):
    """Two fill blocks, a tile each: each word of an empty row once, no
    word of a named row."""
    counts = _counts(pattern)
    written = Counter()
    for block in range(2):
        for thread in range(THREADS):
            words = embedding_bag.fill_words(counts, d, block, 2, thread)
            assert words == sorted(words)
            written.update(words)
    assert written == Counter(w for w in range(S * d) if counts[w // d] == 0)


@pytest.mark.parametrize("d", list(range(1, 40)))
def test_level_1_stages_the_runs_of_a_warp(d):
    want = 17 <= d <= 31 and d % 4 != 0
    assert embedding_bag.staged(d) == want
    if want:
        vec, group, per, *_ = geometry(6400, d)
        assert (vec, group, per) == (1, 32, 1)


# (E, d): DIN's item shape cut in E, a row of 31 and of 17 words, one short
# run, and DIN's whole batch and one above 8.4 M positions (runs of 64: two
# rounds a run), a few runs each
STAGED = [(6400, 18, None), (999, 31, None), (70, 17, None),
          (6_553_600, 18, (0, 1, 9_999, 204_799)),
          (9_000_000, 18, (0, 1, 140_624))]


@pytest.mark.parametrize("E,d,runs", STAGED)
def test_staged_level_1_walks_each_run_in_plan_order(E, d, runs):
    """The positions a staged run walks are its positions left to right,
    the order in which ``segment_reduce.card_order_reduce`` folds a run,
    each from the row of the lane that staged it, a lane a row."""
    _, group, _, R1, _, _, _ = geometry(E, d)
    n, R = levels(E, d)[0]
    assert (n, R, group) == (E, R1, 32)
    for run in range(-(-E // R1)) if runs is None else runs:
        reads = embedding_bag.staged_reads(E, d, run)
        a = run * R1
        assert [p for p, _ in reads] == list(range(a, min(a + R1, E)))
        first = run % (THREADS // 32) * 32
        rows = [row for _, row in reads]
        assert rows[:32] == list(range(first, first + len(rows[:32])))
        for k in range(0, len(reads), 32):
            assert rows[k:k + 32] == rows[:len(rows[k:k + 32])]


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("d", [1, 5, 18, 31, 32, 33, 40, 64, 100, 128, 255,
                               256])
def test_weights_route_follows_the_row_width(d, width):
    if d % width:
        return
    units = d // width
    if units > 32 * embedding_bag.GRAD_UNITS_A_LANE:
        with pytest.raises(ValueError, match="too wide"):
            embedding_bag.grad_group(d, width)
        return
    group = embedding_bag.grad_group(d, width)
    if d <= embedding_bag.GRAD_LANE_WORDS:
        assert group == 1
        return
    assert 2 <= group <= 32 and group & (group - 1) == 0
    assert units <= embedding_bag.GRAD_UNITS_A_LANE * group
    assert group == 2 or units > embedding_bag.GRAD_UNITS_A_LANE * group // 2


def test_weights_route_refuses_rows_too_wide():
    too_wide = 32 * embedding_bag.GRAD_UNITS_A_LANE * 2 + 2
    assert embedding_bag.grad_group(too_wide - 2, 2) == 32
    with pytest.raises(ValueError, match="too wide"):
        embedding_bag.grad_group(too_wide, 2)
