"""K5's route rule and launch geometry (``kernels/embedding_bag.py``),
plain Python that the CUDA kernels follow: the route for each ids row
stride, every (bag, item) taken by exactly one thread and every (bag,
column) written by exactly one, for several shapes and SM counts, enough
blocks for the card at DIN's shapes, and the row-load unit. The kernels
themselves are held to their plain version on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

from __future__ import annotations

from collections import Counter

import pytest
import torch

from repro_torch.kernels import embedding_bag, ops

H100_SMS = 132


@pytest.mark.parametrize("stride,want", [(0, "shared"), (1, "gather"),
                                         (100, "gather"), (7, "gather"),
                                         (-3, "gather")])
def test_route_follows_the_ids_row_stride(stride, want):
    assert embedding_bag.route(stride) == want
    assert embedding_bag.plan(64, 10, stride, H100_SMS).route == want


# (B, L, d, SMs): DIN's serve_p99 and retrieval block on an H100, odd and
# wide d, L = 1, L above a block's threads and above a staged pass, B below
# the SM count, a card with few SMs
SHAPES = [(512, 100, 18, H100_SMS), (8192, 100, 18, H100_SMS),
          (16, 5, 7, H100_SMS), (64, 100, 33, H100_SMS),
          (64, 100, 64, H100_SMS), (64, 1, 18, H100_SMS),
          (5, 100, 18, H100_SMS), (300, 7, 32, 4), (40, 600, 9, 2),
          (33, 257, 3, 1), (1, 40, 40, 8)]


@pytest.mark.parametrize("stride", [0, 1])
@pytest.mark.parametrize("B,L,d,sms", SHAPES)
def test_every_bag_item_and_column_is_taken_once(B, L, d, sms, stride):
    p = embedding_bag.plan(B, L, stride * L, sms)
    assert p.threads % 32 == 0 and 32 <= p.threads <= embedding_bag.THREADS
    assert p.blocks * p.bags_per_block >= B > (p.blocks - 1) \
        * p.bags_per_block
    if p.route == "gather":
        assert p.threads == p.bags_per_block * p.bag_warps * 32
    else:
        assert p.threads == embedding_bag.THREADS
        assert p.bags_per_block == p.threads // embedding_bag.SHARED_GROUP
    items: Counter = Counter()
    cols: Counter = Counter()
    for block in range(p.blocks):
        for thread in range(p.threads):
            taken = embedding_bag.items_of(p, block, thread, B, L)
            assert taken == sorted(taken)
            items.update(taken)
            cols.update(embedding_bag.columns_of(p, block, thread, B, d))
    assert items == Counter((b, l) for b in range(B) for l in range(L))
    assert cols == Counter((b, c) for b in range(B) for c in range(d))


@pytest.mark.parametrize("L", [1, 31, 32, 33, 100, 256, 1000])
def test_a_gather_bag_has_lanes_for_its_items(L):
    """Route G gives a bag one lane an item up to 8 warps, so no lane
    chains more than ceil(L / 256) reads."""
    p = embedding_bag.plan(512, L, L, H100_SMS)
    assert p.bag_warps == min(8, -(-L // 32))
    longest = max(len(embedding_bag.items_of(p, 0, t, 512, L))
                  for t in range(p.threads))
    assert longest == -(-L // 256)


@pytest.mark.parametrize("B,L,stride", [(512, 100, 100), (8192, 100, 0),
                                        (8192, 100, 100)])
def test_din_shapes_fill_the_card(B, L, stride):
    """DIN's serve_p99 (B = 512, own histories) and retrieval block (B =
    8,192, one history) get at least a block for each SM of an H100."""
    p = embedding_bag.plan(B, L, stride, H100_SMS)
    assert p.blocks >= H100_SMS
    assert p.blocks <= B


def test_small_batches_get_a_block_a_bag_on_route_g():
    """Below 2 blocks an SM route G gives each bag its own block; route S
    always gives a block 32 bags, a group of 8 lanes each."""
    g = embedding_bag.plan(5, 100, 100, H100_SMS)
    assert (g.blocks, g.bags_per_block) == (5, 1)
    s = embedding_bag.plan(5, 100, 0, H100_SMS)
    assert (s.blocks, s.bags_per_block) == (1, 32)
    assert embedding_bag.plan(8192, 100, 0, 4).blocks == 256


def test_row_load_unit_follows_d_and_alignment():
    base = torch.zeros(400)
    assert embedding_bag.unit_width(base.view(20, 20)) == 2
    assert embedding_bag.unit_width(base[:399].view(21, 19)) == 1  # odd d
    # a view 4 bytes past an 8-byte boundary loads one float at a time
    assert embedding_bag.unit_width(base[1:381].view(19, 20)) == 1
    # 72 bytes past the base: 8-byte but not 16-byte aligned
    assert embedding_bag.unit_width(base[18:378].view(20, 18)) == 2


def test_cpu_tensors_take_the_plain_version_on_both_routes():
    """ops.embedding_bag on CPU tensors launches nothing, whatever the ids'
    row stride."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn((50, 6), generator=g)
    ids = torch.randint(-50, 50, (4, 9), generator=g, dtype=torch.int32)
    w = torch.rand((4, 9), generator=g)
    embedding_bag.reset_launches()
    for bag_ids in (ids, ids[:1].expand(4, 9)):
        got = ops.embedding_bag(table, bag_ids, w)
        want = torch.einsum("bl,bld->bd", w.double(),
                            table.double()[bag_ids.long()])
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)
    assert set(embedding_bag.LAUNCHES.values()) == {0}
