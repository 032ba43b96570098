"""The port's data pipeline (``repro_torch.data.pipeline``) against the
JAX package's ``repro.data.pipeline``: ``TokenStream`` and
``RecsysStream`` batches array-equal for several seeds and shards (a
seeded numpy generator in both), and the ``Prefetcher``'s order, its end
and its close."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 2),
                                                   (7, 3, 4)])
def test_token_stream_equals_jax(seed, shard, num_shards):
    kw = dict(vocab=500, seq_len=33, batch=8, seed=seed, shard=shard,
              num_shards=num_shards)
    for a, b in zip(itertools.islice(iter(tpipe.TokenStream(**kw)), 3),
                    itertools.islice(iter(jpipe.TokenStream(**kw)), 3)):
        _equal(a, b)
        assert a["tokens"].shape == (max(1, 8 // num_shards), 33)
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (5, 0, 2),
                                                   (5, 1, 2), (9, 2, 3)])
def test_recsys_stream_equals_jax(seed, shard, num_shards):
    kw = dict(n_items=10_000, n_cats=100, seq_len=20, batch=12, seed=seed,
              shard=shard, num_shards=num_shards)
    for a, b in zip(itertools.islice(iter(tpipe.RecsysStream(**kw)), 3),
                    itertools.islice(iter(jpipe.RecsysStream(**kw)), 3)):
        _equal(a, b)
        assert (a["hist_cats"] == a["hist_items"] % 100).all()
        assert a["hist_mask"][:, 0].all()


def test_prefetcher_keeps_the_order_and_ends():
    got = list(tpipe.Prefetcher(iter(range(50)), depth=3))
    assert got == list(range(50))


def test_prefetcher_close_stops_an_endless_producer():
    stream = iter(tpipe.RecsysStream(n_items=100, n_cats=10, seq_len=5,
                                     batch=4))
    want = list(itertools.islice(iter(tpipe.RecsysStream(
        n_items=100, n_cats=10, seq_len=5, batch=4)), 3))
    pf = tpipe.Prefetcher(stream, depth=2)
    for w in want:
        _equal(next(pf), w)
    pf.close()                       # raises if the producer did not stop
    with pytest.raises(StopIteration):
        next(pf)
