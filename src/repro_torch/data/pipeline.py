"""Data pipelines: synthetic streams of the right shapes for the LM and
DIN families, a copy of ``repro/data/pipeline.py`` (numpy only: the port
keeps its own copy rather than import the JAX package).

No real corpora are in the repository, so the streams are seeded
generators: deterministic per seed, shard-aware (each data-parallel host
takes its own slice by ``shard``/``num_shards``), and double-buffered by
:class:`Prefetcher` on a background thread so that the host builds the
next batch while the card runs the step. A batch is a dict of numpy
arrays; the caller moves it to the device.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np

CLOSE_TIMEOUT_S = 10.0         # Prefetcher.close: the producer's time to stop


@dataclass
class TokenStream:
    """LM token pipeline: Zipf-distributed synthetic tokens with documents
    separated by EOS; labels = next-token shift. Sharded by host."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    eos_id: int = 1
    zipf_a: float = 1.2

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed * 1009 + self.shard)
        local_batch = max(1, self.batch // self.num_shards)
        while True:
            toks = rng.zipf(self.zipf_a, size=(local_batch, self.seq_len + 1))
            toks = np.minimum(toks, self.vocab - 1).astype(np.int32)
            # sprinkle EOS to fake document boundaries
            doc_ends = rng.random((local_batch, self.seq_len + 1)) < 0.002
            toks = np.where(doc_ends, self.eos_id, toks)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class RecsysStream:
    """DIN batches: user histories with popularity-skewed (Zipf 1.3) item
    ids, each item's category its id mod ``n_cats``, and a click label
    correlated with the history's overlap with the target's category (so
    that training has a signal to fit)."""

    n_items: int
    n_cats: int
    seq_len: int
    batch: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed * 2003 + self.shard)
        b = max(1, self.batch // self.num_shards)
        while True:
            hist_items = (rng.zipf(1.3, (b, self.seq_len)) % self.n_items
                          ).astype(np.int32)
            hist_cats = (hist_items % self.n_cats).astype(np.int32)
            lengths = rng.integers(1, self.seq_len + 1, size=b)
            mask = np.arange(self.seq_len)[None, :] < lengths[:, None]
            target_item = (rng.zipf(1.3, b) % self.n_items).astype(np.int32)
            target_cat = (target_item % self.n_cats).astype(np.int32)
            overlap = (hist_cats == target_cat[:, None]) & mask
            p_click = 0.1 + 0.8 * (overlap.sum(1) / np.maximum(lengths, 1))
            label = (rng.random(b) < p_click).astype(np.float32)
            yield {"hist_items": hist_items, "hist_cats": hist_cats,
                   "hist_mask": mask, "target_item": target_item,
                   "target_cat": target_cat, "label": label}


class Prefetcher:
    """Background-thread double buffering: ``next()`` returns a batch
    already built while the producer builds the next ones (``depth`` at
    most), in the iterator's order. :meth:`close` stops the producer,
    waits for its thread to end and ends the iteration."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._closed = False
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._it:
                if self._done.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer: it ends after the item it is building, and
        the queue is emptied so that a blocked put returns. Raises if its
        thread has not ended within :data:`CLOSE_TIMEOUT_S`."""
        self._done.set()
        waited = 0.0
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.01)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.01)
            waited += 0.02
            if waited > CLOSE_TIMEOUT_S:
                raise RuntimeError("the prefetch thread did not stop")
        self._closed = True
