"""Edge-mutation record: seeded update batches that a write-ahead log can
carry.

The log is host bookkeeping with no device state: a sequence of
``EdgeBatch``es, each a set of directed ``add_edge``/``remove_edge``
pairs, with ``graph_version`` assigned monotonically at append time.
Batches round-trip through plain JSON dicts (``to_record``/``from_record``)
so that a log can record the stream and recovery can replay it bit for
bit.

Batch semantics are **set-transform**: applying a batch to edge set E gives
``E' = (E - removes) | adds`` (an add of a present edge and a remove of an
absent edge are no-ops; an edge both removed and added in one batch ends up
present). Self-loops are dropped at normalisation: ``Graph.from_edges``
owns the self-loop policy (dangling nodes only), and ``DynamicGraph``
re-derives those toggles as part of the residency diff. A copy of
``repro.dyn.mutation_log``; ``MutationLog.seeded`` keeps the live edge set
as a sorted array of pair keys, which draws the same batches as the JAX
package's set.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _as_pairs(pairs) -> np.ndarray:
    """Coerce an iterable of (u, v) to a (k, 2) int32 array."""
    arr = np.asarray(list(pairs) if not isinstance(pairs, np.ndarray)
                     else pairs, dtype=np.int32)
    if arr.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"edge pairs must be (k, 2), got {arr.shape}")
    return arr


@dataclass(frozen=True)
class EdgeBatch:
    """One atomic update batch; ``version`` is the graph version AFTER it."""

    adds: np.ndarray        # (k, 2) int32 directed (u, v) pairs
    removes: np.ndarray     # (r, 2) int32
    version: int

    @property
    def size(self) -> int:
        return int(self.adds.shape[0] + self.removes.shape[0])

    def to_record(self) -> dict:
        """JSON-able dict (the WAL payload shape, DESIGN.md §16)."""
        return {"adds": self.adds.tolist(), "removes": self.removes.tolist(),
                "version": int(self.version)}

    @staticmethod
    def from_record(rec: dict) -> "EdgeBatch":
        return EdgeBatch(adds=_as_pairs(rec.get("adds", [])),
                         removes=_as_pairs(rec.get("removes", [])),
                         version=int(rec["version"]))


class MutationLog:
    """Append-only batch log with monotone ``graph_version`` assignment."""

    def __init__(self, base_version: int = 0):
        self.base_version = int(base_version)
        self._batches: list[EdgeBatch] = []

    # -- core --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._batches)

    def __iter__(self):
        return iter(self._batches)

    def __getitem__(self, i: int) -> EdgeBatch:
        return self._batches[i]

    @property
    def version(self) -> int:
        """Graph version after every logged batch is applied."""
        return self.base_version + len(self._batches)

    def append(self, adds=(), removes=()) -> EdgeBatch:
        """Record one batch; assigns the next monotone graph version."""
        batch = EdgeBatch(adds=_as_pairs(adds), removes=_as_pairs(removes),
                          version=self.version + 1)
        self._batches.append(batch)
        return batch

    def record(self, batch: EdgeBatch) -> EdgeBatch:
        """Record an externally-built batch (e.g. replayed from a WAL);
        its version must be the next monotone one."""
        if batch.version != self.version + 1:
            raise ValueError(f"batch version {batch.version} does not "
                             f"follow log version {self.version}")
        self._batches.append(batch)
        return batch

    # -- (de)serialisation -------------------------------------------------
    def to_records(self) -> list[dict]:
        return [b.to_record() for b in self._batches]

    @staticmethod
    def from_records(records: list[dict],
                     base_version: int = 0) -> "MutationLog":
        log = MutationLog(base_version=base_version)
        for rec in records:
            batch = EdgeBatch.from_record(rec)
            if batch.version != log.version + 1:
                raise ValueError(
                    f"non-monotone graph_version {batch.version} after "
                    f"{log.version} — the mutation stream is corrupt")
            log._batches.append(batch)
        return log

    # -- seeded synthetic churn -------------------------------------------
    @classmethod
    def seeded(cls, graph, num_batches: int, *, seed: int = 0,
               batch_edges: int = 8, add_frac: float = 0.5,
               base_version: int = 0) -> "MutationLog":
        """Deterministic synthetic churn against ``graph``'s live edge set.

        Removes are sampled from the edges actually present (tracked across
        batches, so later removes see earlier adds) and adds from the
        complement, which keeps every batch *effective* — the property tests
        and the churn bench want real structural change, not no-ops.
        Self-loops are never proposed; the dangling-node toggles they would
        imply are ``DynamicGraph``'s job.
        """
        if num_batches < 0:
            raise ValueError("num_batches must be >= 0")
        rng = np.random.default_rng(seed)
        n = graph.n
        src = np.asarray(graph.edge_src, dtype=np.int64)
        dst = np.asarray(graph.edge_dst, dtype=np.int64)
        # the live set as ascending keys u * n + v: the order of the pairs
        live = np.unique((src * n + dst)[src != dst])
        log = cls(base_version=base_version)
        for _ in range(num_batches):
            n_add = int(rng.binomial(batch_edges, add_frac))
            n_rem = batch_edges - n_add
            adds, added = [], set()
            for _ in range(n_add):
                for _ in range(64):               # bounded rejection sample
                    u = int(rng.integers(0, n))
                    v = int(rng.integers(0, n))
                    key = u * n + v
                    at = int(np.searchsorted(live, key))
                    if u != v and key not in added and not (
                            at < live.size and live[at] == key):
                        adds.append((u, v))
                        added.add(key)
                        break
            if added:
                new = np.asarray(sorted(added), dtype=np.int64)
                live = np.insert(live, np.searchsorted(live, new), new)
            removes = []
            if live.size and n_rem:
                picks = rng.choice(live.size, size=min(n_rem, live.size),
                                   replace=False)
                picks = np.sort(picks)
                removes = [(int(k) // n, int(k) % n) for k in live[picks]]
                live = np.delete(live, picks)
            log.append(adds, removes)
        return log
