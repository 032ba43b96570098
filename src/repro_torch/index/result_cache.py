"""Result cache for repeated-query serving (DESIGN.md §11).

A serving system with millions of users sees heavily repeated sources; the
D&A arithmetic sizes core grants as if every arrival were fresh work. The
``ResultCache`` records answered queries under ``(source, epsilon,
graph_version)`` so the serving runtime can answer repeats WITHOUT
consulting the admission arithmetic or the core pool at all — a hit is the
cheapest possible grant: zero cores.

Key semantics:

* **source** — the query's source vertex (the unit of reuse; two jobs
  asking PPR from the same vertex at the same accuracy are the same work).
* **epsilon** — the accuracy the answer was computed at. A degraded answer
  (DCAF ladder raises epsilon) is cached under its own epsilon, so a
  full-accuracy request never silently receives a degraded answer.
* **graph_version** — the structure snapshot. An edge update bumps the
  version; stale entries simply stop matching and age out via LRU/TTL —
  no eager invalidation sweep is needed (DESIGN.md §11 staleness rules).

Eviction is LRU over a bounded entry count; ``ttl`` (in the runtime's
VIRTUAL time) expires entries that outlive their freshness window even when
capacity is plentiful. Per-key accounting keeps ``hits`` and the original
compute ``cost`` (core-seconds) per entry, so the runtime can report
core-seconds *saved* and the cost model can learn the observed hit rate
(:class:`repro_torch.core.estimator.CacheAwareCostModel`).

The cache is pure host-side bookkeeping (an OrderedDict) — deliberately so:
it sits on the admission path of a virtual-time event loop and must never
touch a device or a wall clock, which is also what keeps serving
simulations bit-replayable.

A copy of ``repro.index.result_cache`` (host only).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Hashable


@dataclass
class CacheStats:
    """Aggregate counters (monotone; deterministic under seeded drives)."""

    lookups: int = 0
    hits: int = 0
    insertions: int = 0
    evictions: int = 0
    expirations: int = 0
    saved_cost: float = 0.0      # sum of entry.cost over hits (core-seconds)

    @property
    def misses(self) -> int:
        return self.lookups - self.hits

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


@dataclass
class CacheEntry:
    """One cached answer and its per-key accounting."""

    value: Any                   # opaque payload (pi row handle, or None)
    cost: float                  # core-seconds the original compute took
    created: float               # virtual insertion time (drives TTL)
    hits: int = 0

    @property
    def saved(self) -> float:
        """Core-seconds this key has saved so far (hits x original cost)."""
        return self.hits * self.cost


class ResultCache:
    """LRU + TTL cache keyed by ``(source, epsilon, graph_version)``.

    ``capacity=0`` disables the cache (every lookup misses, puts are
    dropped) — the switch the cold-regression benchmark leg uses.
    """

    def __init__(self, capacity: int, ttl: float | None = None, *,
                 ttl_update_factor: float | None = None):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        if ttl is not None and ttl <= 0:
            raise ValueError("ttl must be > 0 (or None)")
        if ttl_update_factor is not None and ttl_update_factor <= 0:
            raise ValueError("ttl_update_factor must be > 0 (or None)")
        self.capacity = capacity
        self.ttl = ttl
        # TTL auto-tune (DESIGN.md §16): with a factor set, every observed
        # graph update retunes ttl = factor x EWMA inter-update gap — a fast-
        # churning graph shortens the freshness window, a quiet one relaxes
        # it, with no constant to hand-pick
        self.ttl_update_factor = ttl_update_factor
        self._last_update: float | None = None
        self._update_gap_ewma: float | None = None
        self._entries: OrderedDict[Hashable, CacheEntry] = OrderedDict()
        self.stats = CacheStats()

    # -- core --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    @staticmethod
    def make_key(source: int, epsilon: float | None,
                 graph_version: int) -> tuple:
        return (int(source), epsilon, int(graph_version))

    def get(self, key: Hashable, now: float = 0.0) -> CacheEntry | None:
        """Lookup with LRU touch; a TTL-expired entry is dropped and counts
        as a miss. ``now`` is the runtime's virtual clock."""
        self.stats.lookups += 1
        entry = self._entries.get(key)
        if entry is None:
            return None
        if self.ttl is not None and now - entry.created > self.ttl:
            del self._entries[key]
            self.stats.expirations += 1
            return None
        self._entries.move_to_end(key)
        entry.hits += 1
        self.stats.hits += 1
        self.stats.saved_cost += entry.cost
        return entry

    def peek(self, key: Hashable, now: float = 0.0) -> CacheEntry | None:
        """Inspect without touching recency, counters or evictions — same
        liveness answer :meth:`get` would give (TTL honoured), used for
        would-it-hit checks that must not commit accounting."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        if self.ttl is not None and now - entry.created > self.ttl:
            return None
        return entry

    def put(self, key: Hashable, value: Any = None, *, cost: float = 0.0,
            now: float = 0.0) -> None:
        """Insert/overwrite; evicts least-recently-used beyond capacity.

        Republishing an existing key (every completed slot re-puts its
        queries) refreshes value/cost/TTL but CARRIES the entry's
        accumulated hit count — hot sources are re-executed by many jobs,
        and zeroing their accounting on each republish would make
        ``top_keys`` undercount exactly the keys that earn the most.
        ``saved`` is then hits x the *latest* cost.
        """
        if self.capacity == 0:
            return
        prev = self._entries.pop(key, None)
        self._entries[key] = CacheEntry(value=value, cost=cost, created=now,
                                        hits=prev.hits if prev else 0)
        self.stats.insertions += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    # -- graph-update cadence (DESIGN.md §16) ------------------------------
    def note_update(self, now: float) -> None:
        """Observe a graph-update arrival at virtual time ``now``. Tracks an
        EWMA of the inter-update gap; with ``ttl_update_factor`` set, the
        TTL is retuned to ``factor x EWMA`` so entries outlive roughly that
        many update periods. Deterministic (pure arithmetic on the virtual
        clock) — safe on the WAL replay path."""
        if self._last_update is not None:
            gap = max(float(now) - self._last_update, 1e-9)
            self._update_gap_ewma = gap if self._update_gap_ewma is None \
                else 0.5 * self._update_gap_ewma + 0.5 * gap
            if self.ttl_update_factor is not None:
                self.ttl = self.ttl_update_factor * self._update_gap_ewma
        self._last_update = float(now)

    @property
    def update_cadence(self) -> float | None:
        """EWMA inter-update gap in virtual seconds (None before two
        updates have been observed)."""
        return self._update_gap_ewma

    def cadence_state(self) -> dict:
        """JSON-able cadence/TTL tuner state (snapshot leaf)."""
        return {"ttl": self.ttl, "last_update": self._last_update,
                "gap_ewma": self._update_gap_ewma}

    def load_cadence_state(self, state: dict) -> None:
        self.ttl = state.get("ttl")
        self._last_update = state.get("last_update")
        self._update_gap_ewma = state.get("gap_ewma")

    # -- reporting ---------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        return self.stats.hit_rate

    def source_heat(self) -> dict[int, float]:
        """Per-source heat: hits + saved core-seconds summed over that
        source's live entries (all epsilons/versions). The ranking signal
        ``WalkIndex.refresh_hottest`` consumes — saved-cost dominates for
        expensive sources, the hit count keeps cheap-but-hot sources above
        never-hit ones."""
        heat: dict[int, float] = {}
        for key, e in self._entries.items():
            src = key[0] if isinstance(key, tuple) and key else key
            heat[src] = heat.get(src, 0.0) + e.hits + e.saved
        return heat

    def top_keys(self, k: int = 10) -> list[tuple[Hashable, int, float]]:
        """The k hottest keys as (key, hits, core-seconds saved) — the
        operator-facing view of what the cache is earning."""
        rows = [(key, e.hits, e.saved) for key, e in self._entries.items()]
        rows.sort(key=lambda r: (-r[1], r[0]))
        return rows[:k]
