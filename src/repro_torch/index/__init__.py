"""Walk index and result cache.

    WalkIndex     per-node budgeted table of pre-drawn walk endpoints —
                  FORA's walk phase as a gather (FORA+)
    ResultCache   (source, epsilon, graph_version)-keyed answer cache with
                  LRU eviction, TTL and per-key hit/cost accounting —
                  consulted before Lemma-1 admission so hits bypass the
                  core pool entirely (host only)
"""

from .result_cache import CacheStats, ResultCache
from .walk_index import WalkIndex, walk_rows

__all__ = ["CacheStats", "ResultCache", "WalkIndex", "walk_rows"]
