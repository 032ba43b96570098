"""Walk index (FORA+): a per-node table of pre-drawn walk endpoints, so
that FORA's walk phase becomes a gather. The result cache of the JAX
package is host-only and serves the serving runtime; it is not ported
yet."""

from .walk_index import WalkIndex, walk_rows

__all__ = ["WalkIndex", "walk_rows"]
