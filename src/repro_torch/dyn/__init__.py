"""Dynamic graphs: streaming edge updates applied on the device, and
compaction equal to a fresh build.

``MutationLog`` is the record: seeded batches of ``add_edge`` and
``remove_edge`` pairs with monotone ``graph_version``s, as JSON records.
``DynamicGraph`` applies those batches where a sliced residency lives
(delta virtual rows, cleared cells, a re-sorted walk view; the tables are
never uploaded again between compactions), and ``compact()`` rebuilds the
residency exactly as a fresh build at the same version would.
"""

from .dynamic_graph import ApplyInfo, DynamicGraph
from .mutation_log import EdgeBatch, MutationLog

__all__ = ["ApplyInfo", "DynamicGraph", "EdgeBatch", "MutationLog"]
