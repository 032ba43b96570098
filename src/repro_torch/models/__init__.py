"""Model workloads of the port: the decoder LM and DIN for serving, the
GNNs forward.

Ported so far: ``common`` (norms, RoPE, attention plain versions,
activations, MLP), ``moe`` (the mixture-of-experts feed-forward, gather
dispatch), ``transformer`` (dense or MoE FFN; prefill and decode through
K6), ``recsys.din`` (``score`` and ``score_candidates`` through K5) and
``gnn`` (GCN, PNA, GraphCast, DimeNet: ``apply`` and the loss value, the
aggregations through ``ops.segment_reduce``). Each model's
``params_from_numpy`` carries the JAX package's parameters across.
Training comes in a later slice.
"""

from . import common, gnn, moe, recsys, transformer
from .gnn import dimenet, gcn, graphcast, pna
from .recsys import din

__all__ = ["common", "dimenet", "din", "gcn", "gnn", "graphcast", "moe",
           "pna", "recsys", "transformer"]
