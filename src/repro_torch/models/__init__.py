"""Model workloads of the port: the decoder LM and DIN, for serving.

Ported so far: ``common`` (norms, RoPE, attention plain versions,
activations, MLP), ``moe`` (the mixture-of-experts feed-forward, gather
dispatch), ``transformer`` (dense or MoE FFN; prefill and decode through
K6) and ``recsys.din`` (``score`` and ``score_candidates`` through K5).
Each model's ``params_from_numpy`` carries the JAX package's parameters
across. The GNNs and training come in later slices.
"""

from . import common, moe, recsys, transformer
from .recsys import din

__all__ = ["common", "din", "moe", "recsys", "transformer"]
