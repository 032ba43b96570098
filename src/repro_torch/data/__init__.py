"""Input pipelines of the port: the GNNs' neighbour sampler and the LM and
DIN training streams (host numpy)."""

from .neighbor_sampler import (SampledSubgraph, minibatch_stream,
                               sample_subgraph)
from .pipeline import Prefetcher, RecsysStream, TokenStream

__all__ = ["Prefetcher", "RecsysStream", "SampledSubgraph", "TokenStream",
           "minibatch_stream", "sample_subgraph"]
