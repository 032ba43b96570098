"""Input pipelines of the port: the GNNs' neighbour sampler (host numpy)."""

from .neighbor_sampler import (SampledSubgraph, minibatch_stream,
                               sample_subgraph)

__all__ = ["SampledSubgraph", "minibatch_stream", "sample_subgraph"]
