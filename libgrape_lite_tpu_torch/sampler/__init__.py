"""GNN neighbour sampling over an append-only fragment (the reference's
`examples/gnn_sampler`)."""

from libgrape_lite_tpu_torch.sampler.append_only_fragment import (
    AppendOnlyEdgecutFragment,
)
from libgrape_lite_tpu_torch.sampler.sampler import GraphSampler

__all__ = ["AppendOnlyEdgecutFragment", "GraphSampler"]
