"""Deterministic synthetic data of the port (numpy, copied from
``src/repro/data``); ``pipeline.Prefetcher`` beside them.
``NeighborSampler`` waits for the GNN slice."""
from repro_torch.data.pipeline import (
    GraphBatches,
    SyntheticTokens,
    recsys_batches,
)

__all__ = ["SyntheticTokens", "GraphBatches", "recsys_batches"]
