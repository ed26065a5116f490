"""Deterministic synthetic data of the port (numpy, copied from
``src/repro/data``); ``pipeline.Prefetcher`` beside them, and
``sampler.NeighborSampler``, GraphSAGE's fan-out sampler."""
from repro_torch.data.pipeline import (
    GraphBatches,
    SyntheticTokens,
    recsys_batches,
)
from repro_torch.data.sampler import NeighborSampler

__all__ = ["SyntheticTokens", "GraphBatches", "recsys_batches",
           "NeighborSampler"]
