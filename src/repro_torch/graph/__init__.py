from repro_torch.graph import generators
from repro_torch.graph.datastructs import (
    INF32,
    INT,
    ChunkedEdgeStream,
    EdgeList,
    admission_capacity,
    bucket_capacity,
    compact_edges,
    concat_edges,
    pad_edges,
    tombstone_mask,
)

__all__ = ["INF32", "INT", "ChunkedEdgeStream", "EdgeList",
           "admission_capacity", "bucket_capacity", "compact_edges",
           "concat_edges", "pad_edges", "tombstone_mask", "generators"]
