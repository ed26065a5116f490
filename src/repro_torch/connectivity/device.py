"""Device (PRAM) bridge analysis on the shared tour state
(``repro.connectivity.device``, bridges only): a tree edge is a bridge when
no non-tree edge escapes its child subtree."""
from __future__ import annotations

import torch

from repro_torch.connectivity.common import tour_state
from repro_torch.graph.datastructs import EdgeList, compact_edges


def bridge_mask(edges: EdgeList) -> torch.Tensor:
    """bool[E] bridge indicator over the input buffer slots."""
    return tour_state(edges.src, edges.dst, edges.mask, edges.n_nodes)["bridge"]


def bridges(edges: EdgeList, out_capacity: int | None = None) -> EdgeList:
    """Bridges of the (certificate) graph, compacted into an (n-1)-slot buffer."""
    bm = bridge_mask(edges)
    cap = out_capacity if out_capacity is not None else max(edges.n_nodes - 1, 1)
    return compact_edges(edges, cap, keep=bm)
