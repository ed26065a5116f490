"""Plain reference for the 2-edge-connected components of an undirected
multigraph: every vertex labelled with the smallest vertex id of its
component once every bridge is cut.

1. ``connectivity.simple_graph``: self-loops dropped, each unordered pair
   once with its multiplicity.
2. The bridges: Tarjan's depth-first search (``connectivity.tarjan``) on
   the Cheriyan–Kao–Thurimella certificate (``connectivity.certificate``),
   which has the graph's bridges; a pair of two copies or more is never
   one.
3. The simple graph less its bridges, and its components by min-label
   propagation (``connectivity.components``): the smallest id of each
   vertex's component. An isolated vertex labels itself.

Steps 1 and 3 and the certificate are plain torch on whatever device the
arrays are given on; the search is Python on the host.
"""
from __future__ import annotations

import torch

from cardbench.reference.connectivity import (certificate, components,
                                              simple_graph, tarjan)


def analyze(src, dst, n: int, device="cpu") -> dict:
    """The 2-edge-connected labels (int64 numpy, one per vertex of
    ``range(n)``) of the multigraph ``(src[i], dst[i])``, and the edge
    count of a spanning forest of it (``n`` less its number of
    components)."""
    u, v, mult = simple_graph(src, dst, n, device)
    keep, forest_edges = certificate(u, v, n)
    cu, cv = (x[keep].cpu().numpy() for x in (u, v))
    bridge_ids, _ = tarjan(n, cu, cv)
    bridge_ids = torch.as_tensor(bridge_ids, dtype=torch.int64,
                                 device=u.device)
    bridges = keep[bridge_ids]
    bridges = bridges[mult[bridges] == 1]
    live = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    live[bridges] = False
    u, v = u[live], v[live]
    del mult, live, keep
    labels = components(torch.cat([u, v]), torch.cat([v, u]), n)
    return {"labels": labels.cpu().numpy(), "forest_edges": forest_edges}
