"""The paper's dense graph with planted bridges.

Draws the distribution of the port's ``repro_torch/graph/generators.py::
planted_bridge_graph`` (frozen here, so that the yardstick does not move
when the port changes): ``n_bridges + 1`` blobs of ``n // k`` vertices
(the first ``n % k`` one more), each closed into one random Hamiltonian
cycle and filled with ``(m - n_bridges) // k`` uniform pairs (self-pairs
dropped), consecutive blobs joined by one planted bridge with uniform
endpoints, then one copy kept of every unordered pair (its first
occurrence) in order of the pair's key. The draws come from a
``torch.Generator`` on the device, so the numbers differ from numpy's,
not their law. Every blob is 2-vertex-connected (its cycle), so the
planted bridges are the graph's only bridges and their endpoints its only
cut vertices.
"""
from __future__ import annotations

import numpy as np
import torch

from cardbench.graphs import Graph


def _draw(g: torch.Generator, high: int, count: int) -> torch.Tensor:
    """``count`` uniform int64 draws in ``[0, high)``."""
    return torch.randint(0, high, (count,), generator=g, device=g.device)


def planted_bridge_graph(n: int, m: int, n_bridges: int,
                         g: torch.Generator) -> Graph:
    dev = g.device
    k = n_bridges + 1
    sizes = [n // k + (1 if b < n % k else 0) for b in range(k)]
    starts = [int(s) for s in np.concatenate([[0], np.cumsum(sizes)[:-1]])]
    mb = max(m - n_bridges, 0) // k
    srcs, dsts = [], []
    for nb, s0 in zip(sizes, starts):
        if nb < 2:
            continue
        cycle = torch.randperm(nb, generator=g, device=dev) + s0
        srcs += [cycle[:-1], cycle[-1:]]
        dsts += [cycle[1:], cycle[:1]]
        if nb >= 3 and mb > 0:
            u = _draw(g, nb, mb) + s0
            v = _draw(g, nb, mb) + s0
            keep = u != v
            srcs.append(u[keep])
            dsts.append(v[keep])
    bridges = set()
    for b in range(k - 1):
        u = starts[b] + int(_draw(g, sizes[b], 1))
        v = starts[b + 1] + int(_draw(g, sizes[b + 1], 1))
        srcs.append(torch.tensor([u], device=dev))
        dsts.append(torch.tensor([v], device=dev))
        bridges.add((min(u, v), max(u, v)))
    src = torch.cat(srcs).long()
    dst = torch.cat(dsts).long()
    key = torch.minimum(src, dst) * n + torch.maximum(src, dst)
    order = torch.sort(key, stable=True).indices
    key = key[order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    keep = order[first]
    return Graph(src[keep].int(), dst[keep].int(), n,
                 list(zip(starts, sizes)), bridges)


def make(config: dict, g: torch.Generator) -> Graph:
    return planted_bridge_graph(config["n_nodes"], config["n_edges"],
                                config["n_bridges"], g)
