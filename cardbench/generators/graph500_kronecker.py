"""The Graph 500 benchmark's Kronecker graph.

Follows the Octave reference code of the Graph 500 specification
(graph500.org, the Kronecker generator, ``kronecker_generator.m``) line for
line, with ids from 0 and the draws on the device:

    N = 2^SCALE;  M = edgefactor * N;
    [A, B, C] = deal (0.57, 0.19, 0.19);
    ij = ones (2, M);
    ab = A + B;  c_norm = C/(1 - (A + B));  a_norm = A/(A + B);
    for ib = 1:SCALE,
      ii_bit = rand (1, M) > ab;
      jj_bit = rand (1, M) > ( c_norm * ii_bit + a_norm * not (ii_bit) );
      ij = ij + 2^(ib-1) * [ii_bit; jj_bit];
    endfor
    p = randperm (N);  ij = p(ij);
    p = randperm (M);  ij = ij(:, p);
    ij = ij - 1;

Self-loops and duplicate edges are kept as drawn. The draws come from a
``torch.Generator`` on the device, so the numbers differ from Octave's,
not their law.
"""
from __future__ import annotations

import torch

from cardbench.graphs import Graph


def kronecker_edges(scale: int, edgefactor: int, initiator,
                    g: torch.Generator):
    """The loop over the bits: ``(i, j)`` int32 on ``g``'s device, before
    the vertex permutation and the edge shuffle."""
    dev = g.device
    a, b, c = (float(x) for x in initiator[:3])
    m = edgefactor << scale
    ab = a + b
    c_norm = c / (1 - ab)
    a_norm = a / ab
    i = torch.zeros(m, dtype=torch.int32, device=dev)
    j = torch.zeros(m, dtype=torch.int32, device=dev)
    for ib in range(scale):
        ii_bit = torch.rand(m, generator=g, device=dev) > ab
        jj_bit = torch.rand(m, generator=g, device=dev) > torch.where(
            ii_bit, c_norm, a_norm)
        i += ii_bit.int() << ib
        j += jj_bit.int() << ib
        del ii_bit, jj_bit
    return i, j


def kronecker_graph(scale: int, edgefactor: int, initiator,
                    g: torch.Generator) -> Graph:
    n = 1 << scale
    i, j = kronecker_edges(scale, edgefactor, initiator, g)
    p = torch.randperm(n, generator=g, device=g.device).int()
    i, j = p[i.long()], p[j.long()]
    q = torch.randperm(i.numel(), generator=g, device=g.device)
    return Graph(i[q], j[q], n, [], set())


def make(config: dict, g: torch.Generator) -> Graph:
    scale, edgefactor = config["scale"], config["edgefactor"]
    if (config["n_nodes"], config["n_edges"]) != (1 << scale,
                                                  edgefactor << scale):
        raise ValueError("n_nodes and n_edges must be 2^scale and "
                         "edgefactor x 2^scale")
    return kronecker_graph(scale, edgefactor, config["initiator"], g)
