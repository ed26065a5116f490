"""The cells' graphs, made from the seed on the device the run uses.

A configuration names its generator (``"graph"``), a file
``generators/<name>.py`` whose ``make(config, g)`` draws a ``Graph`` from
the ``torch.Generator`` ``g`` in a few large calls on ``g``'s device.
``relabelings`` gives seeded vertex permutations: the one-shot cells
rotate over a few relabelled copies of their graph, so that no two
requests in a row hand the program the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cardbench.parts import BENCH_DIR, find, load_module


@dataclasses.dataclass
class Graph:
    """Edges as int32 tensors on the device; the blobs as ``(start,
    size)`` ranges of vertex ids (empty for a graph without them); the
    planted bridges as ``(min, max)`` pairs."""

    src: torch.Tensor
    dst: torch.Tensor
    n_nodes: int
    blobs: list
    bridges: set


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number:
    it is taken modulo 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make(config: dict, g: torch.Generator, roots=(BENCH_DIR,)) -> Graph:
    """The configuration's graph, by its generator's name."""
    return load_module(find("generators", config["graph"], roots)).make(
        config, g)


def relabelings(n: int, count: int, g: torch.Generator) -> list:
    """``count`` seeded permutations of ``range(n)`` (int64 on the
    device): vertex ``v`` of the drawn graph is ``perm[v]`` in a copy."""
    return [torch.randperm(n, generator=g, device=g.device)
            for _ in range(count)]


def relabel_pairs(pairs, perm: np.ndarray) -> set:
    """A set of ``(u, v)`` pairs under ``perm``, each as ``(min, max)``."""
    out = set()
    for u, v in pairs:
        a, b = int(perm[u]), int(perm[v])
        out.add((min(a, b), max(a, b)))
    return out
