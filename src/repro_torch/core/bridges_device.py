"""The device final stage's historical entry points
(``repro.core.bridges_device``): thin wrappers over
``connectivity/device.py``, where the tour/interval machinery lives.

Imports are deferred to call time: ``connectivity`` builds on
``core.forest``/``core.euler``, so a module-level import here would make an
import cycle between the two packages.
"""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import EdgeList


def bridges_device(edges: EdgeList,
                   out_capacity: int | None = None) -> EdgeList:
    """Bridges of the (certificate) graph, compacted into an (n-1)-slot
    buffer."""
    from repro_torch.connectivity.device import bridges

    return bridges(edges, out_capacity)


def bridge_mask_device(edges: EdgeList) -> torch.Tensor:
    """bool[E] bridge indicator over the input buffer slots."""
    from repro_torch.connectivity.device import bridge_mask

    return bridge_mask(edges)
