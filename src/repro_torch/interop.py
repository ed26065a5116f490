"""Edge buffers across the package boundary, as numpy arrays.

The JAX package and the port share no tensors; a test hands a JAX buffer
across as numpy arrays so that both packages compute on identical input.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.datastructs import EdgeList, resolve_device


def edgelist_from_numpy(src, dst, mask, n_nodes: int, device=None) -> EdgeList:
    """An ``EdgeList`` on ``device`` (the card unless named) holding the
    given int32 endpoints and bool mask."""
    dev = resolve_device(device)
    src = torch.tensor(np.asarray(src, np.int32), device=dev)
    dst = torch.tensor(np.asarray(dst, np.int32), device=dev)
    mask = torch.tensor(np.asarray(mask, np.bool_), device=dev)
    if not src.shape == dst.shape == mask.shape:
        raise ValueError(f"src, dst, mask shapes differ: {tuple(src.shape)}, "
                         f"{tuple(dst.shape)}, {tuple(mask.shape)}")
    return EdgeList(src, dst, mask, int(n_nodes))


def edgelist_to_numpy(el: EdgeList):
    """Host copies ``(src, dst, mask)`` of the whole buffer, padding included."""
    return el.src.cpu().numpy(), el.dst.cpu().numpy(), el.mask.cpu().numpy()
