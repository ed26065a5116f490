"""Plain PyTorch version of segment_min (the kernel's contract)."""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import INF32, INT


def segment_min_ref(keys: torch.Tensor, ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """min of int32 ``keys`` grouped by ``ids``; empty segments get INF32.
    Ids outside ``[0, num_segments)`` are dropped, as ``jax.ops.segment_min``
    drops them: they go to a dump slot that is sliced off."""
    out = torch.full((num_segments + 1,), INF32, dtype=INT, device=keys.device)
    inside = (ids >= 0) & (ids < num_segments)
    idx = torch.where(inside, ids, num_segments).long()
    out.scatter_reduce_(0, idx, keys.to(INT), "amin", include_self=True)
    return out[:num_segments]
