"""Plain PyTorch version of embedding_bag (the kernel's contract): the JAX
package's ``embedding_bag_ref``, gather then masked pool."""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import take_fill


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      mask: torch.Tensor | None = None,
                      mode: str = "sum") -> torch.Tensor:
    """table: [V, D]; indices: int32[B, L]; mask: bool[B, L] -> [B, D] in
    the table's dtype. The gather is ``jnp.take``'s: ids in ``[-V, -1]``
    wrap, ids outside ``[-V, V)`` read a NaN row, which ``sum`` and
    ``mean`` keep even where it is masked (they multiply by the mask)."""
    g = take_fill(table, indices.long())  # [B, L, D]
    if mask is None:
        mask = torch.ones(indices.shape, dtype=torch.bool,
                          device=indices.device)
    m = mask[..., None].to(table.dtype)
    if mode == "sum":
        return (g * m).sum(1)
    if mode == "mean":
        cnt = m.sum(1).clamp_min(1)
        return (g * m).sum(1) / cnt
    if mode == "max":
        neg = torch.finfo(table.dtype).min
        out = torch.where(mask[..., None], g, neg).amax(1)
        # empty bags pool to zero (torch.nn.EmbeddingBag convention)
        empty = ~mask.any(1)
        return torch.where(empty[:, None], 0.0, out).to(table.dtype)
    raise ValueError(mode)
