"""Plain PyTorch version of the Borůvka hooking round (the kernel's
contract), op for op the JAX package's ``boruvka_round_ref``."""
from __future__ import annotations

import torch

from repro_torch.graph.datastructs import INF32, INT, take
from repro_torch.kernels.segment_min.ref import segment_min_ref


def boruvka_round_ref(src, dst, mask, labels, num_segments: int):
    """Per-component minimum cross-edge slot, both endpoints at once.

    src, dst: int32[E]; mask: bool[E]; labels: int32[n].
    Returns int32[num_segments]: for each component label, the minimum edge
    index whose endpoints live in different components and at least one of
    them in this component (INF32 where no such edge exists).
    """
    eidx = torch.arange(src.shape[0], dtype=INT, device=src.device)
    lu = take(labels, src)
    lv = take(labels, dst)
    cross = mask & (src != dst) & (lu != lv)
    key = torch.where(cross, eidx, INF32)
    best_u = segment_min_ref(key, lu, num_segments)
    best_v = segment_min_ref(key, lv, num_segments)
    return torch.minimum(best_u, best_v)
