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


def frontier_round_ref(src, dst, mask, frontier, visited, num_segments: int):
    """One scan-first-search (BFS-layer) hooking round.

    src, dst: int32[E]; mask: bool[E]; frontier, visited: bool[n].
    Returns ``(best_p, best_e)`` int32[num_segments]: for each newly
    reachable vertex w (unvisited, adjacent to the frontier), ``best_p[w]``
    is its minimum-id frontier neighbour and ``best_e[w]`` the minimum edge
    slot connecting w to that neighbour (ties on parallel edges); both
    INF32 where w is not newly reached. Arc ids w outside
    ``[0, num_segments)`` are dropped.
    """
    e = src.shape[0]
    eidx = torch.arange(e, dtype=INT, device=src.device)
    valid = mask & (src != dst)
    us = torch.cat([src, dst])
    ws = torch.cat([dst, src])
    e2 = torch.cat([eidx, eidx])
    v2 = torch.cat([valid, valid])
    cand = v2 & take(frontier, us) & ~take(visited, ws)
    best_p = segment_min_ref(torch.where(cand, us, INF32),
                             torch.where(cand, ws, 0), num_segments)
    sel = cand & (us == take(best_p, ws))
    best_e = segment_min_ref(torch.where(sel, e2, INF32),
                             torch.where(sel, ws, 0), num_segments)
    return best_p, best_e
