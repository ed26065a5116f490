"""Shared tour/interval state of the device final stage
(``repro.connectivity.common``).

  1. F1 = spanning forest (Borůvka hooking), rest = non-tree edges.
  2. Euler tour of F1 -> per-vertex discovery positions; every subtree is a
     contiguous position interval.
  3. ntmin/ntmax[v] = min/max discovery position reachable from v via a
     non-tree edge (or disc[v] itself), scattered into tour-position space
     and closed under subtree range-reduce via one sparse table per extreme.

Per tree edge (child side) the range reduce yields smin/smax — the classic
``low``/``high`` values of the child subtree — and the bridge test.
"""
from __future__ import annotations

import torch

from repro_torch.core.euler import build_sparse_table, euler_tour, range_reduce
from repro_torch.core.forest import spanning_forest
from repro_torch.graph.datastructs import INF32, INT, INT32_MIN, EdgeList, take


def _segment_reduce(values, ids, n: int, reduce: str, identity: int):
    """``jax.ops.segment_min``/``segment_max``: empty segments hold the JAX
    identity (INF32 for min, INT32_MIN for max), and ids outside ``[0, n)``
    are dropped — sent to dump segment ``n`` before any indexing (on the
    card an out-of-range index is a device assert) and sliced off."""
    out = torch.full((n + 1,), identity, dtype=INT, device=values.device)
    inside = (ids >= 0) & (ids < n)
    out.scatter_reduce_(0, torch.where(inside, ids, n).long(), values,
                        reduce, include_self=True)
    return out[:n]


def _set_drop(size: int, fill: int, idx, values):
    """``full(size, fill).at[idx].set(values, mode="drop")``: an index in
    ``[-size, -1]`` wraps to ``size + idx`` as JAX's does, every index
    still outside ``[0, size)`` goes to dump slot ``size`` before any
    indexing and is sliced off."""
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.full((size + 1,), fill, dtype=INT, device=values.device)
    out[idx] = values
    return out[:size]


def tour_state(src, dst, mask, n: int) -> dict:
    """Rooted-forest tour state of the masked buffer (C slots, positions
    over P = 2C + 1):

      tree_mask bool[C]  spanning-forest slots
      nt_mask   bool[C]  non-tree (and non-self-loop) slots
      labels    int[n]   component representative per vertex
      is_root   bool[n]  tour root of its component (labels[v] == v)
      disc      int[n]   discovery position (INF32 for isolated vertices)
      vhi       int[n]   inclusive end of v's subtree position interval
      parent    int[C]   tree edge's parent endpoint (0 where ~tree_mask)
      child     int[C]   tree edge's child endpoint  (0 where ~tree_mask)
      lo, hi    int[C]   child subtree = positions (lo, hi]
      smin,smax int[C]   min/max non-tree reach of the child subtree
      bridge    bool[C]  tree edge whose child subtree no non-tree edge
                         escapes — the paper's bridge criterion
    """
    tree_mask, labels = spanning_forest(EdgeList(src, dst, mask, n))
    nt_mask = mask & ~tree_mask & (src != dst)

    tour = euler_tour(torch.where(tree_mask, src, 0),
                      torch.where(tree_mask, dst, 0), tree_mask, labels, n)
    gpos, disc = tour["gpos"], tour["disc"]

    # non-tree reach per vertex (include own discovery position)
    ep_v = torch.cat([torch.where(nt_mask, src, 0),
                      torch.where(nt_mask, dst, 0)])
    ep_w = torch.cat([torch.where(nt_mask, dst, 0),
                      torch.where(nt_mask, src, 0)])
    nt2 = torch.cat([nt_mask, nt_mask])
    ids = torch.where(nt2, ep_v, 0)
    disc_w = take(disc, ep_w)
    ntmin = _segment_reduce(torch.where(nt2, disc_w, INF32), ids, n, "amin",
                            INF32)
    ntmin = torch.minimum(ntmin, disc)
    ntmax = _segment_reduce(torch.where(nt2, disc_w, -1), ids, n, "amax",
                            INT32_MIN)
    ntmax = torch.maximum(ntmax, torch.where(disc == INF32, -1, disc))

    # scatter per-vertex values into tour-position space.
    # disc values run up to `total` (<= 2C), so allocate 2C+1 positions.
    P = gpos.shape[0] + 1
    pos_of_v = torch.where(disc == INF32, P, disc)  # drop isolated
    Tmin = build_sparse_table(_set_drop(P, INF32, pos_of_v, ntmin),
                              torch.minimum)
    Tmax = build_sparse_table(_set_drop(P, -1, pos_of_v, ntmax),
                              torch.maximum)

    # per tree-edge subtree interval: down-arc at lo, up-arc at hi
    # => subtree(child) = { w : lo < disc[w] <= hi }
    down = torch.minimum(gpos[0::2], gpos[1::2])
    up = torch.maximum(gpos[0::2], gpos[1::2])
    lo = torch.where(tree_mask, down, 0)
    hi = torch.where(tree_mask, up, 1)
    smin = range_reduce(Tmin, lo + 1, hi, torch.minimum)
    smax = range_reduce(Tmax, lo + 1, hi, torch.maximum)
    bridge = tree_mask & (smin > lo) & (smax <= hi)

    # rooted orientation: the earlier-discovered endpoint is the parent
    # (discovery positions are unique inside a component)
    src_first = take(disc, src) <= take(disc, dst)
    parent = torch.where(tree_mask, torch.where(src_first, src, dst), 0)
    child = torch.where(tree_mask, torch.where(src_first, dst, src), 0)

    # per-vertex subtree end: child vertices inherit their parent edge's up
    # position; roots span their whole component (max up over its tree edges)
    vs = torch.arange(n, dtype=INT, device=src.device)
    is_root = labels == vs
    vhi = _set_drop(n, -1, torch.where(tree_mask, child, n), hi)
    comp_end = _segment_reduce(torch.where(tree_mask, up, -1),
                               torch.where(tree_mask, take(labels, src), 0),
                               n, "amax", INT32_MIN)
    vhi = torch.where(is_root, take(comp_end, labels), vhi)

    return {
        "tree_mask": tree_mask,
        "nt_mask": nt_mask,
        "labels": labels,
        "is_root": is_root,
        "disc": disc,
        "vhi": vhi,
        "parent": parent,
        "child": child,
        "lo": lo,
        "hi": hi,
        "smin": smin,
        "smax": smax,
        "bridge": bridge,
    }
