"""Parallel Euler tour machinery on torch tensors (``repro.core.euler``).

  tree edges -> directed arcs -> circular adjacency successor -> Euler circuit
  -> cut at per-component roots -> Wyllie pointer-doubling list ranking
  -> discovery positions -> subtree = contiguous interval.

O(A log A) work with A = 2 * tree_capacity arcs. Every output matches the
JAX package bit for bit: the lexicographic sort is two stable sorts, the
successor's modulus is a floor modulus, and scatters that JAX drops out of
range go to a dump slot here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.graph.datastructs import INF32, INT, take
from repro_torch.kernels.segment_min.ops import segment_min


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def euler_tour(tsrc, tdst, tmask, labels, n: int) -> dict:
    """Euler-tour positions for a rooted spanning forest.

    Args:
      tsrc, tdst, tmask: tree edge buffer [C] (must be a forest).
      labels: [n] component representative per vertex (roots: labels[v]==v).
      n: vertex count.

    Returns dict with:
      gpos:  [2C] global tour position per arc (arc 2i = src->dst of slot i,
             arc 2i+1 = reverse). Invalid arcs get INF32.
      disc:  [n] global discovery position per vertex (INF32 for isolated).
      total: [] total number of arc positions (== 2 * #tree edges).
    """
    dev = tsrc.device
    A = 2 * tsrc.shape[0]
    arc_src = torch.stack([tsrc, tdst], dim=1).reshape(A)
    arc_dst = torch.stack([tdst, tsrc], dim=1).reshape(A)
    amask = tmask.repeat_interleave(2)
    # masked arcs sort last
    s_key = torch.where(amask, arc_src, n)
    d_key = torch.where(amask, arc_dst, n)
    # jnp.lexsort((d_key, s_key)): by src, then dst, then slot (stable)
    by_dst = torch.sort(d_key, stable=True).indices
    order = by_dst[torch.sort(s_key[by_dst], stable=True).indices].to(INT)
    arange_a = torch.arange(A, dtype=INT, device=dev)
    rank = torch.empty(A, dtype=INT, device=dev)
    rank[order] = arange_a

    sorted_src = s_key[order]
    vs = torch.arange(n, dtype=INT, device=dev)
    start = torch.searchsorted(sorted_src, vs, side="left", out_int32=True)
    end = torch.searchsorted(sorted_src, vs, side="right", out_int32=True)
    deg = end - start

    # successor in the Euler circuit: next(a=(u->v)) = next arc out of v after (v->u)
    rev = arange_a ^ 1
    v = arc_dst
    start_v = take(start, v)
    vd = take(deg, v).clamp_min(1)
    r = rank[rev]
    nxt_pos = start_v + torch.remainder(r - start_v + 1, vd)
    SENT = A
    nxt = torch.where(amask, take(order, nxt_pos), SENT)

    # cut each component's circuit at its root's first outgoing arc
    is_root = (labels == vs) & (deg > 0)
    head_arc = take(order, start)  # first arc out of each vertex
    # only False reaches dump slot A; values on the device, not Python
    # scalars, spare a copy to the card and its host sync
    is_head = torch.zeros(A + 1, dtype=torch.bool, device=dev)
    is_head[torch.where(is_root, head_arc, A)] = is_root
    nxt = torch.where(is_head[nxt], SENT, nxt)

    # Wyllie list ranking: dist[a] = #arcs after a in its list (0 at A)
    nx = torch.cat([nxt, torch.full((1,), SENT, dtype=INT, device=dev)])
    dist = (nx != SENT).to(INT)
    for _ in range(_ceil_log2(A) + 1):
        dist = dist + dist[nx]
        nx = nx[nx]
    dist = dist[:A]

    comp = take(labels, arc_src)  # component (root id) of each arc
    # list length per component root (slot n is the dump slot)
    L = torch.zeros(n + 1, dtype=INT, device=dev)
    L[torch.where(is_root, vs, n)] = torch.where(
        is_root, take(dist, head_arc) + 1, 0)
    L = L[:n]
    offset = torch.cat([torch.zeros(1, dtype=INT, device=dev),
                        torch.cumsum(L, 0, dtype=INT)[:-1]])
    tourpos = take(L, comp) - 1 - dist
    gpos = torch.where(amask, tourpos + take(offset, comp), INF32)

    # discovery: an arc at tour position p *enters* its head at time p+1,
    # so disc[v] = 1 + min entering-arc position. Roots are discovered at the
    # position of their first outgoing arc (their component offset).
    disc = segment_min(torch.where(amask, gpos, INF32),
                       torch.where(amask, arc_dst, 0), n)
    disc = torch.where(disc < INF32, disc + 1, disc)
    disc = torch.where(is_root, offset, disc)
    disc = torch.where(deg > 0, disc, INF32)  # isolated vertices
    total = L.sum(dtype=INT)
    return {"gpos": gpos, "disc": disc, "total": total}


def build_sparse_table(values: torch.Tensor, reduce_fn) -> torch.Tensor:
    """[K, P] sparse table for range reduce; fixed K = ceil_log2(P)+1 levels."""
    P = values.shape[0]
    K = _ceil_log2(P) + 1
    rows = [values]
    cur = values
    ar = torch.arange(P, device=values.device)
    for k in range(1, K):
        shifted_idx = (ar + (1 << (k - 1))).clamp_max(P - 1)
        cur = reduce_fn(cur, cur[shifted_idx])
        rows.append(cur)
    return torch.stack(rows)  # [K, P]


def _floor_log2(x: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Exact integer floor(log2(x)) for x >= 1, via power comparisons."""
    bits = torch.arange(max_bits, dtype=INT, device=x.device)
    pows = torch.ones_like(bits) << bits  # int32, wraps like jnp's shift
    return (x[..., None] >= pows).sum(-1, dtype=INT) - 1


def range_reduce(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 reduce_fn) -> torch.Tensor:
    """Reduce values over inclusive position range [lo, hi] per query."""
    K, P = table.shape
    length = (hi - lo + 1).clamp_min(1)
    k = _floor_log2(length, K).clamp(0, K - 1)
    left = table[k, lo.clamp(0, P - 1)]
    right = table[k, (hi - (torch.ones_like(k) << k) + 1).clamp(0, P - 1)]
    return reduce_fn(left, right)
