"""Comparison baseline (paper §VI / Fig 5): Savage & Ja'Ja' style
dense-matrix PRAM bridge algorithm (``repro.core.baseline_savage_jaja``).

The original runs in O(log² n) time on O(n²)-ish CREW processors using
adjacency-matrix connectivity. The port keeps the reference's *work
profile* — dense boolean-matrix transitive closure, O(n³ log n) work per
tested slot — which is exactly what dominates their cost for dense graphs:

  1. spanning tree T of G (the shared Borůvka forest, so on the card its
     rounds run ``boruvka_round``),
  2. for every edge slot (the reference vmaps over all E, not only the
     tree edges), remove the edge and run transitive closure by repeated
     matrix squaring,
  3. a tree edge is a bridge iff its endpoints stay disconnected.

The edge axis is cut into chunks of ``[chunk, n, n]`` float32 matrices so
that memory stays bounded; each chunk is one batched ``torch.matmul`` per
squaring. This is intentionally matrix-bound.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.forest import spanning_forest
from repro_torch.graph.datastructs import EdgeList

#: device bytes one chunk's matrices may take (two [chunk, n, n] float32
#: tensors are live at once: the closure, updated in place, and its square)
CHUNK_BYTES = 1 << 28


def closure_squarings(n: int) -> int:
    """Squarings of the closure: ``max(1, ceil(log2 n))``."""
    return max(1, math.ceil(math.log2(n)))


def chunk_slots(n: int) -> int:
    """Edge slots tested per chunk: two [chunk, n, n] float32 tensors
    inside ``CHUNK_BYTES``, at least one slot."""
    return max(1, CHUNK_BYTES // (2 * 4 * n * n))


def _bridges_dense(src, dst, mask, n: int, chunk: int):
    dev = src.device
    valid = mask & (src != dst)
    s = torch.where(valid, src, 0).long()
    d = torch.where(valid, dst, 0).long()
    ids = torch.cat([s[valid], d[valid]])
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise ValueError(f"edge endpoints must lie in [0, {n})")
    # the reference scatters invalid slots to (0, 0) with value 0 under
    # max, which leaves adj as it was: set only the valid slots
    adj = torch.zeros((n, n), dtype=torch.float32, device=dev)
    adj[s[valid], d[valid]] = 1.0
    adj[d[valid], s[valid]] = 1.0

    tree_mask, _ = spanning_forest(EdgeList(src, dst, mask, n))
    is_tree = tree_mask & valid
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    squarings = closure_squarings(n)
    out = torch.zeros_like(valid)
    for lo in range(0, src.shape[0], chunk):
        u, v = s[lo:lo + chunk], d[lo:lo + chunk]
        rows = torch.arange(u.shape[0], device=dev)
        r = adj.expand(u.shape[0], n, n).clone()
        r[rows, u, v] = 0.0
        r[rows, v, u] = 0.0
        r.add_(eye).clamp_(max=1.0)
        for _ in range(squarings):
            r.add_(torch.matmul(r, r)).clamp_(max=1.0)
        out[lo:lo + chunk] = is_tree[lo:lo + chunk] & (r[rows, u, v] < 0.5)
    return out


def bridges_savage_jaja(edges: EdgeList):
    """bool[E] bridge mask (dense-matrix baseline), on the edges' device;
    the endpoints of valid slots must lie in ``[0, n)``.

    Exact: every matrix entry is 0 or 1 and every product's sum is an
    integer at most n < 2^24, so float32 holds it exactly. The products
    run with TF32 allowed (``set_float32_matmul_precision("high")``, the
    caller's setting restored after): 0/1 inputs survive TF32's rounding
    and the sums accumulate in float32, so TF32 is exact here too."""
    n = edges.n_nodes
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        return _bridges_dense(edges.src, edges.dst, edges.mask, n,
                              chunk_slots(n))
    finally:
        torch.set_float32_matmul_precision(saved)
