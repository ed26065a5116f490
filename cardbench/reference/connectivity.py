"""Plain reference for bridges and cut vertices of an undirected multigraph.

1. The edge list is reduced to a simple graph: self-loops dropped, each
   unordered pair once with its multiplicity. A pair with two or more
   copies is never a bridge; copies change no cut vertex.
2. A sparse certificate ``F1 ∪ F2`` (Cheriyan, Kao and Thurimella, k = 2):
   ``F1`` a scan-first-search forest of the simple graph, ``F2`` one of the
   graph minus ``F1``. It has the graph's bridges and cut vertices and at
   most ``2(n - 1)`` edges. Each forest is a breadth-first search from the
   smallest vertex of every component, all components at once; a vertex
   found in a layer hangs from its smallest neighbour in the layer before,
   by that edge's smallest id, which is the forest of scanning each layer
   in vertex order.
3. Tarjan's depth-first search on the certificate, on the host: a tree
   edge ``(p, c)`` is a bridge when ``low[c] > disc[p]``; a non-root ``p``
   is a cut vertex when some child has ``low[c] >= disc[p]``, a root when it
   has two children or more.

Steps 1 and 2 are plain torch on whatever device the arrays are given on
(the card in a run, the CPU in the tests); step 3 is Python.
"""
from __future__ import annotations

import numpy as np
import torch

_NONE = torch.iinfo(torch.int64).max


def simple_graph(src, dst, n: int, device):
    """``(u, v, mult)`` int64 tensors on ``device``: every unordered pair
    ``u < v`` of the edge list once, and how many edges name it."""
    s = torch.as_tensor(np.asarray(src), device=device).long()
    d = torch.as_tensor(np.asarray(dst), device=device).long()
    keep = s != d
    s, d = s[keep], d[keep]
    key = torch.minimum(s, d) * n + torch.maximum(s, d)
    key, mult = torch.unique(key, return_counts=True)
    return key // n, key % n, mult


def _arcs(u, v, live):
    """Both orientations of the live edges: ``(tail, head, edge id)``."""
    ids = torch.nonzero(live).flatten()
    return (torch.cat([u[ids], v[ids]]), torch.cat([v[ids], u[ids]]),
            torch.cat([ids, ids]))


def components(tail, head, n: int) -> torch.Tensor:
    """Smallest vertex id of each vertex's component: min-label
    propagation along the arcs with pointer jumping, to a fixed point."""
    lab = torch.arange(n, device=tail.device)
    while True:
        new = lab.clone()
        new.scatter_reduce_(0, head, lab[tail], "amin")
        new = new[new]
        new = new[new]
        if torch.equal(new, lab):
            return lab
        lab = new


def scan_first_forest(u, v, live, n: int) -> torch.Tensor:
    """bool mask over the edges of a scan-first-search forest of the live
    edges (see the module's docstring, step 2)."""
    tail, head, eid = _arcs(u, v, live)
    lab = components(tail, head, n)
    frontier = lab == torch.arange(n, device=u.device)
    visited = frontier.clone()
    tree = torch.zeros_like(live)
    stride = max(int(u.numel()), 1)
    while True:
        step = frontier[tail] & ~visited[head]
        if not bool(step.any()):
            return tree
        best = torch.full((n,), _NONE, dtype=torch.int64, device=u.device)
        best.scatter_reduce_(0, head[step], tail[step] * stride + eid[step],
                             "amin")
        found = best != _NONE
        tree[best[found] % stride] = True
        visited |= found
        frontier = found


def certificate(u, v, n: int):
    """Indices of the edges of ``F1 ∪ F2``, and the edge count of ``F1``
    (``n`` less the number of components)."""
    live = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    f1 = scan_first_forest(u, v, live, n)
    f2 = scan_first_forest(u, v, live & ~f1, n)
    return torch.nonzero(f1 | f2).flatten(), int(f1.sum())


def tarjan(n: int, eu: np.ndarray, ev: np.ndarray):
    """``(bridge edge indices, cut vertices)`` of the simple graph with
    edges ``(eu[i], ev[i])``, by an iterative depth-first search."""
    m = len(eu)
    heads = np.concatenate([eu, ev])
    order = np.argsort(heads, kind="stable")
    adj_v = np.concatenate([ev, eu])[order].tolist()
    adj_e = np.concatenate([np.arange(m), np.arange(m)])[order].tolist()
    start = np.searchsorted(heads[order], np.arange(n + 1)).tolist()
    ptr = start[:-1]
    disc = [-1] * n
    low = [0] * n
    bridges, cuts = [], set()
    clock = 0
    for root in range(n):
        if disc[root] != -1 or start[root] == start[root + 1]:
            continue
        disc[root] = low[root] = clock
        clock += 1
        stack, via = [root], [-1]
        root_children = 0
        while stack:
            x = stack[-1]
            p = ptr[x]
            if p < start[x + 1]:
                ptr[x] = p + 1
                e = adj_e[p]
                if e == via[-1]:
                    continue
                y = adj_v[p]
                if disc[y] == -1:
                    disc[y] = low[y] = clock
                    clock += 1
                    stack.append(y)
                    via.append(e)
                    if x == root:
                        root_children += 1
                elif disc[y] < low[x]:
                    low[x] = disc[y]
                continue
            stack.pop()
            e = via.pop()
            if not stack:
                continue
            parent = stack[-1]
            if low[x] < low[parent]:
                low[parent] = low[x]
            if low[x] > disc[parent]:
                bridges.append(e)
            if low[x] >= disc[parent] and parent != root:
                cuts.add(parent)
        if root_children >= 2:
            cuts.add(root)
    return bridges, cuts


def analyze(src, dst, n: int, device="cpu") -> dict:
    """Bridges (``(min, max)`` pairs) and cut vertices of the multigraph
    ``(src[i], dst[i])`` over vertices ``range(n)``, and the edge count of
    a spanning forest of it (``n`` less its number of components)."""
    u, v, mult = simple_graph(src, dst, n, device)
    keep, forest_edges = certificate(u, v, n)
    cu, cv, cm = (x[keep].cpu().numpy() for x in (u, v, mult))
    bridge_ids, cuts = tarjan(n, cu, cv)
    bridges = {(int(cu[i]), int(cv[i])) for i in bridge_ids if cm[i] == 1}
    return {"bridges": bridges, "cuts": cuts, "forest_edges": forest_edges}
