"""Faithful final stage: sequential Tarjan low-link DFS on machine C0
(paper Algorithm 1/3). Runs on host in numpy over the gathered certificate.
A copy of ``repro.core.bridges_host``: the port imports nothing of the JAX
package.

Iterative (explicit stack) so 100k-vertex certificates don't hit Python
recursion limits. Parallel edges are handled by skipping only the *edge id*
used to enter a vertex, so a doubled edge is correctly non-bridge.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.datastructs import build_csr


def bridges_dfs(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> set[tuple[int, int]]:
    """Return bridges as a set of (min(u,v), max(u,v)) pairs."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    keep = src != dst  # self loops are never bridges
    src, dst = src[keep], dst[keep]
    indptr, indices, eids = build_csr(src, dst, n_nodes)

    disc = np.full(n_nodes, -1, np.int64)
    low = np.zeros(n_nodes, np.int64)
    ptr = indptr[:-1].copy()  # per-vertex adjacency cursor
    out = set()
    timer = 0
    for root in range(n_nodes):
        if disc[root] != -1:
            continue
        # stack entries: (vertex, entering edge id)
        stack = [(root, -1)]
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            v, in_eid = stack[-1]
            if ptr[v] < indptr[v + 1]:
                w = int(indices[ptr[v]])
                eid = int(eids[ptr[v]])
                ptr[v] += 1
                if eid == in_eid:
                    continue  # don't go back along the entering edge instance
                if disc[w] == -1:
                    disc[w] = low[w] = timer
                    timer += 1
                    stack.append((w, eid))
                else:
                    low[v] = min(low[v], disc[w])
            else:
                stack.pop()
                if stack:
                    p, _ = stack[-1]
                    low[p] = min(low[p], low[v])
                    if low[v] > disc[p]:
                        out.add((min(p, v), max(p, v)))
    return out


def bridges_from_edgelist(edges) -> set[tuple[int, int]]:
    """``bridges_dfs`` of a padded ``EdgeList``'s masked edges."""
    s, d = edges.to_numpy()
    return bridges_dfs(s, d, edges.n_nodes)
